// The selective-scan kernels of the port (the forward and its backward)
// and their plain C launchers, loaded with ctypes by
// src/repro_torch/kernels/cuda.py.
//
// Built with the flags of cnn_kernels.cu (-fmad=false).  All operands are
// contiguous f32 (the wrapper casts): x and dt (B, T, Di), Bp and Cp
// (B, T, Ds), A (Di, Ds); outputs y (B, T, Di) and the final state h
// (B, Di, Ds); the backward's below its kernel.
//
// selective_scan_kernel<S, SAVE>
//   replaces src/repro/kernels/mamba_scan/scan.py::selective_scan
//   For every (b, di, s), from h = 0 over t = 0 .. T-1:
//     h = exp(dt[b,t,di] * A[di,s]) * h + (dt[b,t,di] * x[b,t,di]) * Bp[b,t,s]
//     y[b,t,di] = sum_s h * Cp[b,t,s]
//   Work per (step, state): one exponential and about 13 FP32
//   instructions (expf about 7 and a MUFU, the update and the y product
//   6); bytes: x, dt and y (B*T*Di each), Bp and Cp (B*T*Ds), A and h,
//   once.  At the served site (B, T, Di, Ds) = (1, 2048, 16384, 16) the
//   exponentials bound it on an H100 SXM: 5.4e8 of them at 16 per clock
//   per SM take 128 us, the 405 MB 121 us; issuing 13 instructions an
//   update takes about 210 us.  The state stays in registers for the
//   whole sequence (as the reference keeps it in VMEM), so only x, dt,
//   Bp, Cp and y move.
//
//   The y sum's order (the plain version's, scan.py::scan_tree_sum):
//   the states padded with zero (A, Bp, Cp = 0) to P, the next power of
//   two of Ds, are taken in Q = max(1, P / 128) passes, pass q holding
//   the states s = j * Q + q; within a pass a halving tree over j (pair
//   j with j + n/2, then halve n), then the passes' sums in order.
//   Mapping (the plan of kernels/mamba_scan/scan.py::lane_plan): a
//   thread owns S states of one channel in registers, L lanes a channel
//   hold a pass's L * S = P / Q states, lane l's k-th the state j = k *
//   L + l, so the tree's first log2(S) levels pair states of one
//   thread and its last log2(L) levels pair lanes.  A CTA owns `ch`
//   channels of one batch row (blockIdx.y); thread t is lane t / ch of
//   channel t % ch, so a warp's 32 threads share a lane: their Bp / Cp
//   reads are one broadcast 16-byte shared load per 4 states (staged in
//   the lanes' order), their x / dt reads neighbouring words.  Each step
//   a thread computes dt * x once, then per state the exponential, the
//   update and the y product, and its tree in registers; with L > 1
//   each lane writes its sum into shared memory and the lanes' tree runs
//   once a chunk into y (coalesced along di); with L = 1 the thread
//   stores y itself.  A later pass adds its sum onto y (the same thread
//   reads what it wrote).  No shuffle.
//   Chunks of tc steps of x and dt (the CTA's channels) and of Bp and Cp
//   (the pass's states) are staged by 4-byte cp.async into one of two
//   buffers while the other chunk computes: one barrier when a chunk has
//   landed, one when it has been consumed.
//   Saving states for the backward (SAVE, `states` non-null:
//   SelectiveScan's forward), tc divides ck, so a saved h is the state
//   after a chunk's last step: each thread puts its S values into shared
//   memory after the chunk's steps, and the CTA then stores the (ch, Ds)
//   block along di and s, coalesced.  Serving (SAVE false, no states)
//   runs without that code.
//   At the served site the plan is S = 4, L = 4, ch = 64: 65536 threads
//   in 256 CTAs (16 warps on most SMs), 2.3 KB of shared memory a step.
//   The exponential is expf (not __expf), and with -fmad=false every
//   product and sum is rounded on its own, in the plain version's order,
//   so the kernel is bitwise its plain version.  Logic-only: no MMA.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tc_device.cuh"

namespace scan {

constexpr int kMaxThreads = 256;        // threads a CTA at most
constexpr int kMaxLanes = 8;            // lanes a channel at most
constexpr int kSmemBytes = 48 * 1024;   // shared memory a CTA at most
constexpr int kScanUnroll = 4;          // steps the compiler interleaves

// 4 bytes global -> shared, zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   tc::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The plan of kernels/mamba_scan/scan.py::lane_plan (S is the kernel's
// template argument): lanes a channel, passes over the sequence (Q),
// channels a CTA, steps a chunk.
struct Plan {
  int lanes, passes, ch, tc;
};

// Shared floats of a plan: dt and x interleaved (two buffers of tc x ch
// pairs), Bp, Cp (two of tc x L*S), with L > 1 the lanes' sums (tc x L x
// ch) and, when the forward saves states, one saved state of the CTA's
// channels (ch rows of L*S + 1: the odd stride spreads a warp's 32
// channels over the banks).
__host__ __device__ __forceinline__ int smem_floats(const Plan& p, int S,
                                                    bool save) {
  const int ls = p.lanes * S;
  return p.tc * (4 * p.ch + 4 * ls + (p.lanes > 1 ? p.lanes * p.ch : 0)) +
         (save ? p.ch * (ls + 1) : 0);
}

template <int S, bool SAVE>
__global__ void __launch_bounds__(kMaxThreads)
selective_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ bp,
                      const float* __restrict__ cp,
                      const float* __restrict__ a, float* __restrict__ y,
                      float* __restrict__ h_out,
                      float* __restrict__ states, int T, int Di, int Ds,
                      int ck, Plan pl) {
  extern __shared__ __align__(16) float smem[];
  const int ch = pl.ch, L = pl.lanes, tc = pl.tc, ls = L * S, Q = pl.passes;
  float2* dxs = reinterpret_cast<float2*>(smem);   // [2][tc][ch] (dt, x)
  float* bs = smem + 4 * tc * ch;                  // [2][tc][ls]
  float* cs = bs + 2 * tc * ls;                    // [2][tc][ls]
  float* ps = cs + 2 * tc * ls;                    // [tc][L][ch]
  float* sv = ps + (L > 1 ? tc * L * ch : 0);      // [ch][ls + 1] saved h
  const int tid = threadIdx.x, nthreads = ch * L;
  // thread tid is lane l of channel c; e = tid + k * nthreads walks a
  // [rows][ch] tile as rows l, l + L, ... of column c, and a [rows][ls]
  // tile (nthreads is a multiple of ls) as rows tid / ls + k * (nthreads
  // / ls) of column tid % ls
  const int c = tid % ch, l = tid / ch;
  const int bm = tid % ls, br0 = tid / ls, bstep = nthreads / ls;
  // the state a staged Bp / Cp column m holds: lane m / S's register m % S
  const int bst = ((bm % S) * L + bm / S) * Q;
  const int di0 = blockIdx.x * ch, di = di0 + c;
  const bool live = di < Di;
  const long long row0 = (long long)blockIdx.y * T;   // b * T
  const int nchunks = (T + tc - 1) / tc;
  // the states saved for the backward: h after steps ck - 1, 2 ck - 1,
  // .. short of the last, ns a batch row; tc divides ck, so each ends a
  // chunk, is kept in sv and stored after the chunk, coalesced
  const int ns = SAVE ? (T + ck - 1) / ck - 1 : 0;

  for (int pass = 0; pass < Q; ++pass) {
    // state of the thread's k-th register (>= Ds: a zero pad)
    auto state = [&](int k) { return (k * L + l) * Q + pass; };
    float av[S], h[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      av[k] = live && state(k) < Ds ? a[(long long)di * Ds + state(k)] : 0.f;
      h[k] = 0.f;
    }
    const bool bok = bst + pass < Ds;
    // chunk j's dt, x and the pass's Bp, Cp into buffer `buf`
    auto stage = [&](int j, int buf) {
      const int t0 = j * tc, rows = min(tc, T - t0);
      float* pair = reinterpret_cast<float*>(dxs + buf * tc * ch + c);
      for (int r = l; r < rows; r += L) {
        const long long g = live ? (row0 + t0 + r) * Di + di : 0;
        cp_async4(pair + 2 * r * ch, dt + g, live);
        cp_async4(pair + 2 * r * ch + 1, x + g, live);
      }
      for (int r = br0; r < rows; r += bstep) {
        const long long g = bok ? (row0 + t0 + r) * Ds + bst + pass : 0;
        cp_async4(bs + (buf * tc + r) * ls + bm, bp + g, bok);
        cp_async4(cs + (buf * tc + r) * ls + bm, cp + g, bok);
      }
      tc::cp_async_commit();
    };
    if (nchunks > 0) stage(0, 0);
    for (int j = 0; j < nchunks; ++j) {
      const int buf = j & 1, t0 = j * tc, rows = min(tc, T - t0);
      if (j + 1 < nchunks) {
        stage(j + 1, buf ^ 1);
        tc::cp_async_wait<1>();
      } else {
        tc::cp_async_wait<0>();
      }
      __syncthreads();                     // chunk j has landed
      // tc divides ck, so a saved state falls on a chunk's last step
      const bool saving =
          SAVE && ns > 0 && (t0 + rows) % ck == 0 && t0 + rows < T;
      const float2* dxr = dxs + buf * tc * ch + c;
      const float* br = bs + buf * tc * ls + l * S;
      const float* cr = cs + buf * tc * ls + l * S;
      float* pr = ps + l * ch + c;
      float* yr = y + (row0 + t0) * Di + di;
#pragma unroll kScanUnroll
      for (int r = 0; r < rows; ++r) {     // rows is uniform: no lane idles
        const float2 dxv = dxr[r * ch];
        const float d = dxv.x;
        const float dx = __fmul_rn(d, dxv.y);
        float bv[S], cv[S];
        if constexpr (S % 4 == 0) {
#pragma unroll
          for (int k = 0; k < S; k += 4) {
            const float4 b4 = *reinterpret_cast<const float4*>(br + r * ls + k);
            const float4 c4 = *reinterpret_cast<const float4*>(cr + r * ls + k);
            bv[k] = b4.x; bv[k + 1] = b4.y; bv[k + 2] = b4.z; bv[k + 3] = b4.w;
            cv[k] = c4.x; cv[k + 1] = c4.y; cv[k + 2] = c4.z; cv[k + 3] = c4.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < S; ++k) {
            bv[k] = br[r * ls + k];
            cv[k] = cr[r * ls + k];
          }
        }
        float p[S];
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const float d_a = expf(__fmul_rn(d, av[k]));
          h[k] = __fadd_rn(__fmul_rn(d_a, h[k]), __fmul_rn(dx, bv[k]));
          p[k] = __fmul_rn(h[k], cv[k]);
        }
#pragma unroll
        for (int n = S / 2; n > 0; n /= 2) {
#pragma unroll
          for (int k = 0; k < n; ++k) p[k] = __fadd_rn(p[k], p[k + n]);
        }
        if (L == 1) {
          if (live) {
            float* yp = yr + (long long)r * Di;
            *yp = pass == 0 ? p[0] : __fadd_rn(*yp, p[0]);
          }
        } else {
          pr[r * L * ch] = p[0];
        }
      }
      if (saving) {
#pragma unroll
        for (int k = 0; k < S; ++k) sv[c * (ls + 1) + k * L + l] = h[k];
      }
      __syncthreads();                     // chunk j has been consumed
      if (saving) {
        // the chunk's saved state: (b, (t0 + rows) / ck - 1, di0 .., pass's
        // states), along di and s in the order of memory; ls is a power
        // of two, and where the CTA's rows are one contiguous block of
        // whole 16-byte vectors (one pass, Ds = ls, a multiple of 4) a
        // thread stores 16 bytes
        float* sp = states +
                    (((long long)blockIdx.y * ns + (t0 + rows) / ck - 1) * Di +
                     di0) * Ds;
        const int lsh = __ffs(ls) - 1, rows_c = min(ch, Di - di0);
        if (Q == 1 && ls == Ds && Ds % 4 == 0) {
          for (int e = 4 * tid; e < rows_c * ls; e += 4 * nthreads) {
            const float* v = sv + (e >> lsh) * (ls + 1) + (e & (ls - 1));
            *reinterpret_cast<float4*>(sp + e) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        } else {
          for (int e = tid; e < rows_c * ls; e += nthreads) {
            const int cc = e >> lsh, jj = e & (ls - 1), s = jj * Q + pass;
            if (s < Ds) sp[(long long)cc * Ds + s] = sv[cc * (ls + 1) + jj];
          }
        }
      }
      if (L > 1 && live) {
        // the lanes' tree: rows l, l + L, ... of channel c
        for (int r = l; r < rows; r += L) {
          const float* pp = ps + r * L * ch + c;
          float v[kMaxLanes];
#pragma unroll
          for (int k = 0; k < kMaxLanes; ++k) v[k] = k < L ? pp[k * ch] : 0.f;
#pragma unroll
          for (int n = kMaxLanes / 2; n > 0; n /= 2) {
            if (n < L) {
#pragma unroll
              for (int k = 0; k < n; ++k) v[k] = __fadd_rn(v[k], v[k + n]);
            }
          }
          float* yp = yr + (long long)r * Di;
          *yp = pass == 0 ? v[0] : __fadd_rn(*yp, v[0]);
        }
      }
    }
    if (live) {
      float* hp = h_out + ((long long)blockIdx.y * Di + di) * Ds;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        if (state(k) < Ds) hp[state(k)] = h[k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// selective_scan_bwd_kernel<S, L>
//   replaces no TPU kernel: the reference differentiates its lax.scan
//   (src/repro/models/mamba.py:86) with jax.grad; this is that gradient.
//   With a_t = exp(dt_t A), for every (b, di, s), walking t backwards:
//     g_{T-1} = dy_{T-1} C_{T-1} + dh,  g_t = dy_t C_t + a_{t+1} g_{t+1}
//     dC_t[s] = sum_di h_t dy_t            dB_t[s] = sum_di g_t (dt_t x_t)
//     dx_t = dt_t sum_s g_t B_t
//     ddt_t = x_t sum_s g_t B_t + sum_s (g_t h_{t-1}) a_t A
//     dA = sum_b sum_t (g_t h_{t-1}) a_t dt_t
//   Bound at (1, 2048, 16384, 16) on an H100 SXM: the bytes (x, dt, dy
//   read, dx, ddt written, the saved states: 807 MB, 241 us); per
//   (t, di, s) one exponential (128 us at the MUFU rate) and about 19
//   FP32 operations (152 us).  With the staging, the trees and the
//   exponential's own instructions the kernel issues about 34
//   instructions per (t, di, s), so issue, not bytes, bounds it: 0.6 ms
//   at the full issue rate.  A chunk's h and a_t take most of 255
//   registers a thread, so an SM holds 8 warps, which issue at about
//   half that rate (1.2 ms on an H100 at 700 W: PERF.md row 16); shared
//   memory carries about 0.2 wavefronts per (t, di, s) beside it.
//   ptxas (-v, sm_90a) spills little: stores and loads of 8 bytes each
//   for <4, 4> (the served site), <4, 2>; 20 for <4, 8>, 4 for <4, 1>,
//   none for <2, 1>, <1, 1>.  The chunk's h and a_t stay in registers.
//   Design:
//   - Mapping (kernels/mamba_scan/scan.py::bwd_plan): a thread owns S
//     (at most kBwdMaxStates) states of one channel, L lanes a channel,
//     lane l's k-th the pass state j = k L + l (state s = j Q + q, Q
//     passes over the sequence past 32 states: the forward's cut); a CTA
//     of kBwdThreads threads holds CH = kBwdThreads / L channels of one
//     batch row (blockIdx.y), thread c L + l.
//   - h_{t-1} comes from the states the forward saved every kBwdChunk
//     steps: each chunk is recomputed forwards from its saved state (the
//     forward's operations, so the same bits) into registers, h and a_t
//     both kept (K S floats each), then walked backwards with those a_t:
//     one exponential per (t, di, s), no a_t inverted.  g stays in a
//     register for the whole walk, as the forward keeps h.
//   - Staging: a chunk's dt, x, dy (the CTA's channels), Bp, Cp (the
//     pass's states, in the lanes' order) and its saved state go into
//     shared memory by cp.async (16 bytes a copy where the operands are
//     aligned, else 4), the next chunk's while this one computes (two
//     buffers); the recompute and the walk read shared memory only, and
//     each global byte is read once a pass.  A chunk of all K steps runs
//     without the steps' guards (one block to schedule).
//   - Sums over a pass's states (dx, ddt): a halving tree over a
//     thread's S registers; each lane stores its sum, and after the
//     chunk the lanes' halving tree (l + L/2 onto l) runs with dx and
//     ddt's stores (scan_tree_sum's order, j + n/2 onto j; no shuffle);
//     the passes' sums in order through dx and ddt.
//   - Sums over channels (dB, dC): the walk stores each term into shared
//     memory ([K] rows of CH x PQ, a warp's stores contiguous); after the
//     chunk, one barrier, then a thread takes S (t, s) columns and runs
//     the halving tree over the CTA's CH channels in registers (htree,
//     16-byte loads) and stores
//     the CTA's partial (B, nb, T, Ds); scan_bwd_reduce_bc_kernel sums the nb
//     partials by a halving tree, reading each once, coalesced.  dA: a
//     sum over t as walked, then scan_bwd_reduce_a_kernel's sum over b in
//     order.  Two barriers a chunk.
//   At the served site the plan is S = 4, L = 4, CH = 32: 512 CTAs of
//   128 threads, two an SM (102 KB of shared memory each).  No atomics,
//   so a step is reproducible; -fmad=false and __f*_rn: every product
//   and sum is rounded on its own, in selective_scan_bwd_plain's order,
//   so the two agree bitwise.  Logic-only: no MMA.
// ---------------------------------------------------------------------------
constexpr int kBwdThreads = 128;        // threads a CTA
constexpr int kBwdChunk = 16;           // steps between saved states
constexpr int kBwdMaxStates = 4;        // states a thread
constexpr int kBwdMaxLanes = 8;         // lanes a channel
constexpr int kReduceRows = 256;        // rows a reduction CTA trees in shared
constexpr int kReduceSpan = 64;         // partials a row sums in registers

// The backward's shared memory in floats, for ch channels and pq states
// a pass: two staged chunks (dt, x, dy [K][ch]; Bp, Cp [K][pq] in the
// lanes' order; the chunk's saved state [ch][pq]), the dB and dC terms
// ([K] rows of ch x pq, padded so that a warp's column reads fall in
// distinct banks) and each lane's sums over its states ([K][threads]
// twice).
__host__ __device__ __forceinline__ int bwd_stage_floats(int ch, int pq) {
  return 3 * kBwdChunk * ch + 2 * kBwdChunk * pq + ch * pq;
}
__host__ __device__ __forceinline__ int bwd_term_row(int ch, int pq) {
  return ch * pq + pq % 32;
}
__host__ __device__ __forceinline__ int bwd_smem_floats(int ch, int pq) {
  return 2 * bwd_stage_floats(ch, pq) + 2 * kBwdChunk * bwd_term_row(ch, pq) +
         2 * kBwdChunk * kBwdThreads;
}

// N consecutive shared floats into registers and back, 16 bytes at a
// time where N allows
template <int N>
__device__ __forceinline__ void lds(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = p[k];
  }
}

template <int N>
__device__ __forceinline__ void sts(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = v[k];
  }
}

// The halving tree (j + N/2 onto j) over the N vectors of S floats at
// p, p + stride, .., p + (N - 1) stride, elementwise: its last sum adds
// the trees over the even and the odd vectors, so it recurses on those
// (no array indexed at run time, nothing in local memory).
template <int N, int S>
__device__ __forceinline__ void htree(float (&out)[S], const float* p,
                                      int stride) {
  if constexpr (N == 1) {
    lds(out, p);
  } else {
    float ev[S], od[S];
    htree<N / 2>(ev, p, 2 * stride);
    htree<N / 2>(od, p + stride, 2 * stride);
#pragma unroll
    for (int k = 0; k < S; ++k) out[k] = __fadd_rn(ev[k], od[k]);
  }
}

template <int S, int L>
__global__ void __launch_bounds__(kBwdThreads)
selective_scan_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ bp,
                          const float* __restrict__ cp,
                          const float* __restrict__ a,
                          const float* __restrict__ states,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh,
                          float* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ wb, float* __restrict__ wc,
                          float* __restrict__ wa, int T, int Di, int Ds,
                          int passes, int vec) {
  constexpr int CH = kBwdThreads / L, PQ = S * L, K = kBwdChunk;
  constexpr int STAGE = 3 * K * CH + 2 * K * PQ + CH * PQ;
  constexpr int ROW = CH * PQ + PQ % 32;
  extern __shared__ __align__(16) float smem[];
  float* tb = smem + 2 * STAGE;          // [K][ROW] dB terms
  float* tcs = tb + K * ROW;             // [K][ROW] dC terms
  float* osg = tcs + K * ROW;            // [K][CH][L] lanes' sum_s g Bp
  float* osq = osg + K * kBwdThreads;    // and of (g h_{t-1}) a_t A
  const int tid = threadIdx.x, c = tid / L, l = tid % L;
  const int di0 = blockIdx.x * CH, di = di0 + c, b = blockIdx.y;
  const bool live = di < Di;
  const long long row0 = (long long)b * T;
  const long long part0 = ((long long)b * gridDim.x + blockIdx.x) * T;
  const int nck = (T + K - 1) / K, ns = nck - 1;
  // where a pass's state j is staged: lane j % L's register j / L
  auto slot = [](int j) { return (j % L) * S + j / L; };
  // vec: x, dt, dy 16-byte aligned and Di a multiple of 4; the saved
  // states then come in 16-byte copies too where a pass is all of Ds
  const bool vec_h = vec && passes == 1 && PQ == Ds && PQ % 4 == 0;

  for (int q = 0; q < passes; ++q) {
    float av[S], g[S], anext[S], dacc[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int s = (k * L + l) * passes + q;
      const bool on = live && s < Ds;
      av[k] = on ? a[(long long)di * Ds + s] : 0.f;
      g[k] = on && dh != nullptr ? dh[((long long)b * Di + di) * Ds + s]
                                 : 0.f;
      anext[k] = 1.f;
      dacc[k] = 0.f;
    }
    // chunk k's operands into buffer `buf`; h before the chunk is the
    // state saved after step k K - 1, zero before the first
    auto stage = [&](int k, int buf) {
      float* sd = smem + buf * STAGE;
      float* sx = sd + K * CH;
      float* sy = sx + K * CH;
      float* sb = sy + K * CH;
      float* sc = sb + K * PQ;
      float* sh = sc + K * PQ;
      const int t0 = k * K, rows = min(K, T - t0);
      if (vec) {                           // 16 bytes a copy
        for (int e = tid; e < rows * CH / 4; e += kBwdThreads) {
          const int r = e / (CH / 4), cc = 4 * (e % (CH / 4));
          const bool ok = di0 + cc < Di;
          const long long gi = ok ? (row0 + t0 + r) * Di + di0 + cc : 0;
          tc::cp_async16(tc::smem_u32(sd + 4 * e), dt + gi, ok);
          tc::cp_async16(tc::smem_u32(sx + 4 * e), x + gi, ok);
          tc::cp_async16(tc::smem_u32(sy + 4 * e), dy + gi, ok);
        }
      } else {
        for (int e = tid; e < rows * CH; e += kBwdThreads) {
          const int r = e / CH, cc = e % CH;
          const bool ok = di0 + cc < Di;
          const long long gi = ok ? (row0 + t0 + r) * Di + di0 + cc : 0;
          cp_async4(sd + e, dt + gi, ok);
          cp_async4(sx + e, x + gi, ok);
          cp_async4(sy + e, dy + gi, ok);
        }
      }
      for (int e = tid; e < rows * PQ; e += kBwdThreads) {
        const int r = e / PQ, j = e % PQ, s = j * passes + q;
        const bool ok = s < Ds;
        const long long gi = ok ? (row0 + t0 + r) * Ds + s : 0;
        cp_async4(sb + r * PQ + slot(j), bp + gi, ok);
        cp_async4(sc + r * PQ + slot(j), cp + gi, ok);
      }
      // the saved state in the order of memory, [CH][PQ]
      const long long hbase =
          k > 0 ? (((long long)b * ns + k - 1) * Di + di0) * Ds : 0;
      if (k == 0) {
        for (int e = tid; e < CH * PQ; e += kBwdThreads) sh[e] = 0.f;
      } else if (vec_h) {                  // one pass, Ds = PQ: contiguous
        for (int e = tid; e < CH * PQ / 4; e += kBwdThreads) {
          const bool ok = di0 + 4 * e / PQ < Di;
          tc::cp_async16(tc::smem_u32(sh + 4 * e),
                         states + (ok ? hbase + 4 * e : 0), ok);
        }
      } else {
        for (int e = tid; e < CH * PQ; e += kBwdThreads) {
          const int cc = e / PQ, s = (e % PQ) * passes + q;
          const bool ok = di0 + cc < Di && s < Ds;
          cp_async4(sh + e, states + (ok ? hbase + (long long)cc * Ds + s : 0),
                    ok);
        }
      }
      tc::cp_async_commit();
    };
    stage(nck - 1, (nck - 1) & 1);
    for (int k = nck - 1; k >= 0; --k) {
      const int buf = k & 1, t0 = k * K, rows = min(K, T - t0);
      tc::cp_async_wait<0>();
      __syncthreads();     // chunk k has landed, chunk k + 1's buffers are free
      if (k > 0) stage(k - 1, buf ^ 1);
      const float* sd = smem + buf * STAGE;
      const float* sx = sd + K * CH;
      const float* sy = sx + K * CH;
      const float* sb = sy + K * CH;
      const float* sc = sb + K * PQ;
      const float* sh = sc + K * PQ;
      // the chunk's recompute and walk; FULL (rows == K: every chunk but
      // a ragged last one) drops the steps' guards, so that each loop is
      // one block the compiler schedules across steps
      auto chunk = [&](auto full) {
        constexpr bool FULL = decltype(full)::value;
        float h0[S], hb[K][S], ab[K][S];
#pragma unroll
        for (int kk = 0; kk < S; ++kk) h0[kk] = sh[c * PQ + kk * L + l];
#pragma unroll
        for (int r = 0; r < K; ++r) {      // the chunk forwards
          if (FULL || r < rows) {          // rows is uniform: all lanes
            const float d = sd[r * CH + c];
            const float dxv = __fmul_rn(d, sx[r * CH + c]);
            float bv[S];
            lds(bv, sb + r * PQ + l * S);
#pragma unroll
            for (int kk = 0; kk < S; ++kk) {
              const float hp = r > 0 ? hb[r > 0 ? r - 1 : 0][kk] : h0[kk];
              const float at = expf(__fmul_rn(d, av[kk]));
              hb[r][kk] =
                  __fadd_rn(__fmul_rn(at, hp), __fmul_rn(dxv, bv[kk]));
              ab[r][kk] = at;
            }
          }
        }
        // step r's operands, loaded a step ahead of use: the loads of
        // step r - 1 are issued before step r's shared stores, which the
        // compiler would not move them across
        float nd, nx, ny, nbv[S], ncv[S];
        auto fetch = [&](int r) {
          nd = sd[r * CH + c];
          nx = sx[r * CH + c];
          ny = sy[r * CH + c];
          lds(nbv, sb + r * PQ + l * S);
          lds(ncv, sc + r * PQ + l * S);
        };
        fetch(FULL ? K - 1 : rows - 1);
#pragma unroll
        for (int r = K - 1; r >= 0; --r) { // and backwards
          if (FULL || r < rows) {
            const float d = nd, xv = nx, dyv = ny, dxv = __fmul_rn(d, xv);
            float bv[S], cv[S], sgb[S], sq[S], tbv[S], tcv[S];
#pragma unroll
            for (int kk = 0; kk < S; ++kk) {
              bv[kk] = nbv[kk];
              cv[kk] = ncv[kk];
            }
            if (r > 0) fetch(r > 0 ? r - 1 : 0);
#pragma unroll
            for (int kk = 0; kk < S; ++kk) {
              const float hp = r > 0 ? hb[r > 0 ? r - 1 : 0][kk] : h0[kk];
              const float at = ab[r][kk];
              g[kk] = __fadd_rn(__fmul_rn(dyv, cv[kk]),
                                __fmul_rn(anext[kk], g[kk]));
              const float qa = __fmul_rn(__fmul_rn(g[kk], hp), at);
              dacc[kk] = __fadd_rn(dacc[kk], __fmul_rn(qa, d));
              anext[kk] = at;
              tcv[kk] = __fmul_rn(hb[r][kk], dyv);
              tbv[kk] = __fmul_rn(g[kk], dxv);
              sgb[kk] = __fmul_rn(g[kk], bv[kk]);
              sq[kk] = __fmul_rn(qa, av[kk]);
            }
            sts(tb + r * ROW + tid * S, tbv);
            sts(tcs + r * ROW + tid * S, tcv);
#pragma unroll
            for (int n = S / 2; n > 0; n /= 2) {
#pragma unroll
              for (int kk = 0; kk < n; ++kk) {
                sgb[kk] = __fadd_rn(sgb[kk], sgb[kk + n]);
                sq[kk] = __fadd_rn(sq[kk], sq[kk + n]);
              }
            }
            // each lane's sum; the lanes' tree runs after the chunk
            osg[r * kBwdThreads + tid] = sgb[0];
            osq[r * kBwdThreads + tid] = sq[0];
          }
        }
      };
      if (rows == K) {
        chunk(std::true_type{});
      } else {
        chunk(std::false_type{});
      }
      __syncthreads();                     // the chunk's terms and sums are in
      // the CTA's dB and dC partials: a thread takes S columns (t, the
      // states of lane ll) and trees the CTA's channels, 16 bytes a load
      for (int e = tid; e < 2 * rows * L; e += kBwdThreads) {
        const bool is_c = e >= rows * L;
        const int f = is_c ? e - rows * L : e, r = f / L, ll = f % L;
        float v[S];
        htree<CH>(v, (is_c ? tcs : tb) + r * ROW + ll * S, PQ);
        float* w = (is_c ? wc : wb) + (part0 + t0 + r) * Ds;
#pragma unroll
        for (int kk = 0; kk < S; ++kk) {
          const int s = (kk * L + ll) * passes + q;
          if (s < Ds) w[s] = v[kk];
        }
      }
      // dx and ddt, along di; a later pass adds onto the earlier ones'
      for (int e = tid; e < rows * CH; e += kBwdThreads) {
        const int cc = e % CH;
        if (di0 + cc < Di) {
          const long long gi = (row0 + t0 + e / CH) * Di + di0 + cc;
          // the lanes' halving tree (l + L/2 onto l)
          float sg, sqv;
          {
            float vg[L], vq[L];
            lds(vg, osg + e * L);
            lds(vq, osq + e * L);
#pragma unroll
            for (int n = L / 2; n > 0; n /= 2) {
#pragma unroll
              for (int ll = 0; ll < n; ++ll) {
                vg[ll] = __fadd_rn(vg[ll], vg[ll + n]);
                vq[ll] = __fadd_rn(vq[ll], vq[ll + n]);
              }
            }
            sg = vg[0];
            sqv = vq[0];
          }
          if (q > 0) {
            sg = __fadd_rn(dx[gi], sg);
            sqv = __fadd_rn(ddt[gi], sqv);
          }
          if (q == passes - 1) {
            dx[gi] = __fmul_rn(sd[e], sg);
            ddt[gi] = __fadd_rn(__fmul_rn(sx[e], sg), sqv);
          } else {
            dx[gi] = sg;
            ddt[gi] = sqv;
          }
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < S; ++kk) {
      const int s = (kk * L + l) * passes + q;
      if (live && s < Ds) wa[((long long)b * Di + di) * Ds + s] = dacc[kk];
    }
    __syncthreads();                       // the buffers are free again
  }
}

// The halving tree over w[j stride], w[(j + step) stride], .., N of
// them (zero past nb), recursing on the even and the odd ones as htree.
template <int N>
__device__ __forceinline__ float strided_tree(const float* w, int j,
                                              int step, int nb,
                                              long long stride, bool ok) {
  if constexpr (N == 1) {
    return ok && j < nb ? w[(long long)j * stride] : 0.f;
  } else {
    return __fadd_rn(strided_tree<N / 2>(w, j, 2 * step, nb, stride, ok),
                     strided_tree<N / 2>(w, j + step, 2 * step, nb, stride,
                                         ok));
  }
}

// Rows j = grp, grp + 8, .. < rows of a reduction CTA's tile, each the
// strided_tree of its span partials; unrolled, so that a thread keeps
// several rows' loads in flight.
template <int SPAN>
__device__ __forceinline__ void tree_rows(float (*sm)[32], const float* w,
                                          int grp, int col, int rows, int nb,
                                          long long cols, bool ok) {
#pragma unroll 4
  for (int j = grp; j < rows; j += 8) {
    sm[j][col] = strided_tree<SPAN>(w, j, rows, nb, cols, ok);
  }
}

// dB and dC (blockIdx.z): the nb CTA partials (B, nb, T, Ds) of each
// (b, t, s) column summed by a halving tree (j + n/2 onto j, zero-padded
// to np2, a power of two).  A CTA takes 32 columns: its 8 warps first
// sum the span = np2 / rows partials j, j + rows, .. of each row j <
// rows = min(np2, kReduceRows) in registers (the tree's first levels,
// each partial read once, 128 bytes a warp), then the last log2(rows)
// levels run in shared memory.
__global__ void __launch_bounds__(256)
scan_bwd_reduce_bc_kernel(const float* __restrict__ wb,
                          const float* __restrict__ wc,
                          float* __restrict__ dbp, float* __restrict__ dcp,
                          int nb, int np2, long long cols) {
  __shared__ float sm[kReduceRows][32];
  const int col = threadIdx.x % 32, grp = threadIdx.x / 32;
  const long long e = (long long)blockIdx.x * 32 + col;
  const bool ok = e < cols;
  const float* w =
      (blockIdx.z ? wc : wb) + (long long)blockIdx.y * nb * cols + (ok ? e : 0);
  const int rows = min(np2, kReduceRows);
  switch (np2 / rows) {
    case 1: tree_rows<1>(sm, w, grp, col, rows, nb, cols, ok); break;
    case 2: tree_rows<2>(sm, w, grp, col, rows, nb, cols, ok); break;
    case 4: tree_rows<4>(sm, w, grp, col, rows, nb, cols, ok); break;
    case 8: tree_rows<8>(sm, w, grp, col, rows, nb, cols, ok); break;
    case 16: tree_rows<16>(sm, w, grp, col, rows, nb, cols, ok); break;
    case 32: tree_rows<32>(sm, w, grp, col, rows, nb, cols, ok); break;
    case 64: tree_rows<64>(sm, w, grp, col, rows, nb, cols, ok); break;
  }
  __syncthreads();
  for (int n = rows / 2; n > 0; n /= 2) {
    for (int i = threadIdx.x; i < n * 32; i += 256) {
      sm[i / 32][i % 32] =
          __fadd_rn(sm[i / 32][i % 32], sm[i / 32 + n][i % 32]);
    }
    __syncthreads();
  }
  if (threadIdx.x < 32 && ok) {
    (blockIdx.z ? dcp : dbp)[(long long)blockIdx.y * cols + e] = sm[0][col];
  }
}

// dA: the batch rows' sums in order.
__global__ void scan_bwd_reduce_a_kernel(const float* __restrict__ wa,
                                         float* __restrict__ da, int B,
                                         long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float v = wa[e];
  for (int b = 1; b < B; ++b) v = __fadd_rn(v, wa[b * n + e]);
  da[e] = v;
}

}  // namespace scan

extern "C" {

// One launch of selective_scan_kernel<S, SAVE> on the plan (S, lanes, passes,
// ch, tc) of lane_plan; refuses a plan that is not the tree's (S, lanes
// and passes powers of two whose product is the next power of two of
// Ds, at most kMaxLanes lanes, passes only over 128 states a pass) or
// does not fit a CTA.  With `states` non-null it also writes h after
// every ck-th step short of the last (B, ceil(T / ck) - 1, Di, Ds): what
// scan_selective_bwd restarts from; tc must then divide ck
// (lane_plan(save=True)), so each saved state ends a chunk and is stored
// after it, along di and s.
int scan_selective(const void* x, const void* dt, const void* bp,
                   const void* cp, const void* a, void* y, void* h,
                   void* states, int B, int T, int Di, int Ds, int ck,
                   int S, int lanes, int passes, int ch, int tc,
                   void* stream) {
  using namespace scan;
  const Plan pl{lanes, passes, ch, tc};
  long long p2 = 1;
  while (p2 < Ds) p2 *= 2;
  auto pow2 = [](int v) { return v >= 1 && (v & (v - 1)) == 0; };
  if (B < 1 || T < 0 || Di < 1 || Ds < 1 || !pow2(lanes) ||
      lanes > kMaxLanes || !pow2(passes) || ch < 1 || tc < 1 ||
      (long long)S * lanes * passes != p2 ||
      passes != (p2 > 128 ? p2 / 128 : 1) || ch * lanes > kMaxThreads ||
      (long long)smem_floats(pl, S, states != nullptr) * 4 > kSmemBytes ||
      (states != nullptr && (ck < 1 || ck % tc != 0))) {
    return int(cudaErrorInvalidValue);
  }
  const dim3 grid((Di + ch - 1) / ch, B);
  const size_t bytes = size_t(smem_floats(pl, S, states != nullptr)) * 4;
  cudaStream_t st = cudaStream_t(stream);
  auto run = [&](auto kernel) {
    kernel<<<grid, ch * lanes, bytes, st>>>(
        (const float*)x, (const float*)dt, (const float*)bp,
        (const float*)cp, (const float*)a, (float*)y, (float*)h,
        (float*)states, T, Di, Ds, ck, pl);
    return int(cudaGetLastError());
  };
  const bool save = states != nullptr;
  switch (S) {
    case 1: return save ? run(selective_scan_kernel<1, true>)
                        : run(selective_scan_kernel<1, false>);
    case 2: return save ? run(selective_scan_kernel<2, true>)
                        : run(selective_scan_kernel<2, false>);
    case 4: return save ? run(selective_scan_kernel<4, true>)
                        : run(selective_scan_kernel<4, false>);
    case 8: return save ? run(selective_scan_kernel<8, true>)
                        : run(selective_scan_kernel<8, false>);
    case 16: return save ? run(selective_scan_kernel<16, true>)
                         : run(selective_scan_kernel<16, false>);
  }
  return int(cudaErrorInvalidValue);
}

// One backward of the scan: selective_scan_bwd_kernel<S, L> on the plan
// of kernels/mamba_scan/scan.py::bwd_plan (S states a thread, `lanes`
// lanes a channel, `passes` passes, ch = kBwdThreads / lanes channels a
// CTA, chunks of kBwdChunk steps), then the two reductions; `dh` may be
// null (a zero final-state gradient).  Refuses any other plan, and a
// Di whose CTA count exceeds what scan_bwd_reduce_bc_kernel trees.
// Workspace: wb and wc (B, ceil(Di / ch), T, Ds), wa (B, Di, Ds).
int scan_selective_bwd(const void* x, const void* dt, const void* bp,
                       const void* cp, const void* a, const void* states,
                       const void* dy, const void* dh, void* dx, void* ddt,
                       void* dbp, void* dcp, void* da, void* wb, void* wc,
                       void* wa, int B, int T, int Di, int Ds, int S,
                       int lanes, int passes, int ch, int ck, void* stream) {
  using namespace scan;
  long long p2 = 1;
  while (p2 < Ds) p2 *= 2;
  const long long want_s = p2 < kBwdMaxStates ? p2 : kBwdMaxStates;
  const long long want_l =
      p2 / want_s < kBwdMaxLanes ? p2 / want_s : kBwdMaxLanes;
  const int nb = ch > 0 && Di > 0 ? (Di + ch - 1) / ch : 0;
  long long np2 = 1;
  while (np2 < nb) np2 *= 2;
  if (B < 1 || T < 1 || Di < 1 || Ds < 1 || ck != kBwdChunk || S != want_s ||
      lanes != want_l || (long long)S * lanes * passes != p2 ||
      ch * lanes != kBwdThreads || B > 65535 ||
      np2 > (long long)kReduceRows * kReduceSpan ||
      (T > ck && states == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  const dim3 grid(nb, B);
  const int bytes = bwd_smem_floats(ch, S * lanes) * 4;
  auto a16 = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int vec = a16(x) && a16(dt) && a16(dy) && a16(states) && Di % 4 == 0;
  cudaStream_t st = cudaStream_t(stream);
  auto run = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return int(e);
    kernel<<<grid, kBwdThreads, bytes, st>>>(
        (const float*)x, (const float*)dt, (const float*)bp,
        (const float*)cp, (const float*)a, (const float*)states,
        (const float*)dy, (const float*)dh, (float*)dx, (float*)ddt,
        (float*)wb, (float*)wc, (float*)wa, T, Di, Ds, passes, vec);
    return int(cudaGetLastError());
  };
  int err = int(cudaErrorInvalidValue);
  switch (S * 16 + lanes) {
    case 1 * 16 + 1: err = run(selective_scan_bwd_kernel<1, 1>); break;
    case 2 * 16 + 1: err = run(selective_scan_bwd_kernel<2, 1>); break;
    case 4 * 16 + 1: err = run(selective_scan_bwd_kernel<4, 1>); break;
    case 4 * 16 + 2: err = run(selective_scan_bwd_kernel<4, 2>); break;
    case 4 * 16 + 4: err = run(selective_scan_bwd_kernel<4, 4>); break;
    case 4 * 16 + 8: err = run(selective_scan_bwd_kernel<4, 8>); break;
  }
  if (err != 0) return err;
  const long long cols = (long long)T * Ds;
  const dim3 tiles((unsigned)((cols + 31) / 32), B, 2);
  scan_bwd_reduce_bc_kernel<<<tiles, 256, 0, st>>>(
      (const float*)wb, (const float*)wc, (float*)dbp, (float*)dcp, nb,
      (int)np2, cols);
  err = int(cudaGetLastError());
  if (err != 0) return err;
  const long long n = (long long)Di * Ds;
  scan_bwd_reduce_a_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)wa, (float*)da, B, n);
  return int(cudaGetLastError());
}

}  // extern "C"
