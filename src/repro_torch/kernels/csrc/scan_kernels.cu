// The selective-scan kernels of the port (the forward and its backward)
// and their plain C launchers, loaded with ctypes by
// src/repro_torch/kernels/cuda.py.
//
// Built with the flags of cnn_kernels.cu (-fmad=false).  All operands are
// contiguous f32 (the wrapper casts): x and dt (B, T, Di), Bp and Cp
// (B, T, Ds), A (Di, Ds); outputs y (B, T, Di) and the final state h
// (B, Di, Ds); the backward's below its kernel.
//
// selective_scan_kernel<S>
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
//   At the served site the plan is S = 4, L = 4, ch = 64: 65536 threads
//   in 256 CTAs (16 warps on most SMs), 2.3 KB of shared memory a step.
//   The exponential is expf (not __expf), and with -fmad=false every
//   product and sum is rounded on its own, in the plain version's order,
//   so the kernel is bitwise its plain version.  Logic-only: no MMA.
#include <cuda_runtime.h>

#include <cstdint>

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
// pairs), Bp, Cp (two of tc x L*S) and, with L > 1, the lanes' sums
// (tc x L x ch).
__host__ __device__ __forceinline__ int smem_floats(const Plan& p, int S) {
  const int ls = p.lanes * S;
  return p.tc * (4 * p.ch + 4 * ls + (p.lanes > 1 ? p.lanes * p.ch : 0));
}

template <int S>
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
  // .. short of the last, ns a batch row
  const int ns = states != nullptr ? (T + ck - 1) / ck - 1 : 0;

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
        const int tn = t0 + r + 1;         // steps done
        if (ns > 0 && live && tn % ck == 0 && tn < T) {
          float* sp = states +
                      (((long long)blockIdx.y * ns + tn / ck - 1) * Di + di) *
                          Ds;
#pragma unroll
          for (int k = 0; k < S; ++k) {
            if (state(k) < Ds) sp[state(k)] = h[k];
          }
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
      __syncthreads();                     // chunk j has been consumed
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
// selective_scan_bwd_kernel<SP>
//   replaces no TPU kernel: the reference differentiates its lax.scan
//   (src/repro/models/mamba.py:86) with jax.grad; this is that gradient.
//   With a_t = exp(dt_t A), for every (b, di, s), walking t backwards:
//     g_{T-1} = dy_{T-1} C_{T-1} + dh,  g_t = dy_t C_t + a_{t+1} g_{t+1}
//     dC_t[s] = sum_di h_t dy_t            dB_t[s] = sum_di g_t (dt_t x_t)
//     dx_t = dt_t sum_s g_t B_t
//     ddt_t = x_t sum_s g_t B_t + sum_s (g_t h_{t-1}) a_t A
//     dA = sum_b sum_t (g_t h_{t-1}) a_t dt_t
//   Mapping (kernels/mamba_scan/scan.py::bwd_plan): a thread owns one
//   state of one channel; SP = min(P, 32) lanes a channel (P the next
//   power of two of Ds), lane j of pass q the state j * Q + q (Q = P / SP
//   passes over the sequence, the forward's cut); a CTA of 256 threads
//   holds 256 / SP
//   channels of one batch row (blockIdx.y).  g stays in a register for
//   the whole walk, as the forward keeps h.  h_{t-1} comes from the
//   states the forward saved every kBwdChunk steps: a chunk is first
//   recomputed forwards from its saved state (the forward's operations,
//   so the same values) into kBwdChunk registers, then walked
//   backwards.  No a_t is ever inverted.
//   Sums, all in a fixed order (no atomics, so a step is reproducible):
//   over a pass's states a halving tree by warp shuffles (j + n/2 onto
//   j), the passes' sums in order (the forward's y order); over the CTA's channels a halving
//   tree in shared memory, one partial a CTA into wb / wc, then
//   scan_bwd_reduce_bc's halving tree over the CTAs (zero-padded to a
//   power of two); dA a sum over t in the walk's order, then
//   scan_bwd_reduce_a's sum over b in order.  -fmad=false: every
//   product and sum is rounded on its own, in selective_scan_bwd_plain's
//   order, so the two agree bitwise.
//   Bound: x, dt, dy read and dx, ddt written (5 B T Di floats), the
//   saved states, two exponentials per (t, di, s) (the recompute's and
//   the walk's) at the multi-function units' rate.  Logic-only: no MMA.
// ---------------------------------------------------------------------------
constexpr int kBwdThreads = 256;        // threads a CTA
constexpr int kBwdChunk = 16;           // steps between saved states
constexpr unsigned kFull = 0xffffffffu;

// Shared floats of the backward: the dB and dC terms of a chunk,
// [kBwdChunk][channels][SP] each (channels * SP = kBwdThreads).
__host__ __device__ __forceinline__ int bwd_smem_floats(int ck) {
  return 2 * ck * kBwdThreads;
}

template <int SP>
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
                          int passes) {
  constexpr int CH = kBwdThreads / SP;
  constexpr int K = kBwdChunk;
  extern __shared__ __align__(16) float smem[];
  float* tb = smem;                      // [K][CH][SP] dB terms
  float* tcs = smem + K * kBwdThreads;   // [K][CH][SP] dC terms
  const int tid = threadIdx.x, j = tid % SP, c = tid / SP;
  const int di = blockIdx.x * CH + c, b = blockIdx.y, nb = gridDim.x;
  const bool live = di < Di;
  const long long row0 = (long long)b * T;
  const int nck = (T + K - 1) / K, ns = nck - 1;

  for (int q = 0; q < passes; ++q) {
    const int s = j * passes + q;
    const bool sv = s < Ds, on = live && sv;
    const float av = on ? a[(long long)di * Ds + s] : 0.f;
    float g = on && dh != nullptr
                  ? dh[((long long)b * Di + di) * Ds + s] : 0.f;
    float anext = 1.f, dacc = 0.f;
    for (int k = nck - 1; k >= 0; --k) {
      const int t0 = k * K, rows = min(K, T - t0);
      const float h0 =
          on && k > 0 ? states[(((long long)b * ns + k - 1) * Di + di) * Ds + s]
                      : 0.f;
      float hb[K];
      float h = h0;
#pragma unroll
      for (int r = 0; r < K; ++r) {        // the chunk forwards
        if (r < rows) {
          const long long gi = (row0 + t0 + r) * Di + di;
          const float d = live ? dt[gi] : 0.f, xv = live ? x[gi] : 0.f;
          const float bv = sv ? bp[(row0 + t0 + r) * Ds + s] : 0.f;
          const float d_a = expf(__fmul_rn(d, av));
          h = __fadd_rn(__fmul_rn(d_a, h), __fmul_rn(__fmul_rn(d, xv), bv));
          hb[r] = h;
        }
      }
#pragma unroll
      for (int r = K - 1; r >= 0; --r) {   // and backwards
        if (r < rows) {                    // rows is uniform: all lanes
          const long long gi = (row0 + t0 + r) * Di + di;
          const long long si = (row0 + t0 + r) * Ds + s;
          const float d = live ? dt[gi] : 0.f, xv = live ? x[gi] : 0.f;
          const float dyv = live ? dy[gi] : 0.f;
          const float bv = sv ? bp[si] : 0.f, cv = sv ? cp[si] : 0.f;
          const float hprev = r > 0 ? hb[r > 0 ? r - 1 : 0] : h0;
          const float at = expf(__fmul_rn(d, av));
          g = __fadd_rn(__fmul_rn(dyv, cv), __fmul_rn(anext, g));
          const float qa = __fmul_rn(__fmul_rn(g, hprev), at);
          dacc = __fadd_rn(dacc, __fmul_rn(qa, d));
          anext = at;
          const int e = (r * CH + c) * SP + j;
          tcs[e] = on ? __fmul_rn(hb[r], dyv) : 0.f;
          tb[e] = on ? __fmul_rn(g, __fmul_rn(d, xv)) : 0.f;
          float sgb = __fmul_rn(g, bv), sq = __fmul_rn(qa, av);
#pragma unroll
          for (int o = SP / 2; o > 0; o /= 2) {
            sgb = __fadd_rn(sgb, __shfl_xor_sync(kFull, sgb, o));
            sq = __fadd_rn(sq, __shfl_xor_sync(kFull, sq, o));
          }
          if (j == 0 && live) {
            if (q > 0) {                   // the earlier passes' sums
              sgb = __fadd_rn(dx[gi], sgb);
              sq = __fadd_rn(ddt[gi], sq);
            }
            if (q == passes - 1) {
              dx[gi] = __fmul_rn(d, sgb);
              ddt[gi] = __fadd_rn(__fmul_rn(xv, sgb), sq);
            } else {
              dx[gi] = sgb;
              ddt[gi] = sq;
            }
          }
        }
      }
      __syncthreads();                     // the chunk's terms are in
      for (int n = CH / 2; n > 0; n /= 2) {
        for (int e = tid; e < rows * n * SP; e += kBwdThreads) {
          const int r = e / (n * SP), cc = (e / SP) % n, jj = e % SP;
          const int o = (r * CH + cc) * SP + jj;
          tb[o] = __fadd_rn(tb[o], tb[o + n * SP]);
          tcs[o] = __fadd_rn(tcs[o], tcs[o + n * SP]);
        }
        __syncthreads();
      }
      for (int e = tid; e < rows * SP; e += kBwdThreads) {
        const int r = e / SP, jj = e % SP, ss = jj * passes + q;
        if (ss < Ds) {
          const long long o =
              ((row0 + t0 + r) * nb + blockIdx.x) * Ds + ss;
          wb[o] = tb[r * kBwdThreads + jj];
          wc[o] = tcs[r * kBwdThreads + jj];
        }
      }
      __syncthreads();                     // the buffers are free again
    }
    if (on) wa[((long long)b * Di + di) * Ds + s] = dacc;
  }
}

// dB and dC: each thread sums one (b, t, s) column of nb CTA partials,
// strided by Ds, by a halving tree in place (j + n/2 onto j, the columns
// zero-padded to a power of two: a missing partner is skipped).
__global__ void scan_bwd_reduce_bc(float* __restrict__ wb,
                                   float* __restrict__ wc,
                                   float* __restrict__ dbp,
                                   float* __restrict__ dcp, long long rows,
                                   int nb, int Ds) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long half = rows * Ds;
  if (e >= 2 * half) return;
  const bool is_c = e >= half;
  if (is_c) e -= half;
  const long long row = e / Ds;
  float* col = (is_c ? wc : wb) + row * nb * Ds + e % Ds;
  int np2 = 1;
  while (np2 < nb) np2 *= 2;
  for (int n = np2 / 2; n > 0; n /= 2) {
    for (int k = 0; k < n && k + n < nb; ++k) {
      col[(long long)k * Ds] =
          __fadd_rn(col[(long long)k * Ds], col[(long long)(k + n) * Ds]);
    }
  }
  (is_c ? dcp : dbp)[e] = col[0];
}

// dA: the batch rows' sums in order.
__global__ void scan_bwd_reduce_a(const float* __restrict__ wa,
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

// One launch of selective_scan_kernel<S> on the plan (S, lanes, passes,
// ch, tc) of lane_plan; refuses a plan that is not the tree's (S, lanes
// and passes powers of two whose product is the next power of two of
// Ds, at most kMaxLanes lanes, passes only over 128 states a pass) or
// does not fit a CTA.  With `states` non-null it also writes h after
// every ck-th step short of the last (B, ceil(T / ck) - 1, Di, Ds): what
// scan_selective_bwd restarts from.
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
      (long long)smem_floats(pl, S) * 4 > kSmemBytes ||
      (states != nullptr && ck < 1)) {
    return int(cudaErrorInvalidValue);
  }
  const dim3 grid((Di + ch - 1) / ch, B);
  const size_t bytes = size_t(smem_floats(pl, S)) * 4;
  cudaStream_t st = cudaStream_t(stream);
  auto run = [&](auto kernel) {
    kernel<<<grid, ch * lanes, bytes, st>>>(
        (const float*)x, (const float*)dt, (const float*)bp,
        (const float*)cp, (const float*)a, (float*)y, (float*)h,
        (float*)states, T, Di, Ds, ck, pl);
    return int(cudaGetLastError());
  };
  switch (S) {
    case 1: return run(selective_scan_kernel<1>);
    case 2: return run(selective_scan_kernel<2>);
    case 4: return run(selective_scan_kernel<4>);
    case 8: return run(selective_scan_kernel<8>);
    case 16: return run(selective_scan_kernel<16>);
  }
  return int(cudaErrorInvalidValue);
}

// One backward of the scan: selective_scan_bwd_kernel<SP> on the plan of
// kernels/mamba_scan/scan.py::bwd_plan (SP lanes a channel, `passes`
// passes, 256 / SP channels a CTA, chunks of kBwdChunk steps), then the
// two reductions; `dh` may be null (a zero final-state gradient).
// Workspace: wb and wc (B, T, ceil(Di / ch), Ds), wa (B, Di, Ds).
int scan_selective_bwd(const void* x, const void* dt, const void* bp,
                       const void* cp, const void* a, const void* states,
                       const void* dy, const void* dh, void* dx, void* ddt,
                       void* dbp, void* dcp, void* da, void* wb, void* wc,
                       void* wa, int B, int T, int Di, int Ds, int SP,
                       int passes, int ck, void* stream) {
  using namespace scan;
  long long p2 = 1;
  while (p2 < Ds) p2 *= 2;
  if (B < 1 || T < 1 || Di < 1 || Ds < 1 || ck != kBwdChunk ||
      SP != (p2 < 32 ? p2 : 32) || (long long)SP * passes != p2 ||
      (T > ck && states == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  const int ch = kBwdThreads / SP;
  const int nb = (Di + ch - 1) / ch;
  const dim3 grid(nb, B);
  const size_t bytes = size_t(bwd_smem_floats(ck)) * 4;
  cudaStream_t st = cudaStream_t(stream);
  auto run = [&](auto kernel) {
    kernel<<<grid, kBwdThreads, bytes, st>>>(
        (const float*)x, (const float*)dt, (const float*)bp,
        (const float*)cp, (const float*)a, (const float*)states,
        (const float*)dy, (const float*)dh, (float*)dx, (float*)ddt,
        (float*)wb, (float*)wc, (float*)wa, T, Di, Ds, passes);
    return int(cudaGetLastError());
  };
  int err = int(cudaErrorInvalidValue);
  switch (SP) {
    case 1: err = run(selective_scan_bwd_kernel<1>); break;
    case 2: err = run(selective_scan_bwd_kernel<2>); break;
    case 4: err = run(selective_scan_bwd_kernel<4>); break;
    case 8: err = run(selective_scan_bwd_kernel<8>); break;
    case 16: err = run(selective_scan_bwd_kernel<16>); break;
    case 32: err = run(selective_scan_bwd_kernel<32>); break;
  }
  if (err != 0) return err;
  const long long cols = 2LL * B * T * Ds;
  scan_bwd_reduce_bc<<<(unsigned)((cols + 255) / 256), 256, 0, st>>>(
      (float*)wb, (float*)wc, (float*)dbp, (float*)dcp, (long long)B * T,
      nb, Ds);
  err = int(cudaGetLastError());
  if (err != 0) return err;
  const long long n = (long long)Di * Ds;
  scan_bwd_reduce_a<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)wa, (float*)da, B, n);
  return int(cudaGetLastError());
}

}  // extern "C"
