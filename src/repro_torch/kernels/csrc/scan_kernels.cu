// The selective-scan kernel of the port and its plain C launcher, loaded
// with ctypes by src/repro_torch/kernels/cuda.py.
//
// Built with the flags of cnn_kernels.cu (-fmad=false).  All operands are
// contiguous f32 (the wrapper casts): x and dt (B, T, Di), Bp and Cp
// (B, T, Ds), A (Di, Ds); outputs y (B, T, Di) and the final state h
// (B, Di, Ds).
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
                      float* __restrict__ h_out, int T, int Di, int Ds,
                      Plan pl) {
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

}  // namespace scan

extern "C" {

// One launch of selective_scan_kernel<S> on the plan (S, lanes, passes,
// ch, tc) of lane_plan; refuses a plan that is not the tree's (S, lanes
// and passes powers of two whose product is the next power of two of
// Ds, at most kMaxLanes lanes, passes only over 128 states a pass) or
// does not fit a CTA.
int scan_selective(const void* x, const void* dt, const void* bp,
                   const void* cp, const void* a, void* y, void* h, int B,
                   int T, int Di, int Ds, int S, int lanes, int passes,
                   int ch, int tc, void* stream) {
  using namespace scan;
  const Plan pl{lanes, passes, ch, tc};
  long long p2 = 1;
  while (p2 < Ds) p2 *= 2;
  auto pow2 = [](int v) { return v >= 1 && (v & (v - 1)) == 0; };
  if (B < 1 || T < 0 || Di < 1 || Ds < 1 || !pow2(lanes) ||
      lanes > kMaxLanes || !pow2(passes) || ch < 1 || tc < 1 ||
      (long long)S * lanes * passes != p2 ||
      passes != (p2 > 128 ? p2 / 128 : 1) || ch * lanes > kMaxThreads ||
      (long long)smem_floats(pl, S) * 4 > kSmemBytes) {
    return int(cudaErrorInvalidValue);
  }
  const dim3 grid((Di + ch - 1) / ch, B);
  const size_t bytes = size_t(smem_floats(pl, S)) * 4;
  cudaStream_t st = cudaStream_t(stream);
  auto run = [&](auto kernel) {
    kernel<<<grid, ch * lanes, bytes, st>>>(
        (const float*)x, (const float*)dt, (const float*)bp,
        (const float*)cp, (const float*)a, (float*)y, (float*)h, T, Di, Ds,
        pl);
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

}  // extern "C"
