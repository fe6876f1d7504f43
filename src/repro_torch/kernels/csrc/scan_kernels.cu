// The selective-scan kernel of the port and its plain C launcher, loaded
// with ctypes by src/repro_torch/kernels/cuda.py.
//
// Built with the flags of cnn_kernels.cu (-fmad=false).  All operands are
// contiguous f32 (the wrapper casts): x and dt (B, T, Di), Bp and Cp
// (B, T, Ds), A (Di, Ds); outputs y (B, T, Di) and the final state h
// (B, Di, Ds).
//
// selective_scan_kernel<DS>
//   replaces src/repro/kernels/mamba_scan/scan.py::selective_scan
//   For every (b, di, s), from h = 0 over t = 0 .. T-1:
//     h = exp(dt[b,t,di] * A[di,s]) * h + (dt[b,t,di] * x[b,t,di]) * Bp[b,t,s]
//     y[b,t,di] = sum_s h * Cp[b,t,s]
//   Work per (step, state): one exponential and about 6 FP32 operations;
//   bytes: x, dt and y (B*T*Di each), Bp and Cp (B*T*Ds), A and h, once.
//   At the served site (B, T, Di, Ds) = (1, 2048, 16384, 16) the
//   exponentials bound it on an H100 SXM: 5.4e8 of them at 16 per clock
//   per SM take 128 us, the 405 MB 121 us, the 3.2e9 FP32 operations 48
//   us.  The design keeps the state in registers for the whole sequence
//   (as the reference keeps it in VMEM), so only x, dt, Bp, Cp and y move.
//
//   Mapping: a CTA of kThreads = 256 threads owns kCh = 256 / DS channels
//   di of one batch row b (blockIdx.y); a group of DS neighbouring lanes
//   owns one channel, lane s the state h[b, di, s] in a register.  y_t is
//   a butterfly shuffle sum over the group (a group tiles a warp, so every
//   lane of the warp takes part), written by lane s = 0.  Chunks of kTc =
//   32 steps of x and dt for the CTA's channels, and of Bp and Cp (read by
//   every channel of the batch row), are staged in shared memory; y is
//   staged likewise and written back a chunk at a time.  Rows of kCh
//   channels are contiguous in x, dt and y, so those loads and stores are
//   coalesced across di.
//   At the served site: (B*Di*Ds) / 256 = 1024 CTAs; 8 CTAs (2048
//   threads, 64 warps) fit on an SM by threads, so the grid is one wave
//   on 132 SMs (1056 slots) at full occupancy; shared memory 10 KB a CTA
//   (25 KB for DS = 4).
//   The exponential is expf (not __expf), and with -fmad=false every
//   product and sum is rounded on its own, in the plain version's order;
//   only the y sum over s runs in another order.
#include <cuda_runtime.h>

namespace scan {

constexpr int kThreads = 256;   // threads per CTA
constexpr int kTc = 32;         // steps per staged chunk

template <int DS>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ bp,
                      const float* __restrict__ cp,
                      const float* __restrict__ a, float* __restrict__ y,
                      float* __restrict__ h_out, int T, int Di) {
  constexpr int kCh = kThreads / DS;
  __shared__ float xs[kTc][kCh];
  __shared__ float dts[kTc][kCh];
  __shared__ float ys[kTc][kCh];
  __shared__ float bs[kTc][DS];
  __shared__ float cs[kTc][DS];

  const int tid = threadIdx.x;
  const int ch = tid / DS, s = tid % DS;
  const int di0 = blockIdx.x * kCh;
  const int di = di0 + ch;
  const bool live = di < Di;
  const long long row0 = (long long)blockIdx.y * T;   // b * T
  const float a_v = live ? a[(long long)di * DS + s] : 0.f;
  float h = 0.f;

  for (int t0 = 0; t0 < T; t0 += kTc) {
    const int tc = min(kTc, T - t0);
    for (int i = tid; i < tc * kCh; i += kThreads) {
      const int r = i / kCh, c = i % kCh;
      const bool ok = di0 + c < Di;
      const long long g = (row0 + t0 + r) * Di + di0 + c;
      xs[r][c] = ok ? x[g] : 0.f;
      dts[r][c] = ok ? dt[g] : 0.f;
    }
    for (int i = tid; i < tc * DS; i += kThreads) {
      const int r = i / DS, c = i % DS;
      const long long g = (row0 + t0 + r) * DS + c;
      bs[r][c] = bp[g];
      cs[r][c] = cp[g];
    }
    __syncthreads();
    for (int r = 0; r < tc; ++r) {           // tc is uniform: no lane idles
      const float d = dts[r][ch];
      const float d_a = expf(__fmul_rn(d, a_v));
      const float d_bx = __fmul_rn(__fmul_rn(d, xs[r][ch]), bs[r][s]);
      h = __fadd_rn(__fmul_rn(d_a, h), d_bx);
      float p = __fmul_rn(h, cs[r][s]);
#pragma unroll
      for (int off = DS / 2; off > 0; off >>= 1) {
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
      }
      if (s == 0) ys[r][ch] = p;
    }
    __syncthreads();
    // the next chunk's staging writes xs, dts, bs and cs only, and its
    // steps write ys after the next barrier: one barrier per phase
    for (int i = tid; i < tc * kCh; i += kThreads) {
      const int r = i / kCh, c = i % kCh;
      if (di0 + c < Di) y[(row0 + t0 + r) * Di + di0 + c] = ys[r][c];
    }
  }
  if (live) h_out[((long long)blockIdx.y * Di + di) * DS + s] = h;
}

template <int DS>
int launch_scan(const void* x, const void* dt, const void* bp, const void* cp,
                const void* a, void* y, void* h, int B, int T, int Di,
                cudaStream_t st) {
  constexpr int kCh = kThreads / DS;
  dim3 grid((Di + kCh - 1) / kCh, B);
  selective_scan_kernel<DS><<<grid, kThreads, 0, st>>>(
      (const float*)x, (const float*)dt, (const float*)bp, (const float*)cp,
      (const float*)a, (float*)y, (float*)h, T, Di);
  return int(cudaGetLastError());
}

}  // namespace scan

extern "C" {

int scan_selective(const void* x, const void* dt, const void* bp,
                   const void* cp, const void* a, void* y, void* h, int B,
                   int T, int Di, int Ds, void* stream) {
  cudaStream_t st = cudaStream_t(stream);
  switch (Ds) {
    case 4: return scan::launch_scan<4>(x, dt, bp, cp, a, y, h, B, T, Di, st);
    case 8: return scan::launch_scan<8>(x, dt, bp, cp, a, y, h, B, T, Di, st);
    case 16:
      return scan::launch_scan<16>(x, dt, bp, cp, a, y, h, B, T, Di, st);
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
