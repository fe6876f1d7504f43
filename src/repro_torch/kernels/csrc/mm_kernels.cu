// The matmul kernels of the port: two __global__ kernels and their plain C
// launcher, loaded with ctypes by src/repro_torch/kernels/cuda.py.
//
// Built with the flags of cnn_kernels.cu (-fmad=false), which shares its
// arithmetic helpers (cnn_device.cuh: widen, mac).  a (M, K) and b (K, N)
// are row-major and contiguous, of one dtype: f32 or bf16 (f32
// accumulator, bf16 widened exactly on load) or int8 (int32 accumulator,
// wrapping).  Every output is ONE sequential multiply-add chain over
// k = 0 .. K-1 (explicit __fmaf_rn for floats), so results never depend
// on the tiling, and mm_mxu and mm_vpu agree bitwise.  The reference's
// block hints (bm, bn, bk) are TPU VMEM tiling: the wrappers validate
// them and they do not shape these launches.
//
// mm_mxu_kernel<T>  replaces src/repro/kernels/matmul/mxu.py::mm_mxu
//   2*M*N*K operations on M*K + K*N inputs: at the FFN shapes of the
//   chip run (512 x 2048 x 8192) the FP32 rate bounds f32, and device
//   memory bounds int8 against the int8 tensor-core peak.  This version
//   runs on CUDA cores: a 128x128 CTA tile, K staged 8 deep in shared
//   memory (widened to the accumulator type), 256 threads each holding
//   an 8x8 register tile, rows ty + 16r and columns tx + 16q so shared
//   loads and global stores are conflict-free and coalesced.  FP32 FMA
//   for floats (TF32 misses the reference tolerance), IMAD for int8;
//   wgmma/IMMA with TMA loads are later work (ROADMAP queue 2).
//
// mm_vpu_kernel<T>  replaces src/repro/kernels/matmul/mxu.py::mm_vpu
//   The logic-only member: no shared-memory tile, no MMA instruction.
//   One thread per output; a block of 8 rows x 32 columns, so a warp
//   reads 32 neighbouring columns of b (coalesced) and the 8 warps of a
//   block share them through L1.  Bound as mm_mxu by the FP32 rate; it
//   re-reads a and b from cache once per output.
#include <cuda_runtime.h>

#include <cstdint>

#include "cnn_device.cuh"

namespace mm {

using cnn::mac;
using cnn::widen;

enum Style { kVpu = 0, kMxu = 1 };
enum DType { kF32 = 0, kI8 = 1, kBF16 = 4 };   // codes of cnn_kernels.cu

constexpr int kTile = 128;       // CTA tile (rows and columns) of mm_mxu
constexpr int kDepth = 8;        // K staged per shared-memory tile
constexpr int kSide = 16;        // threads per side: 16 x 16 = 256
constexpr int kReg = kTile / kSide;   // 8x8 outputs per thread

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = int32_t; };

template <typename T>
__global__ void __launch_bounds__(kSide * kSide)
mm_mxu_kernel(const T* __restrict__ a, const T* __restrict__ b,
              typename Acc<T>::type* __restrict__ c, int M, int N, int K) {
  using A = typename Acc<T>::type;
  __shared__ A as[kDepth][kTile + 1];   // as[k][m]: a tile, transposed
  __shared__ A bs[kDepth][kTile];
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  A acc[kReg][kReg];
#pragma unroll
  for (int r = 0; r < kReg; ++r) {
#pragma unroll
    for (int q = 0; q < kReg; ++q) acc[r][q] = A(0);
  }
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int e = threadIdx.x; e < kTile * kDepth; e += kSide * kSide) {
      int mm = e / kDepth, kk = e % kDepth;        // a: along k first
      int gm = m0 + mm, gk = k0 + kk;
      as[kk][mm] = (gm < M && gk < K) ? widen<A>(a[size_t(gm) * K + gk])
                                      : A(0);
      int kb = e / kTile, nn = e % kTile;          // b: along n first
      int gkb = k0 + kb, gn = n0 + nn;
      bs[kb][nn] = (gkb < K && gn < N) ? widen<A>(b[size_t(gkb) * N + gn])
                                       : A(0);
    }
    __syncthreads();
    // only the live depth: a padded zero term could flip the sign of a
    // zero sum, and results must not depend on the tiling
    const int depth = min(kDepth, K - k0);
    for (int kk = 0; kk < depth; ++kk) {
      A av[kReg], bv[kReg];
#pragma unroll
      for (int r = 0; r < kReg; ++r) av[r] = as[kk][ty + kSide * r];
#pragma unroll
      for (int q = 0; q < kReg; ++q) bv[q] = bs[kk][tx + kSide * q];
#pragma unroll
      for (int r = 0; r < kReg; ++r) {
#pragma unroll
        for (int q = 0; q < kReg; ++q) acc[r][q] = mac(acc[r][q], av[r], bv[q]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kReg; ++r) {
    int gm = m0 + ty + kSide * r;
    if (gm >= M) continue;
#pragma unroll
    for (int q = 0; q < kReg; ++q) {
      int gn = n0 + tx + kSide * q;
      if (gn < N) c[size_t(gm) * N + gn] = acc[r][q];
    }
  }
}

constexpr int kVpuCols = 32;     // mm_vpu block: 8 rows x 32 columns
constexpr int kVpuRows = 8;

template <typename T>
__global__ void mm_vpu_kernel(const T* __restrict__ a,
                              const T* __restrict__ b,
                              typename Acc<T>::type* __restrict__ c, int M,
                              int N, int K) {
  using A = typename Acc<T>::type;
  int n = blockIdx.x * kVpuCols + threadIdx.x;
  int m = blockIdx.y * kVpuRows + threadIdx.y;
  if (m >= M || n >= N) return;
  const T* ar = a + size_t(m) * K;
  A acc = A(0);
  for (int k = 0; k < K; ++k) {
    acc = mac(acc, widen<A>(ar[k]), widen<A>(b[size_t(k) * N + n]));
  }
  c[size_t(m) * N + n] = acc;
}

template <typename T>
int launch(int style, const void* a, const void* b, void* c, int M, int N,
           int K, cudaStream_t st) {
  using A = typename Acc<T>::type;
  if (style == kMxu) {
    dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
    mm_mxu_kernel<T><<<grid, kSide * kSide, 0, st>>>(
        (const T*)a, (const T*)b, (A*)c, M, N, K);
  } else if (style == kVpu) {
    dim3 grid((N + kVpuCols - 1) / kVpuCols, (M + kVpuRows - 1) / kVpuRows);
    mm_vpu_kernel<T><<<grid, dim3(kVpuCols, kVpuRows), 0, st>>>(
        (const T*)a, (const T*)b, (A*)c, M, N, K);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace mm

extern "C" {

int cnn_matmul(int style, int dtype, const void* a, const void* b, void* c,
               int M, int N, int K, void* stream) {
  cudaStream_t st = cudaStream_t(stream);
  if (dtype == mm::kF32) return mm::launch<float>(style, a, b, c, M, N, K, st);
  if (dtype == mm::kBF16) {
    return mm::launch<__nv_bfloat16>(style, a, b, c, M, N, K, st);
  }
  if (dtype == mm::kI8) return mm::launch<int8_t>(style, a, b, c, M, N, K, st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
