// The CUDA-core matmul kernels of the port: three __global__ kernels and
// their plain C launchers, loaded with ctypes by
// src/repro_torch/kernels/cuda.py.  The MXU members on int8 and bf16
// operands run on the tensor cores instead (mm_tc_kernels.cu); here run
// mm_vpu on every dtype and mm_mxu / _mm_dual on f32.
//
// Built with the flags of cnn_kernels.cu (-fmad=false), which shares its
// arithmetic helpers (cnn_device.cuh: widen, mac).  a (M, K) and b (K, N)
// are row-major and contiguous, of one dtype: f32 or bf16 (f32
// accumulator, bf16 widened exactly on load) or int8 (int32 accumulator,
// wrapping).  Every output is ONE sequential multiply-add chain over
// k = 0 .. K-1 (explicit __fmaf_rn for floats), so results never depend
// on the tiling, and f32 mm_mxu and mm_vpu agree bitwise.  The
// reference's block hints (bm, bn, bk) are TPU VMEM tiling: the wrappers
// validate them and they do not shape these launches.
//
// mm_mxu_kernel<float>  replaces src/repro/kernels/matmul/mxu.py::mm_mxu
//   on f32.  2*M*N*K operations on M*K + K*N inputs: at the FFN shapes of
//   the chip run (512 x 2048 x 8192) the FP32 rate bounds it.  A 128x128
//   CTA tile, K staged 8 deep in shared memory, 256 threads each holding
//   an 8x8 register tile, rows ty + 16r and columns tx + 16q so shared
//   loads and global stores are conflict-free and coalesced.  FP32 FMA:
//   Hopper has no IEEE-f32 MMA, and TF32 misses the reference tolerance.
//
// mm_vpu_kernel<T>  replaces src/repro/kernels/matmul/mxu.py::mm_vpu
//   The logic-only member: no shared-memory tile, no MMA instruction.
//   One thread per output; a block of 8 rows x 32 columns, so a warp
//   reads 32 neighbouring columns of b (coalesced) and the 8 warps of a
//   block share them through L1.  Bound as mm_mxu by the FP32 rate; it
//   re-reads a and b from cache once per output.
//
// mm_dual_kernel<float>  replaces src/repro/kernels/matmul/dual.py::
//   _mm_dual (mm_dual_full) on f32.  Two a streams against one b: 4*M*N*K
//   operations on 2*M*K + K*N inputs and two (M, N) outputs, bound by
//   the FP32 rate.  mm_mxu's tile body with two a tiles and ONE b tile
//   staged per k-step, both streams reading it: the weights cross device
//   memory once for two outputs, as in the reference.  Two 8x8 register
//   tiles would be 128 accumulators a thread, so each stream keeps 8x4 (a
//   128 x 64 CTA tile); each output is still mm_mxu's chain, so each
//   stream equals an mm_mxu launch bitwise.
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

// The tile body of mm_mxu_kernel and mm_dual_kernel: NS streams a[s]
// (M, K) against one b (K, N) into c[s].  The CTA owns kTile rows and
// kSide * QN columns; per k-step it stages each stream's a tile
// (transposed, widened) and ONE b tile in shared memory, and every
// stream reads that b tile.  Thread (ty, tx) keeps a kReg x QN register
// tile per stream: rows ty + 16r, columns tx + 16q.  Each output is one
// multiply-add chain over k = 0 .. K-1 whatever NS and QN are.
template <typename T, int NS, int QN>
__device__ __forceinline__ void mm_tiles(
    const T* const (&a)[NS], const T* __restrict__ b,
    typename Acc<T>::type* const (&c)[NS], int M, int N, int K) {
  using A = typename Acc<T>::type;
  constexpr int kCols = kSide * QN;
  __shared__ A as[NS][kDepth][kTile + 1];   // as[s][k][m]: a tiles
  __shared__ A bs[kDepth][kCols];
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kCols;
  A acc[NS][kReg][QN];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int r = 0; r < kReg; ++r) {
#pragma unroll
      for (int q = 0; q < QN; ++q) acc[s][r][q] = A(0);
    }
  }
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int e = threadIdx.x; e < kTile * kDepth; e += kSide * kSide) {
      int mm = e / kDepth, kk = e % kDepth;        // a: along k first
      int gm = m0 + mm, gk = k0 + kk;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        as[s][kk][mm] = (gm < M && gk < K)
                            ? widen<A>(a[s][size_t(gm) * K + gk]) : A(0);
      }
    }
    for (int e = threadIdx.x; e < kCols * kDepth; e += kSide * kSide) {
      int kb = e / kCols, nn = e % kCols;          // b: along n first
      int gkb = k0 + kb, gn = n0 + nn;
      bs[kb][nn] = (gkb < K && gn < N) ? widen<A>(b[size_t(gkb) * N + gn])
                                       : A(0);
    }
    __syncthreads();
    // only the live depth: a padded zero term could flip the sign of a
    // zero sum, and results must not depend on the tiling
    const int depth = min(kDepth, K - k0);
    for (int kk = 0; kk < depth; ++kk) {
      A bv[QN];
#pragma unroll
      for (int q = 0; q < QN; ++q) bv[q] = bs[kk][tx + kSide * q];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        A av[kReg];
#pragma unroll
        for (int r = 0; r < kReg; ++r) av[r] = as[s][kk][ty + kSide * r];
#pragma unroll
        for (int r = 0; r < kReg; ++r) {
#pragma unroll
          for (int q = 0; q < QN; ++q) {
            acc[s][r][q] = mac(acc[s][r][q], av[r], bv[q]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int r = 0; r < kReg; ++r) {
      int gm = m0 + ty + kSide * r;
      if (gm >= M) continue;
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        int gn = n0 + tx + kSide * q;
        if (gn < N) c[s][size_t(gm) * N + gn] = acc[s][r][q];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSide * kSide)
mm_mxu_kernel(const T* __restrict__ a, const T* __restrict__ b,
              typename Acc<T>::type* __restrict__ c, int M, int N, int K) {
  const T* const src[1] = {a};
  typename Acc<T>::type* const dst[1] = {c};
  mm_tiles<T, 1, kReg>(src, b, dst, M, N, K);
}

// Two streams of kReg x kDualCols outputs each per thread (64
// accumulators, as mm_mxu's one 8x8 tile): a 128 x 64 CTA tile.
constexpr int kDualCols = 4;

template <typename T>
__global__ void __launch_bounds__(kSide * kSide)
mm_dual_kernel(const T* __restrict__ a1, const T* __restrict__ a2,
               const T* __restrict__ b, typename Acc<T>::type* __restrict__ c1,
               typename Acc<T>::type* __restrict__ c2, int M, int N, int K) {
  const T* const src[2] = {a1, a2};
  typename Acc<T>::type* const dst[2] = {c1, c2};
  mm_tiles<T, 2, kDualCols>(src, b, dst, M, N, K);
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

int launch_mxu(const void* a, const void* b, void* c, int M, int N, int K,
               cudaStream_t st) {
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  mm_mxu_kernel<float><<<grid, kSide * kSide, 0, st>>>(
      (const float*)a, (const float*)b, (float*)c, M, N, K);
  return int(cudaGetLastError());
}

template <typename T>
int launch_vpu(const void* a, const void* b, void* c, int M, int N, int K,
               cudaStream_t st) {
  using A = typename Acc<T>::type;
  dim3 grid((N + kVpuCols - 1) / kVpuCols, (M + kVpuRows - 1) / kVpuRows);
  mm_vpu_kernel<T><<<grid, dim3(kVpuCols, kVpuRows), 0, st>>>(
      (const T*)a, (const T*)b, (A*)c, M, N, K);
  return int(cudaGetLastError());
}

int launch_dual(const void* a1, const void* a2, const void* b, void* c1,
                void* c2, int M, int N, int K, cudaStream_t st) {
  dim3 grid((N + kSide * kDualCols - 1) / (kSide * kDualCols),
            (M + kTile - 1) / kTile);
  mm_dual_kernel<float><<<grid, kSide * kSide, 0, st>>>(
      (const float*)a1, (const float*)a2, (const float*)b, (float*)c1,
      (float*)c2, M, N, K);
  return int(cudaGetLastError());
}

}  // namespace mm

extern "C" {

// mm_vpu on f32, bf16 or int8; mm_mxu on f32 (int8 and bf16 run on
// mm_tc_kernels.cu's tensor-core kernels)
int cnn_matmul(int style, int dtype, const void* a, const void* b, void* c,
               int M, int N, int K, void* stream) {
  cudaStream_t st = cudaStream_t(stream);
  if (style == mm::kMxu) {
    return dtype == mm::kF32 ? mm::launch_mxu(a, b, c, M, N, K, st)
                             : int(cudaErrorInvalidValue);
  }
  if (style != mm::kVpu) return int(cudaErrorInvalidValue);
  if (dtype == mm::kF32) return mm::launch_vpu<float>(a, b, c, M, N, K, st);
  if (dtype == mm::kBF16) {
    return mm::launch_vpu<__nv_bfloat16>(a, b, c, M, N, K, st);
  }
  if (dtype == mm::kI8) return mm::launch_vpu<int8_t>(a, b, c, M, N, K, st);
  return int(cudaErrorInvalidValue);
}

// _mm_dual on f32 (int8 and bf16 run on mm_tc_kernels.cu)
int cnn_matmul_dual(int dtype, const void* a1, const void* a2, const void* b,
                    void* c1, void* c2, int M, int N, int K, void* stream) {
  if (dtype != mm::kF32) return int(cudaErrorInvalidValue);
  return mm::launch_dual(a1, a2, b, c1, c2, M, N, K, cudaStream_t(stream));
}

}  // extern "C"
