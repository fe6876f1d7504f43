// The CUDA-core matmul kernels of the port: three __global__ kernels and
// their plain C launchers, loaded with ctypes by
// src/repro_torch/kernels/cuda.py.  The MXU members on int8 and bf16
// operands run on the tensor cores instead (mm_tc_kernels.cu); here run
// mm_vpu on every dtype and mm_mxu / _mm_dual on f32.
//
// Built with the flags of cnn_kernels.cu (-fmad=false), which shares its
// arithmetic helpers (cnn_device.cuh: mac).  a (M, K) and b (K, N)
// are row-major, of one dtype: f32 or bf16 (f32 accumulator, bf16
// widened exactly on load) or int8 (int32 accumulator, wrapping).  Every
// output is ONE sequential multiply-add chain over k = 0 .. K-1
// (explicit __fmaf_rn for floats), so results never depend on the
// tiling: f32 mm_mxu and mm_vpu agree bitwise, and each stream of f32
// _mm_dual equals an mm_mxu launch.  The reference's block hints (bm,
// bn, bk) are TPU VMEM tiling: the wrappers validate them and they do
// not shape these launches.
//
// mm_mxu_f32_kernel  replaces src/repro/kernels/matmul/mxu.py::mm_mxu
//   on f32.  2*M*N*K operations on M*K + K*N inputs: at the FFN shapes of
//   the chip run (512 x 2048 x 8192) the FP32 rate bounds it.  A 128 x 256
//   CTA tile (the FFN is 128 CTAs, one wave on 132 SMs, one CTA an SM)
//   stages 32 k a step of a (k-contiguous rows, as it lies) and of b (as
//   it lies) through a 3-stage cp.async ring, so the loads of later
//   steps overlap this step's multiply-adds.  Each of the 256 threads
//   keeps an 8 x 16 register tile (rows ty + 16 r, columns 4 tx + 64 h
//   + 0..3): per 4 k it reads its 8 a rows as one 16-byte load each and
//   per k its 16 b columns as four 16-byte loads (a quarter-warp reads
//   one a address or 128 contiguous bytes of b: no bank conflict),
//   b's next k while this k's 128 FMAs issue: 24 shared loads per 512
//   FMAs.  FP32 FMA: Hopper has no IEEE-f32 MMA, and TF32 misses the
//   reference tolerance; a 3xTF32 route would move mm_mxu and _mm_dual
//   together.
//
// mm_dual_f32_kernel  replaces src/repro/kernels/matmul/dual.py::_mm_dual
//   (mm_dual_full) on f32.  Two a streams against one b: 4*M*N*K
//   operations on 2*M*K + K*N inputs and two (M, N) outputs, bound by
//   the FP32 rate.  mm_mxu_f32_kernel's body (mxu_f32_tiles) with two
//   streams: per k-step a CTA stages both streams' a tiles and ONE b
//   tile, and both streams read that b tile, as the reference's grid
//   step loads one weight block for two accumulators.  Two 8 x 16
//   register tiles would not fit, so each thread keeps 4 x 16 a stream
//   (128 accumulators, as mm_mxu's; a CTA tile of 64 x 256 a stream,
//   48 KB a stage, 24 shared loads per 512 FMAs).  The schedule and
//   every output's chain are mm_mxu's, so each stream equals an mm_mxu
//   launch bitwise.
//
// mm_vpu_kernel<T>  replaces src/repro/kernels/matmul/mxu.py::mm_vpu
//   The logic-only member: no MMA instruction, FFMA (f32, bf16 widened
//   on use) or IMAD (int8 into int32, wrapping) only.  Bound as mm_mxu by
//   the FP32 rate (int8: the INT32 lanes').  The reference holds (bm, K)
//   and (K, bn) blocks in VMEM; here a 128 x 128 CTA tile stages 64
//   bytes of K a k-step of a (as it lies, k-contiguous rows) and of b
//   (as it lies) through a 4-stage cp.async ring.  Each of the 256
//   threads keeps an 8 x 8 register tile (rows ty + 16 r, columns
//   4 tx + 64 h + 0..3): per 16 bytes of K it reads its 8 a rows as one
//   16-byte load each and, per k, b's two 4-column runs as vector loads
//   (a quarter-warp reads one a address, or 128 contiguous bytes of b:
//   no bank conflict), and stores 4 columns at a time.  Each output
//   is still ONE chain over k = 0 .. K-1 (no split-K), so it equals
//   mm_mxu on f32 bitwise.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "cnn_device.cuh"
#include "tc_device.cuh"

namespace mm {

using cnn::mac;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::smem_u32;

enum Style { kVpu = 0, kMxu = 1 };
enum DType { kF32 = 0, kI8 = 1, kBF16 = 4 };   // codes of cnn_kernels.cu

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = int32_t; };

// mm_vpu's tile: 128 x 128 outputs a CTA of 256 threads, each thread
// 8 rows (ty + 16 r) x 8 columns (4 tx + 64 h + e, h < 2, e < 4).  Per
// k-step the CTA stages 64 bytes of K: a (128 rows of 64 bytes, as it
// lies) and b (64 / sizeof(T) rows of 128 columns, as it lies), 16 KB,
// in a ring of kVpuStages stages filled by cp.async.
constexpr int kVpuTile = 128;
constexpr int kVpuThreads = 256;
constexpr int kVpuRowBytes = 64;                       // K bytes a k-step
constexpr int kVpuStages = 4;
constexpr int kVpuABytes = kVpuTile * kVpuRowBytes;    // 8 KB
constexpr int kVpuStageBytes = 2 * kVpuABytes;         // a + b
constexpr int kVpuSmem = kVpuStages * kVpuStageBytes;  // 64 KB

// Value kk of a 16-byte chunk of K, widened exactly to the accumulator
// type: f32 as it is, bf16 by a shift, int8 sign-extended.
template <typename T> struct Lane;
template <> struct Lane<float> {
  __device__ static float at(const uint4& w, int kk) {
    return __uint_as_float((&w.x)[kk]);
  }
};
template <> struct Lane<__nv_bfloat16> {
  __device__ static float at(const uint4& w, int kk) {
    const uint32_t x = (&w.x)[kk / 2];
    return __uint_as_float(kk % 2 ? x & 0xffff0000u : x << 16);
  }
};
template <> struct Lane<int8_t> {
  __device__ static int32_t at(const uint4& w, int kk) {
    return int32_t((&w.x)[kk / 4] << (24 - 8 * (kk % 4))) >> 24;
  }
};

// b's 4 neighbouring columns of one k row from shared memory, widened
__device__ __forceinline__ void b_quad(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void b_quad(const __nv_bfloat16* p,
                                       float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void b_quad(const int8_t* p, int32_t (&v)[4]) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = int32_t(x << (24 - 8 * e)) >> 24;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(int32_t* p, const int32_t (&v)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// a (M, K) with rows lda apart and b (K, N) with rows ldb apart; lda and
// ldb are multiples of 16 bytes and both bases 16-byte aligned (the
// wrapper pads where they are not).  Only the live depth K is summed.
template <typename T>
__global__ void __launch_bounds__(kVpuThreads, 2)
mm_vpu_kernel(const T* __restrict__ a, const T* __restrict__ b,
              typename Acc<T>::type* __restrict__ c, int M, int N, int K,
              int lda, int ldb) {
  using A = typename Acc<T>::type;
  constexpr int kV = 16 / int(sizeof(T));            // K values a chunk
  constexpr int kStepK = kVpuRowBytes / int(sizeof(T));   // K a k-step
  constexpr int kBRowBytes = kVpuTile * int(sizeof(T));
  constexpr int kBChunks = kBRowBytes / 16;          // chunks a b row
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kVpuTile, n0 = blockIdx.x * kVpuTile;
  const int steps = (K + kStepK - 1) / kStepK;
  const uint32_t base = smem_u32(smem);

  auto load = [&](int stage, int step) {
    const uint32_t sa = base + stage * kVpuStageBytes, sb = sa + kVpuABytes;
    const int k0 = step * kStepK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {            // a: 128 rows x 4 chunks
      const int e = t + kVpuThreads * j, r = e / 4, ch = e % 4;
      const int gm = m0 + r, gk = k0 + ch * kV;
      const bool ok = gm < M && gk < K;
      cp_async16(sa + r * kVpuRowBytes + ch * 16,
                 ok ? a + size_t(gm) * lda + gk : a, ok);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {            // b: kStepK rows, 128 columns
      const int e = t + kVpuThreads * j, r = e / kBChunks, ch = e % kBChunks;
      const int gk = k0 + r, gn = n0 + ch * kV;
      const bool ok = gk < K && gn < ldb;
      cp_async16(sb + r * kBRowBytes + ch * 16,
                 ok ? b + size_t(gk) * ldb + gn : b, ok);
    }
  };

  A acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = A(0);
  }
#pragma unroll
  for (int s = 0; s < kVpuStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kVpuStages - 2>();
    __syncthreads();                         // the stage landed for all;
    const int pre = step + kVpuStages - 1;   // the one read last is free
    if (pre < steps) load(pre % kVpuStages, pre);
    cp_async_commit();
    const uint8_t* sa = smem + (step % kVpuStages) * kVpuStageBytes;
    const T* sb = reinterpret_cast<const T*>(sa + kVpuABytes) + 4 * tx;
    // only the live depth: a padded zero term could flip the sign of a
    // zero sum, and results must not depend on the tiling
    const int depth = min(kStepK, K - step * kStepK);
#pragma unroll
    for (int ch = 0; ch < kVpuRowBytes / 16; ++ch) {
      if (ch * kV >= depth) break;
      uint4 af[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        af[r] = *reinterpret_cast<const uint4*>(
            sa + (ty + 16 * r) * kVpuRowBytes + ch * 16);
      }
#pragma unroll
      for (int kk = 0; kk < kV; ++kk) {
        const int k = ch * kV + kk;
        if (k >= depth) break;
        A bv[2][4];
        b_quad(sb + k * kVpuTile, bv[0]);
        b_quad(sb + k * kVpuTile + 64, bv[1]);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const A av = Lane<T>::at(af[r], kk);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            acc[r][q] = mac(acc[r][q], av, bv[q / 4][q % 4]);
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");

  const bool quads = N % 4 == 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gm = m0 + ty + 16 * r;
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + 4 * tx + 64 * h;
      A* p = c + size_t(gm) * N + gn;
      const A v[4] = {acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                      acc[r][4 * h + 3]};
      if (quads && gn < N) {
        store4(p, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (gn + e < N) p[e] = v[e];
        }
      }
    }
  }
}

// The f32 MXU tile of NS a streams against one b (mm_mxu_f32_kernel: one
// stream, mm_dual_f32_kernel: two): a CTA of 256 threads, each thread R
// rows of every stream (ty + 16 r) x 4 QH columns (4 tx + 64 h + e, h <
// QH, e < 4), so a CTA owns 16 R rows of each stream x 64 QH columns.
// Per k-step the CTA stages 32 k: each stream's a (16 R rows of 128
// bytes, as it lies) and ONE b (32 rows of 64 QH columns, as it lies) in
// a ring of kMxuStages stages filled by cp.async; every stream reads
// that b tile.
constexpr int kMxuThreads = 256;
constexpr int kMxuStepK = 32;                          // K a k-step
constexpr int kMxuStages = 3;
constexpr int kMxuAChunks = kMxuStepK / 4;             // 16 bytes a row

template <int NS, int R, int QH>
struct MxuTile {
  static constexpr int kNS = NS, kR = R, kQH = QH;
  static constexpr int kRows = 16 * R;                 // a rows a stream
  static constexpr int kCols = 64 * QH;
  static constexpr int kBChunks = kCols / 4;
  static constexpr int kABytes = kRows * kMxuStepK * 4;    // one stream
  static constexpr int kBBytes = kMxuStepK * kCols * 4;
  static constexpr int kStageBytes = NS * kABytes + kBBytes;
  static constexpr int kSmem = kMxuStages * kStageBytes;
};
// mm_mxu: 8 x 16 outputs a thread, a 128 x 256 CTA tile, 48 KB a stage.
using MxuOne = MxuTile<1, 8, 4>;
// mm_dual_full: 4 x 16 outputs a thread a stream (128 accumulators, as
// mm_mxu's), a CTA tile of 64 x 256 a stream, 48 KB a stage.
using MxuDual = MxuTile<2, 4, 4>;

// f32 a[s] (M, K) with rows lda apart and b (K, N) with rows ldb apart
// into c[s]; lda and ldb are multiples of 4 elements and every base
// 16-byte aligned (the wrapper pads where they are not).  Only the live
// depth K is summed, k = 0 .. K-1 in order from +0 for every output, so
// each stream equals a one-stream launch bitwise whatever the tile.
template <typename L>
__device__ __forceinline__ void mxu_f32_tiles(
    const float* const (&a)[L::kNS], const float* __restrict__ b,
    float* const (&c)[L::kNS], int M, int N, int K, int lda, int ldb) {
  constexpr int NS = L::kNS, R = L::kR, QH = L::kQH;
  constexpr int kC = 4 * QH;                           // columns a thread
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * L::kRows, n0 = blockIdx.x * L::kCols;
  const int steps = (K + kMxuStepK - 1) / kMxuStepK;
  const uint32_t base = smem_u32(smem);

  auto load = [&](int stage, int step) {
    const uint32_t st = base + stage * L::kStageBytes;
    const uint32_t sb = st + NS * L::kABytes;
    const int k0 = step * kMxuStepK;
#pragma unroll
    for (int s = 0; s < NS; ++s) {                     // a
      const uint32_t sa = st + s * L::kABytes;
#pragma unroll
      for (int j = 0; j < L::kRows * kMxuAChunks / kMxuThreads; ++j) {
        const int e = t + kMxuThreads * j, r = e / kMxuAChunks;
        const int ch = e % kMxuAChunks;
        const int gm = m0 + r, gk = k0 + ch * 4;
        const bool ok = gm < M && gk < K;
        cp_async16(sa + r * (kMxuStepK * 4) + ch * 16,
                   ok ? a[s] + size_t(gm) * lda + gk : a[s], ok);
      }
    }
#pragma unroll
    for (int j = 0; j < kMxuStepK * L::kBChunks / kMxuThreads; ++j) {   // b
      const int e = t + kMxuThreads * j, r = e / L::kBChunks;
      const int ch = e % L::kBChunks;
      const int gk = k0 + r, gn = n0 + ch * 4;
      const bool ok = gk < K && gn < ldb;
      cp_async16(sb + r * (L::kCols * 4) + ch * 16,
                 ok ? b + size_t(gk) * ldb + gn : b, ok);
    }
  };

  float acc[NS][R][kC];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int q = 0; q < kC; ++q) acc[s][r][q] = 0.0f;
    }
  }
  // depth k of the staged step: 32 FULL, else the live remainder (a
  // padded zero term could flip the sign of a zero sum, and results must
  // not depend on the tiling).  Per 4 k each thread reads its R a rows of
  // every stream as one 16-byte load each and, per k, its 4 QH b columns
  // as QH; b's next k is read while this k's multiply-adds issue.
  auto step_body = [&](const uint8_t* st, int depth, auto full) {
    constexpr bool kFull = decltype(full)::value;
    const float* sb =
        reinterpret_cast<const float*>(st + NS * L::kABytes) + 4 * tx;
    float bv[2][kC];
    auto load_b = [&](int k, float (&v)[kC]) {
#pragma unroll
      for (int h = 0; h < QH; ++h) {
        const float4 x =
            *reinterpret_cast<const float4*>(sb + k * L::kCols + 64 * h);
        v[4 * h] = x.x; v[4 * h + 1] = x.y; v[4 * h + 2] = x.z;
        v[4 * h + 3] = x.w;
      }
    };
    auto load_a = [&](int ch, float4 (&af)[NS][R]) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float* sa =
            reinterpret_cast<const float*>(st + s * L::kABytes);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          af[s][r] = *reinterpret_cast<const float4*>(
              sa + (ty + 16 * r) * kMxuStepK + ch * 4);
        }
      }
    };
    float4 af[NS][R];
    load_b(0, bv[0]);
    load_a(0, af);
    // 4 k of a's 16-byte runs: kk indexes bv, as ch * 4 is even
    auto one_ch = [&](int ch) {
      if (ch > 0) load_a(ch, af);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = ch * 4 + kk;
        if (!kFull && k >= depth) break;
        if (k + 1 < kMxuStepK && (kFull || k + 1 < depth)) {
          load_b(k + 1, bv[(kk + 1) % 2]);
        }
#pragma unroll
        for (int s = 0; s < NS; ++s) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float av = (&af[s][r].x)[kk];
#pragma unroll
            for (int q = 0; q < kC; ++q) {
              acc[s][r][q] = __fmaf_rn(av, bv[kk % 2][q], acc[s][r][q]);
            }
          }
        }
      }
    };
#pragma unroll
    for (int ch = 0; ch < kMxuStepK / 4; ++ch) {
      if (!kFull && ch * 4 >= depth) break;
      one_ch(ch);
    }
  };

#pragma unroll
  for (int s = 0; s < kMxuStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kMxuStages - 2>();
    __syncthreads();                         // the stage landed for all;
    const int pre = step + kMxuStages - 1;   // the one read last is free
    if (pre < steps) load(pre % kMxuStages, pre);
    cp_async_commit();
    const uint8_t* st = smem + (step % kMxuStages) * L::kStageBytes;
    const int depth = min(kMxuStepK, K - step * kMxuStepK);
    if (depth == kMxuStepK) {
      step_body(st, depth, std::true_type{});
    } else {
      step_body(st, depth, std::false_type{});
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");

  const bool quads = N % 4 == 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int gm = m0 + ty + 16 * r;
      if (gm >= M) continue;
#pragma unroll
      for (int h = 0; h < QH; ++h) {
        const int gn = n0 + 4 * tx + 64 * h;
        float* p = c[s] + size_t(gm) * N + gn;
        const float v[4] = {acc[s][r][4 * h], acc[s][r][4 * h + 1],
                            acc[s][r][4 * h + 2], acc[s][r][4 * h + 3]};
        if (quads && gn < N) {
          store4(p, v);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (gn + e < N) p[e] = v[e];
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kMxuThreads, 1)
mm_mxu_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int M, int N, int K, int lda,
                  int ldb) {
  const float* const src[1] = {a};
  float* const dst[1] = {c};
  mxu_f32_tiles<MxuOne>(src, b, dst, M, N, K, lda, ldb);
}

__global__ void __launch_bounds__(kMxuThreads, 1)
mm_dual_f32_kernel(const float* __restrict__ a1,
                   const float* __restrict__ a2, const float* __restrict__ b,
                   float* __restrict__ c1, float* __restrict__ c2, int M,
                   int N, int K, int lda, int ldb) {
  const float* const src[2] = {a1, a2};
  float* const dst[2] = {c1, c2};
  mxu_f32_tiles<MxuDual>(src, b, dst, M, N, K, lda, ldb);
}

// kernel on the tile L: ceil(N / columns) x ceil(M / rows) CTAs of
// kMxuThreads with L's dynamic shared memory.
template <typename L, typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, int M, int N, cudaStream_t st,
                 Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) {
    cudaGetLastError();              // clear it: no later launch reads it
    return int(err);
  }
  dim3 grid((N + L::kCols - 1) / L::kCols, (M + L::kRows - 1) / L::kRows);
  kernel<<<grid, kMxuThreads, L::kSmem, st>>>(args...);
  return int(cudaGetLastError());
}

template <typename T>
int launch_vpu(const void* a, const void* b, void* c, int M, int N, int K,
               int lda, int ldb, cudaStream_t st) {
  using A = typename Acc<T>::type;
  cudaError_t err = cudaFuncSetAttribute(
      mm_vpu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kVpuSmem);
  if (err != cudaSuccess) {
    cudaGetLastError();              // clear it: no later launch reads it
    return int(err);
  }
  dim3 grid((N + kVpuTile - 1) / kVpuTile, (M + kVpuTile - 1) / kVpuTile);
  mm_vpu_kernel<T><<<grid, kVpuThreads, kVpuSmem, st>>>(
      (const T*)a, (const T*)b, (A*)c, M, N, K, lda, ldb);
  return int(cudaGetLastError());
}

}  // namespace mm

extern "C" {

// mm_vpu on f32, bf16 or int8; mm_mxu on f32 (int8 and bf16 run on
// mm_tc_kernels.cu's tensor-core kernels).  a's rows lie lda apart and
// b's ldb apart, in multiples of 16 bytes, and both bases are 16-byte
// aligned.
int cnn_matmul(int style, int dtype, const void* a, const void* b, void* c,
               int M, int N, int K, int lda, int ldb, void* stream) {
  cudaStream_t st = cudaStream_t(stream);
  if (style == mm::kMxu) {
    if (dtype != mm::kF32) return int(cudaErrorInvalidValue);
    return mm::launch_tiles<mm::MxuOne>(mm::mm_mxu_f32_kernel, M, N, st,
                                        (const float*)a, (const float*)b,
                                        (float*)c, M, N, K, lda, ldb);
  }
  if (style != mm::kVpu) return int(cudaErrorInvalidValue);
  if (dtype == mm::kF32) {
    return mm::launch_vpu<float>(a, b, c, M, N, K, lda, ldb, st);
  }
  if (dtype == mm::kBF16) {
    return mm::launch_vpu<__nv_bfloat16>(a, b, c, M, N, K, lda, ldb, st);
  }
  if (dtype == mm::kI8) {
    return mm::launch_vpu<int8_t>(a, b, c, M, N, K, lda, ldb, st);
  }
  return int(cudaErrorInvalidValue);
}

// _mm_dual on f32 (int8 and bf16 run on mm_tc_kernels.cu); the layout of
// cnn_matmul's operands.
int cnn_matmul_dual(int dtype, const void* a1, const void* a2, const void* b,
                    void* c1, void* c2, int M, int N, int K, int lda, int ldb,
                    void* stream) {
  if (dtype != mm::kF32) return int(cudaErrorInvalidValue);
  return mm::launch_tiles<mm::MxuDual>(
      mm::mm_dual_f32_kernel, M, N, cudaStream_t(stream), (const float*)a1,
      (const float*)a2, (const float*)b, (float*)c1, (float*)c2, M, N, K, lda,
      ldb);
}

}  // extern "C"
