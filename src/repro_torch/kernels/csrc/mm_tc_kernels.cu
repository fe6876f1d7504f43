// The tensor-core matmul kernels of the port: the MXU members of the
// matmul family on int8 and bf16 operands, loaded with ctypes by
// src/repro_torch/kernels/cuda.py.  f32 operands stay on mm_kernels.cu's
// CUDA-core tile body (Hopper has no IEEE-f32 MMA, and TF32 misses the
// reference tolerance); mm_vpu stays there on every dtype (no MMA).
//
// mm_tc_mxu_{i8,bf16}_kernel   replace src/repro/kernels/matmul/mxu.py::mm_mxu
// mm_tc_dual_{i8,bf16}_kernel  replace src/repro/kernels/matmul/dual.py::_mm_dual
//
// What bounds them: 2*M*N*K operations a stream on M*K + K*N operand
// bytes.  At the LM sweep's dual FFN, 2 x (4096, 2048) x (2048, 8192),
// the tensor-core peak bounds both dtypes; at mm_mxu's FFN, (512, 2048) x
// (2048, 8192), the bf16 peak bounds bf16 and device memory (b and the
// int32 output) bounds int8.  So the design feeds wgmma from a ring of
// shared-memory stages and reads every operand byte from L2 once per CTA:
//
// - One tile body, mm_tc_body<T, NS>, for both members.  A CTA owns 256
//   output columns and stages, per k-step of 128 bytes of K (64 bf16 or
//   128 int8), 128 rows of a and ONE 128-byte-deep b tile in a ring of
//   shared-memory stages (48 KB each; 4 for bf16, 3 for int8).  NS=1
//   (mm_mxu): the 128 rows are one a's; NS=2 (mm_dual): 64 rows of a1,
//   then the same 64 rows of a2, so both streams read the one b tile, as
//   the reference's one b load per grid step feeds two dots.  (Either
//   way a b tile feeds 128 output rows: the accumulator registers cap
//   that, so the dual kernel moves the bytes of two mm_mxu launches.)
// - Three warpgroups.  Warpgroup 2 is the producer: it fills a stage
//   under the stage's "full" mbarrier and refills it once both consumers
//   have arrived on its "empty" mbarrier.  Warpgroups 0 and 1 are the
//   consumers: each takes one 64-row half of the staged a rows (NS=1: the
//   two halves of a; NS=2: one stream each) and issues
//   wgmma.mma_async m64n256 (k16 bf16 with an f32 accumulator; k32 s8
//   with an int32 accumulator, exact and wrapping) against the shared b
//   tile, keeping one k-step of wgmma in flight.  Each output so sees
//   the same instruction, the same k-chunk order and the same
//   accumulator in both members, so a dual stream equals an mm_mxu
//   launch bitwise.
// - a is K-major already and goes into the stage with cp.async (zero
//   fill past the edges).  wgmma transposes 16-bit B itself, so bf16 b
//   goes in with cp.async too, MN-major as it lies in memory.  8-bit
//   wgmma takes B only K-major, and b is (K, N) row-major, so int8 b is
//   transposed on its way in: cp.async brings each k-step's b tile as it
//   lies into one of two raw tiles, two k-steps ahead, so the copies'
//   latency hides behind the transposes of the steps before; then each
//   producer thread reads a 16 k x 16 n block of the raw tile, transposes
//   it in registers with prmt and stores the 16 columns' 16-byte k-runs
//   (st.shared, then fence.proxy.async).  That costs shared-memory
//   bandwidth (the b tile crosses shared memory three times) and three
//   stages instead of four.  Every tile lands in the 128-byte-swizzled
//   layout its wgmma descriptor declares, under the stage's one "full"
//   mbarrier.
// - Ragged M and N are masked (loads zero-filled, stores skipped); the
//   wrapper pads K and b's row stride to 16 bytes (kernels/matmul/mxu.py
//   ::pad_tc_operands), so every 16-byte run is wholly in or out.
// - Epilogue: the accumulators go straight to the (M, N) output in the
//   accumulator dtype, two neighbouring columns a store.
// The mbarrier, cp.async, swizzle, descriptor and wgmma helpers are
// tc_device.cuh's, shared with attn_tc_kernels.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_device.cuh"

namespace mmtc {

using namespace tc;

enum DType { kI8 = 1, kBF16 = 4 };   // codes of cnn_kernels.cu

constexpr int kRowBytes = 128;                 // K bytes per k-step
constexpr int kRows = 128;                     // a rows staged per k-step
constexpr int kCols = 256;                     // output columns per CTA
constexpr int kABytes = kRows * kRowBytes;     // 16 KB
constexpr int kBBytes = kCols * kRowBytes;     // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kThreads = 384;                  // 2 consumer + 1 producer WG
constexpr int kConsumerWarps = 8;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = int32_t; };

// barrier of the producer warpgroup alone (named barrier 1)
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint32_t x,
                                            uint32_t y, uint32_t z,
                                            uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(x), "r"(y), "r"(z), "r"(w)
               : "memory");
}

#define MM_D128                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"
#define MM_ACC4(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3])
#define MM_ACC32(C, i)                                                      \
  MM_ACC4(C, i), MM_ACC4(C, i + 4), MM_ACC4(C, i + 8), MM_ACC4(C, i + 12),  \
      MM_ACC4(C, i + 16), MM_ACC4(C, i + 20), MM_ACC4(C, i + 24),           \
      MM_ACC4(C, i + 28)
#define MM_ACC128(C) \
  MM_ACC32(C, 0), MM_ACC32(C, 32), MM_ACC32(C, 64), MM_ACC32(C, 96)

// d (64 x 256, f32) = a (64 x 16 bf16, K-major) . b (16 x 256 bf16,
// MN-major) + (accumulate ? d : 0)
__device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " MM_D128
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : MM_ACC128("+f")
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256, s32) = a (64 x 32 s8) . b (32 x 256 s8), both K-major (the
// only layout 8-bit wgmma takes), + (accumulate ? d : 0)
__device__ __forceinline__ void mma(int32_t (&d)[128], uint64_t da,
                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " MM_D128
      ", %128, %129, p;\n}\n"
      : MM_ACC128("+r")
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(int32_t* p, int32_t x, int32_t y) {
  *reinterpret_cast<int2*>(p) = make_int2(x, y);
}

// The producer's b tile of a k-step (K rows k0 .. of b (K, ldb), 256
// columns from n0) and its wgmma descriptor for k-chunk kk (32 bytes of
// K).  wgmma transposes 16-bit B itself, so bf16 b is staged MN-major as
// it lies in memory; 8-bit B it takes only K-major, so int8 b is
// transposed on its way in.
template <typename T> struct BTile;

template <> struct BTile<__nv_bfloat16> {
  // 64 k x 256 n, MN-major: 4 blocks of 64 columns, each 64 k rows of
  // 128 bytes (8 KB) under the 128-byte swizzle, filled by cp.async
  static constexpr int kStages = 4;
  static constexpr int kRaw = 0;
  static constexpr int kRawBytes = 0;
  static constexpr int kBlockBytes = 64 * kRowBytes;
  __device__ static void load(const __nv_bfloat16* b, uint32_t sb, int k0,
                              int n0, int K, int ldb, int t) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int e = t + 128 * j, k = e >> 5, chunk = e & 31;
      const int gk = k0 + k, gn = n0 + chunk * 8;
      const bool ok = gk < K && gn < ldb;
      cp_async16(sb + (chunk >> 3) * kBlockBytes + swizzled(k, chunk & 7),
                 ok ? b + size_t(gk) * ldb + gn : b, ok);
    }
  }
  __device__ static uint64_t desc(uint32_t sb, int kk) {   // 16 k rows a kk
    return desc_sw128(sb + kk * 16 * kRowBytes, kBlockBytes);
  }
};

template <> struct BTile<int8_t> {
  // 128 k x 256 n, K-major: 256 rows of 128 bytes (k) under the 128-byte
  // swizzle.  b's tile of a k-step first lands as it lies in memory in a
  // raw tile (128 rows of 256 bytes, chunk c of row k at c ^ (k / 16) % 8,
  // so both the copies in and the reads below are free of bank
  // conflicts), kRaw k-steps ahead by cp.async.  Then a thread reads a
  // 16 k x 16 n block of it as 16-byte rows (8 x 16 blocks, one a
  // thread), transposes it in registers with prmt and stores the 16
  // columns' 16-byte k-runs into the stage.
  static constexpr int kStages = 3;
  static constexpr int kRaw = 2;
  static constexpr int kRawBytes = 128 * 256;
  static constexpr int kBlock = 16;
  __device__ static uint32_t raw_at(int k, int chunk) {
    return uint32_t(k * 256 + ((chunk ^ ((k >> 4) & 7)) << 4));
  }
  __device__ static void fetch(const int8_t* b, uint32_t raw, int k0, int n0,
                               int K, int ldb, int t) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int e = t + 128 * j, k = e >> 4, chunk = e & 15;
      const int gk = k0 + k, gn = n0 + chunk * 16;
      const bool ok = gk < K && gn < ldb;
      cp_async16(raw + raw_at(k, chunk), ok ? b + size_t(gk) * ldb + gn : b,
                 ok);
    }
  }
  __device__ static void transpose(uint32_t raw, uint32_t sb, int t) {
    const int lane = t & 31, warp = t >> 5, kb = lane & 7;
    const int nb = (lane >> 3) + 4 * warp;
    uint32_t in[kBlock][4];
#pragma unroll
    for (int r = 0; r < kBlock; ++r) {
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(in[r][0]), "=r"(in[r][1]), "=r"(in[r][2]),
                     "=r"(in[r][3])
                   : "r"(raw + raw_at(kb * kBlock + r, nb))
                   : "memory");
    }
    // word q of each row holds columns 4q .. 4q+3; a 4 x 4 byte transpose
    // of rows 4g .. 4g+3 gives word g of those four columns' k-runs
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t o[4][4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const uint32_t t0 = __byte_perm(in[4 * g][q], in[4 * g + 1][q], 0x5140);
        const uint32_t t1 = __byte_perm(in[4 * g][q], in[4 * g + 1][q], 0x7362);
        const uint32_t t2 =
            __byte_perm(in[4 * g + 2][q], in[4 * g + 3][q], 0x5140);
        const uint32_t t3 =
            __byte_perm(in[4 * g + 2][q], in[4 * g + 3][q], 0x7362);
        o[0][g] = __byte_perm(t0, t2, 0x5410);
        o[1][g] = __byte_perm(t0, t2, 0x7632);
        o[2][g] = __byte_perm(t1, t3, 0x5410);
        o[3][g] = __byte_perm(t1, t3, 0x7632);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st_shared16(sb + swizzled(nb * kBlock + 4 * q + i, kb), o[i][0],
                    o[i][1], o[i][2], o[i][3]);
      }
    }
  }
  __device__ static uint64_t desc(uint32_t sb, int kk) {   // 32 k a kk
    return desc_sw128(sb + kk * 32);
  }
};

// The tile body of both members: NS streams a[s] (M, K) against one
// b (K, ldb) into c[s] (M, N).  K and ldb are multiples of 16 bytes.
template <typename T, int NS>
__device__ __forceinline__ void mm_tc_body(const T* a0, const T* a1,
                                           const T* __restrict__ b,
                                           typename Acc<T>::type* c0,
                                           typename Acc<T>::type* c1, int M,
                                           int N, int K, int ldb) {
  using A = typename Acc<T>::type;
  constexpr int kElems = 16 / int(sizeof(T));        // per 16 bytes
  constexpr int kStepK = kRowBytes / int(sizeof(T)); // K per k-step
  constexpr int kHalf = kRows / 2;                   // rows a consumer
  constexpr int kStages = BTile<T>::kStages, kRaw = BTile<T>::kRaw;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~uint32_t(1023);
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * (kRows / NS);   // first row of each stream
  const int steps = (K + kStepK - 1) / kStepK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 2 * 128);           // cp.async + st.shared arrivals
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: a by cp.async (already K-major), b by BTile: bf16 by
    // cp.async into the stage; int8 by cp.async into raw tiles kRaw
    // k-steps ahead (one cp.async group a k-step), then transposed
    const uint32_t raw = base + kStages * kStageBytes;
    if constexpr (kRaw > 0) {
      for (int p = 0; p < kRaw; ++p) {
        if (p < steps) {
          BTile<T>::fetch(b, raw + p * BTile<T>::kRawBytes, p * kStepK, n0,
                          K, ldb, t);
        }
        cp_async_commit();
      }
    }
    for (int step = 0; step < steps; ++step) {
      const int s = step % kStages;
      mbar_wait(&empty[s], ((step / kStages) & 1) ^ 1);
      const int k0 = step * kStepK;
      const uint32_t sa = base + s * kStageBytes, sb = sa + kABytes;
#pragma unroll
      for (int j = 0; j < kRows * 8 / 128; ++j) {
        const int e = t + 128 * j, r = e >> 3, chunk = e & 7;
        const int gm = m0 + (NS == 1 ? r : (r & (kHalf - 1)));
        const T* src = (NS == 1 || r < kHalf) ? a0 : a1;
        const int gk = k0 + chunk * kElems;
        const bool ok = gm < M && gk < K;
        cp_async16(sa + swizzled(r, chunk),
                   ok ? src + size_t(gm) * K + gk : a0, ok);
      }
      if constexpr (kRaw == 0) {
        BTile<T>::load(b, sb, k0, n0, K, ldb, t);
        cp_async_arrive(&full[s]);   // once this thread's copies land
      } else {
        cp_async_arrive(&full[s]);   // a's copies (and earlier raw tiles)
        const uint32_t r = raw + (step % kRaw) * BTile<T>::kRawBytes;
        cp_async_wait<kRaw - 1>();   // this step's raw tile has landed
        producer_sync();             // ... every thread's part of it
        BTile<T>::transpose(r, sb, t);
        producer_sync();             // every thread is done reading it
        if (step + kRaw < steps) {
          BTile<T>::fetch(b, r, k0 + kRaw * kStepK, n0, K, ldb, t);
        }
        cp_async_commit();
        fence_async_shared();        // the st.shared of the transposed b
      }
      mbar_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // consumers: warpgroup wg takes staged rows 64 wg .. 64 wg + 63
  // (the first k-chunk overwrites acc: no zero fill inside the pipeline)
  A acc[128];
  fence_acc(acc);
  for (int step = 0; step < steps; ++step) {
    const int s = step % kStages;
    mbar_wait(&full[s], (step / kStages) & 1);
    fence_async_shared();
    const uint32_t sa = base + s * kStageBytes + wg * kHalf * kRowBytes;
    const uint32_t sb = base + s * kStageBytes + kABytes;
    const uint64_t da = desc_sw128(sa);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowBytes / 32; ++kk) {   // 32 bytes of K each
      mma(acc, da + 2 * kk, BTile<T>::desc(sb, kk), step | kk);
    }
    wgmma_commit();
    wgmma_wait<1>();                 // the previous step's wgmmas are done
    fence_acc(acc);
    if (step > 0 && (t & 31) == 0) {
      mbar_arrive(&empty[(step - 1) % kStages]);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (steps == 0) {
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = A(0);
  }

  // epilogue: accumulator i of thread t is row 16 (t / 32) + (t % 32) / 4
  // + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i % 2
  A* c = (NS == 2 && wg == 1) ? c1 : c0;
  const int row0 = m0 + (NS == 1 ? wg * kHalf : 0) + 16 * (t >> 5) +
                   ((t & 31) >> 2);
  const int col0 = n0 + 2 * (t & 3);
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = col0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M || col >= N) continue;
      A* p = c + size_t(row) * N + col;
      const A v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs) {
        store2(p, v0, v1);
      } else {
        p[0] = v0;
        if (col + 1 < N) p[1] = v1;
      }
    }
  }
}

#define MM_TC_KERNEL(NAME, T, NS)                                           \
  __global__ void __launch_bounds__(kThreads, 1)                            \
      NAME(const T* a0, const T* a1, const T* __restrict__ b,               \
           typename Acc<T>::type* c0, typename Acc<T>::type* c1, int M,     \
           int N, int K, int ldb) {                                         \
    mm_tc_body<T, NS>(a0, a1, b, c0, c1, M, N, K, ldb);                     \
  }

MM_TC_KERNEL(mm_tc_mxu_i8_kernel, int8_t, 1)
MM_TC_KERNEL(mm_tc_mxu_bf16_kernel, __nv_bfloat16, 1)
MM_TC_KERNEL(mm_tc_dual_i8_kernel, int8_t, 2)
MM_TC_KERNEL(mm_tc_dual_bf16_kernel, __nv_bfloat16, 2)

template <typename T, typename Kernel>
int launch(Kernel kernel, int ns, const void* a0, const void* a1,
           const void* b, void* c0, void* c1, int M, int N, int K, int ldb,
           cudaStream_t st) {
  using A = typename Acc<T>::type;
  // the stages, the raw tiles and 1 KB to align the stages to 1024 bytes
  constexpr int kSmemBytes = BTile<T>::kStages * kStageBytes +
                             BTile<T>::kRaw * BTile<T>::kRawBytes + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();              // clear it: no later launch reads it
    return int(err);
  }
  dim3 grid((N + kCols - 1) / kCols, (M + kRows / ns - 1) / (kRows / ns));
  kernel<<<grid, kThreads, kSmemBytes, st>>>(
      (const T*)a0, (const T*)a1, (const T*)b, (A*)c0, (A*)c1, M, N, K, ldb);
  return int(cudaGetLastError());
}

}  // namespace mmtc

extern "C" {

// mm_mxu on int8 (int32 out) or bf16 (f32 out): a (M, K), b (K, ldb),
// c (M, N); K and ldb multiples of 16 bytes, N <= ldb
int mm_tc_matmul(int dtype, const void* a, const void* b, void* c, int M,
                 int N, int K, int ldb, void* stream) {
  cudaStream_t st = cudaStream_t(stream);
  if (dtype == mmtc::kI8) {
    return mmtc::launch<int8_t>(mmtc::mm_tc_mxu_i8_kernel, 1, a, a, b, c, c,
                                M, N, K, ldb, st);
  }
  if (dtype == mmtc::kBF16) {
    return mmtc::launch<__nv_bfloat16>(mmtc::mm_tc_mxu_bf16_kernel, 1, a, a,
                                       b, c, c, M, N, K, ldb, st);
  }
  return int(cudaErrorInvalidValue);
}

// _mm_dual on int8 or bf16: (a1 @ b, a2 @ b) into c1, c2, one b tile a
// k-step for both streams
int mm_tc_matmul_dual(int dtype, const void* a1, const void* a2,
                      const void* b, void* c1, void* c2, int M, int N, int K,
                      int ldb, void* stream) {
  cudaStream_t st = cudaStream_t(stream);
  if (dtype == mmtc::kI8) {
    return mmtc::launch<int8_t>(mmtc::mm_tc_dual_i8_kernel, 2, a1, a2, b, c1,
                                c2, M, N, K, ldb, st);
  }
  if (dtype == mmtc::kBF16) {
    return mmtc::launch<__nv_bfloat16>(mmtc::mm_tc_dual_bf16_kernel, 2, a1,
                                       a2, b, c1, c2, M, N, K, ldb, st);
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
