// The tensor-core flash attention of the port, on bf16 operands: one
// __global__ kernel and its plain C launcher, called by attn_flash
// (attn_kernels.cu), which keeps f32 on its CUDA-core kernel (Hopper has
// no IEEE-f32 MMA, and TF32 misses the f32 tolerance).
//
// attn_tc_flash_kernel<DP>
//   replaces src/repro/kernels/attention/flash.py::flash_attention on
//   bf16.  4*D operations per visible (query, key) pair on
//   (2*B*Hq*Sq + 2*B*Hkv*Skv)*D elements moved: the bf16 tensor-core
//   peak bounds it at training shapes, and one exponential per pair
//   (the multi-function units' rate) comes close behind.  So the
//   reference's two MXU dots per block become two wgmma products per
//   key tile, and the softmax runs on the accumulator fragments in
//   registers:
//
// - One CTA per (b * Hq + h, block of 128 query rows).  The CTAs of one
//   kv head (its GQA group's q heads, every query block) launch
//   together, so the CTAs in flight read the same K/V from L2; under
//   causal the query blocks of the last rows, which see the most keys,
//   launch first.
// - Three warpgroups.  Warpgroup 2 is the producer: it fills a ring of 3
//   K/V stages with cp.async under "full" mbarriers (K and V apart) and
//   refills a stage once the eight consumer warps have arrived on its
//   "empty" mbarrier.  Warpgroups 0 and 1 each own 64 of the query rows
//   (not two heads of one GQA group: that needs an even group and reads
//   as many K/V bytes per row).  setmaxnreg moves registers from the
//   producer (40) to the consumers (232).
// - The consumers take turns on the tensor cores (named barriers 1 and
//   2): a turn issues O += P(j) . V(j), waits for it, then issues S(j +
//   1) = Q . K(j + 1)^T into the registers P(j) held; the softmax of
//   tile j + 1 then runs while the other warpgroup's turn keeps the
//   tensor cores busy.
// - S = Q.K^T: wgmma m64nBKk16, bf16 operands from shared memory, both
//   K-major as they lie (rows of D), into f32.  The scale goes in after
//   the product: p = exp2(S * c - m * c) with c = D^-0.5 * log2(e), one
//   explicit FMA (the library builds with -fmad=false) and ex2.approx.
// - Online softmax in registers on S's accumulator fragment: a thread
//   holds two rows, and a row's max is taken across the 4 threads of a
//   quad (two shuffles); l is a per-thread partial sum until the end.
// - O += P.V with P split in two bf16 terms, P_hi = bf16(P) and P_lo =
//   bf16(P - P_hi): two wgmma m64nDk16 a 16-key chunk against the same
//   V tile into one f32 O.  P comes from registers (S's accumulator
//   layout is the A-fragment layout of a 16-key chunk), V (keys, D) is
//   MN-major as it lies and goes in with the transpose bit.  P rounded
//   once to bf16 misses rtol=1e-2 at attn_train4k; the split keeps P
//   to about 2^-17 of its value.  The tensor work is 1.5x the
//   function's 4 D operations a pair.
// - Masks only on the key tiles that cross the causal diagonal or the
//   end of Skv (masked scores -1e30, as the reference); a warpgroup
//   stops at the last key its rows see.  cp.async zero-fills rows past
//   Skv / Sq and, for D = 16 and 32, the columns up to 64: the padded
//   products are exact zeros and the padded O columns are never
//   written.  Rows that see no key are written as 0.
// - Tiles: 128-byte swizzled rows of 64 bf16.  DP = 64 (D <= 64): Q 16
//   KB, 128-key K/V tiles of 16 KB.  DP = 128: two column blocks, Q 32
//   KB, 64-key tiles of 16 KB (128 keys would not fit S, P_hi, P_lo and
//   O in a consumer's registers).
// - Head dims past 128 (DP = 256, 384; the wrapper zero-pads D to one of
//   them): a grid axis over 128-wide column blocks of V and O (DV = 128).
//   Each CTA computes the whole S = Q.K^T over every column of D, runs
//   the same online softmax, and accumulates only its 128 columns of O,
//   so O's registers and V's tile are those of DP = 128 and only Q and K
//   grow.  The column blocks of one (head, query block) launch next to
//   each other and read the same Q and K from L2.  S is recomputed in
//   each column block: the tensor work is (2 DP + 4 DV) x DP / DV
//   operations a visible pair, against the function's 4 D.  DP = 256:
//   Q 64 KB, 64-key K tiles of 32 KB and V halves of 16 KB, 3 stages,
//   209 KB; DP = 384: Q 96 KB, K tiles of 48 KB, 2 stages, 225 KB.
// - Head dims past 384 (attn_tc_flash_kernel<0, 128>, the chunked
//   instance; the wrapper zero-pads D to a multiple of 128): the whole Q
//   no longer fits beside two K stages, so D is a runtime count of
//   128-column chunks.  Each CTA keeps one 128-column block of O and V,
//   as at 256 and 384.  A stage of the ring holds one chunk of Q (its
//   128 rows, 32 KB) and the same chunk of a K tile (16 KB), 3 stages; V
//   has a ring of its own (2 x 16 KB), 177 KB in all.  S = Q.K^T
//   accumulates over the chunks: the wgmma k-steps of each chunk add into
//   the same S registers, and a chunk's stage is released as soon as its
//   products are done.  Q is re-read (from L2) once a key tile.  The
//   warpgroups take no turns here: each waits on every chunk of a tile,
//   and a turn held across those waits would stall the other warpgroup
//   on a stage they share.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_device.cuh"

namespace attntc {

using namespace tc;

constexpr float kMasked = -1e30f;     // the reference's _NEG_INF
constexpr float kMinNorm = 1e-30f;    // l clamp before the division
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 128;            // query rows per CTA, 64 a consumer
constexpr int kThreads = 384;         // 2 consumer + 1 producer warpgroup
constexpr int kConsumerWarps = 8;

// DP: the width of Q and K a CTA stages; DV: the columns of V and O it
// owns (DP itself up to 128, else one of DP / DV column blocks).
template <int DP, int DV> struct Cfg {
  static constexpr int kBk = DP == 64 ? 128 : 64;
  static constexpr int kStages = DP > 256 ? 2 : 3;       // K/V ring depth
  static constexpr int kColBlocks = DP / DV;
  static constexpr int kQBlock = kRows * kSwizzleRow;   // a 64-column block
  static constexpr int kKVBlock = kBk * kSwizzleRow;
  static constexpr int kQBytes = DP / 64 * kQBlock;
  static constexpr int kKBytes = DP / 64 * kKVBlock;     // one K tile
  static constexpr int kVBytes = DV / 64 * kKVBlock;     // one V tile
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kSmem = kQBytes + kStages * kStageBytes + 1024;
  static_assert(DP % DV == 0 && DV <= 128, "whole column blocks");
  static_assert(kSmem <= 227 * 1024 - 64, "a block's shared memory");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

#define AT_R32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define AT_R64                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"
#define AT_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define AT_ACC16(i) AT_ACC4(i), AT_ACC4(i + 4), AT_ACC4(i + 8), AT_ACC4(i + 12)
#define AT_ACC32(i) AT_ACC16(i), AT_ACC16(i + 16)
#define AT_ACC64 AT_ACC32(0), AT_ACC32(32)

// d (64 x N keys, f32) = q (64 x 16, K-major) . k^T (16 x N, K-major)
// + (accumulate ? d : 0)
__device__ __forceinline__ void mma_qk(float (&d)[32], uint64_t dq,
                                       uint64_t dk, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AT_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : AT_ACC32(0)
      : "l"(dq), "l"(dk), "r"(accumulate));
}
__device__ __forceinline__ void mma_qk(float (&d)[64], uint64_t dq,
                                       uint64_t dk, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " AT_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : AT_ACC64
      : "l"(dq), "l"(dk), "r"(accumulate));
}

// d (64 x DP, f32) += p (64 x 16 keys, registers) . v (16 x DP, MN-major)
__device__ __forceinline__ void mma_pv(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t dv, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AT_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : AT_ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(dv),
        "r"(accumulate));
}
__device__ __forceinline__ void mma_pv(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t dv, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " AT_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : AT_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(dv),
        "r"(accumulate));
}

// The two consumer warpgroups take turns to issue their wgmmas, so one's
// softmax runs while the other's products keep the tensor cores busy:
// named barrier 1 + w is warpgroup w's turn (both warpgroups count).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
}

// Stage rows row0 .. row0 + ROWS - 1 of COLS columns of one head's
// (S, ld) slice as 64-column blocks of ROWS swizzled 128-byte rows; rows
// at or past S and columns at or past D are zero-filled.  Thread t of
// the producer.  Rows wider than 128 columns (or ROLL) are copied in a
// rolled loop: unrolled, their 16-48 copies' addresses outgrow the
// kernel's 168 registers (ptxas spilled up to 1 KB).
template <int COLS, int ROWS, bool ROLL = (COLS > 128)>
__device__ __forceinline__ void stage_rows(uint32_t dst,
                                           const __nv_bfloat16* src, int row0,
                                           int S, int D, int ld, int t) {
  constexpr int kChunks = COLS / 8;   // 16-byte chunks a row
  auto copy = [&](int j) {
    const int e = t + 128 * j, r = e / kChunks, c = e % kChunks;
    const int gr = row0 + r;
    const bool ok = gr < S && c * 8 < D;
    cp_async16(dst + (c >> 3) * (ROWS * kSwizzleRow) + swizzled(r, c & 7),
               ok ? src + size_t(gr) * ld + c * 8 : src, ok);
  };
  if constexpr (!ROLL) {
#pragma unroll
    for (int j = 0; j < ROWS * kChunks / 128; ++j) copy(j);
  } else {
#pragma unroll 1
    for (int j = 0; j < ROWS * kChunks / 128; ++j) copy(j);
  }
}

template <int DP, int DV>
__global__ void __launch_bounds__(kThreads, 1)
attn_tc_flash_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Sq,
                     int Skv, int D, int causal, float scale) {
  using C = Cfg<DP, DV>;
  constexpr int kBk = C::kBk, kStages = C::kStages, NCB = C::kColBlocks;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, k_full[kStages], v_full[kStages],
      empty[kStages];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~uint32_t(1023);
  const uint32_t stages = sq + C::kQBytes;   // stage s: K, then V
  // blockIdx.y = b * Hkv + kv head; blockIdx.x runs over the query blocks
  // (the last first under causal: they see the most keys), then the
  // group's q heads and, fastest, the column blocks of O, so the CTAs in
  // flight share their Q and K/V in L2
  const int group = Hq / Hkv;
  const int cb = NCB == 1 ? 0 : blockIdx.x % NCB;     // column block of O
  const int xq = NCB == 1 ? blockIdx.x : blockIdx.x / NCB;
  const int col0 = cb * DV;
  const int kvh = blockIdx.y;                          // b * Hkv + kv head
  const int bh = kvh * group + xq % group;             // b * Hq + q head
  const int nqb = gridDim.x / NCB / group;
  const int qb = causal ? nqb - 1 - xq / group : xq / group;
  const int q0 = qb * kRows, offs = Skv - Sq;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  // key tiles that rows r0 .. r0 + 63 see (key j <= i + offs)
  auto tiles = [&](int r0) {
    const int end = causal ? min(Skv, r0 + 64 + offs) : Skv;
    return end > 0 ? (end + kBk - 1) / kBk : 0;
  };
  const int n_cta = tiles(q0 + 64);          // the producer loads these

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 128);                 // one cp.async arrival a thread
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 128);
      mbar_init(&v_full[s], 128);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const __nv_bfloat16* kh = k + size_t(kvh) * Skv * D;
  const __nv_bfloat16* vh = v + size_t(kvh) * Skv * D;

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (n_cta > 0) {
      stage_rows<DP, kRows>(sq, q + size_t(bh) * Sq * D, q0, Sq, D, D, t);
      cp_async_arrive(&q_full);
    }
    const int dv = min(DV, D - col0);        // V columns that exist
    for (int j = 0; j < n_cta; ++j) {
      const int s = j % kStages;
      mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
      const uint32_t sk = stages + s * C::kStageBytes;
      stage_rows<DP, kBk>(sk, kh, j * kBk, Skv, D, D, t);
      cp_async_arrive(&k_full[s]);
      stage_rows<DV, kBk>(sk + C::kKBytes, vh + col0, j * kBk, Skv, dv, D,
                          t);
      cp_async_arrive(&v_full[s]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  // consumer warpgroup wg: rows r0 .. r0 + 63; accumulator element i of
  // thread t is row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column
  // 8 (i / 4) + 2 (t % 4) + i % 2 (rows "a" and "b" below)
  const int lane = t & 31;
  const int r0 = q0 + 64 * wg;
  const int n_mine = tiles(r0);
  const int row_a = r0 + 16 * (t >> 5) + (lane >> 2), row_b = row_a + 8;
  const float c = __fmul_rn(scale, kLog2e);
  const uint32_t sqa = sq + wg * 64 * kSwizzleRow;
  float acc[DV / 2];
  // P of 16-key chunk cc as A fragments: register r holds the pair
  // i = 8 cc + 2 r, 8 cc + 2 r + 1 of S (row b when r is odd)
  uint32_t p_hi[kBk / 16][4], p_lo[kBk / 16][4];
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;
  float alpha_a = 1.f, alpha_b = 1.f;

  // S (sc) is a fresh array a tile, so it is not live across the loop
  auto issue_s = [&](float (&sc)[kBk / 2], int j) {   // S(j) = Q . K(j)^T
    const uint32_t sk = stages + (j % kStages) * C::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {   // 16 of D a wgmma
      mma_qk(sc,
             desc_sw128(sqa + (kk >> 2) * C::kQBlock + (kk & 3) * 32),
             desc_sw128(sk + (kk >> 2) * C::kKVBlock + (kk & 3) * 32), kk);
    }
  };
  auto softmax = [&](float (&sc)[kBk / 2], int j) {   // -> m, l, alpha, P(j)
    const int k0 = j * kBk;
    if (k0 + kBk > Skv || (causal && k0 + kBk - 1 > r0 + offs)) {
#pragma unroll
      for (int i = 0; i < kBk / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        const int row = (i & 2) ? row_b : row_a;
        if (col >= Skv || (causal && col > row + offs)) sc[i] = kMasked;
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int i = 0; i < kBk / 2; ++i) {
      if (i & 2) {
        mx_b = fmaxf(mx_b, sc[i]);
      } else {
        mx_a = fmaxf(mx_a, sc[i]);
      }
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
    }
    alpha_a = ex2(__fmul_rn(__fsub_rn(m_a, mx_a), c));
    alpha_b = ex2(__fmul_rn(__fsub_rn(m_b, mx_b), c));
    m_a = mx_a;
    m_b = mx_b;
    const float mc_a = __fmul_rn(m_a, c), mc_b = __fmul_rn(m_b, c);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int cc = 0; cc < kBk / 16; ++cc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * cc + 2 * r;
        const float mc = (r & 1) ? mc_b : mc_a;
        const float p0 = ex2(__fmaf_rn(sc[i], c, -mc));
        const float p1 = ex2(__fmaf_rn(sc[i + 1], c, -mc));
        if (r & 1) {
          sum_b = __fadd_rn(sum_b, __fadd_rn(p0, p1));
        } else {
          sum_a = __fadd_rn(sum_a, __fadd_rn(p0, p1));
        }
        // P_hi = bf16(P); P - P_hi is exact in f32; P_lo = bf16(P - P_hi)
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[cc][r] = pack(hi);
        p_lo[cc][r] = pack(__floats2bfloat162_rn(__fsub_rn(p0, hf.x),
                                                 __fsub_rn(p1, hf.y)));
      }
    }
    l_a = __fmaf_rn(l_a, alpha_a, sum_a);
    l_b = __fmaf_rn(l_b, alpha_b, sum_b);
  };

  // Per tile j one turn runs O += P(j) . V(j), then S(j + 1) = Q . K(j +
  // 1)^T (into S's registers, which P(j)'s free); the softmax of tile j + 1
  // then runs while the other warpgroup's turn keeps the tensor cores busy.
  if (wg == 1) turn_pass(wg);                // warpgroup 0 goes first
  if (n_mine > 0) {
    mbar_wait(&q_full, 0);
    mbar_wait(&k_full[0], 0);
    float sc[kBk / 2];
    turn_wait(wg);
    wgmma_fence();
    issue_s(sc, 0);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_acc(sc);
    softmax(sc, 0);
  }
  for (int j = 0; j < n_mine; ++j) {
    const int s = j % kStages;
    const bool next = j + 1 < n_mine;
    mbar_wait(&v_full[s], (j / kStages) & 1);
    if (next) {
      mbar_wait(&k_full[(j + 1) % kStages], ((j + 1) / kStages) & 1);
    }
    if (j > 0) {
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) {
        acc[i] = __fmul_rn(acc[i], (i & 2) ? alpha_b : alpha_a);
      }
    }
    fence_acc(acc);
    turn_wait(wg);
    wgmma_fence();
    const uint32_t sv = stages + s * C::kStageBytes + C::kKBytes;
#pragma unroll
    for (int cc = 0; cc < kBk / 16; ++cc) {  // 16 keys a wgmma pair
      const uint64_t dv = desc_sw128(sv + cc * 16 * kSwizzleRow,
                                     C::kKVBlock);
      mma_pv(acc, p_hi[cc], dv, j > 0 || cc > 0);
      mma_pv(acc, p_lo[cc], dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    wgmma_fence();
    float sc[kBk / 2];
    issue_s(sc, next ? j + 1 : j);   // (the last tile's S again, unused:
                                     // a wgmma on a branch serializes all)
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_acc(sc);
    if (lane == 0) mbar_arrive(&empty[s]);
    if (next) softmax(sc, j + 1);
  }

  // warpgroup 0 may see one tile fewer: it passes warpgroup 1 the turns
  // it does not take and releases the stage of that tile
  const int turns = n_mine > 0 ? n_mine + 1 : 0;
  const int turns_cta = n_cta > 0 ? n_cta + 1 : 0;
  for (int x = turns; x < turns_cta; ++x) {
    turn_wait(wg);
    turn_pass(wg);
  }
  for (int j = n_mine; j < n_cta; ++j) {
    const int s = j % kStages;
    mbar_wait(&v_full[s], (j / kStages) & 1);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: l summed over the quad; rows that see no key are 0
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l_a = __fadd_rn(l_a, __shfl_xor_sync(0xffffffffu, l_a, x));
    l_b = __fadd_rn(l_b, __shfl_xor_sync(0xffffffffu, l_b, x));
  }
  const float n_a = fmaxf(l_a, kMinNorm), n_b = fmaxf(l_b, kMinNorm);
  const bool live_a = n_mine > 0 && (!causal || row_a + offs >= 0);
  const bool live_b = n_mine > 0 && (!causal || row_b + offs >= 0);
  __nv_bfloat16* oh = o + size_t(bh) * Sq * D;
#pragma unroll
  for (int i = 0; i < DV / 2; i += 2) {
    const int col = col0 + 8 * (i / 4) + 2 * (lane & 3);
    const bool b = i & 2;
    const int row = b ? row_b : row_a;
    if (row >= Sq || col >= D) continue;
    const bool live = b ? live_b : live_a;
    const float n = b ? n_b : n_a;
    const float x0 = live ? __fdiv_rn(acc[i], n) : 0.f;
    const float x1 = live ? __fdiv_rn(acc[i + 1], n) : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(oh + size_t(row) * D + col) =
        __floats2bfloat162_rn(x0, x1);
  }
  if (wg == 0) turn_wait(wg);                // warpgroup 1's last pass
}

template <int DP, int DV = DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, int causal, float scale,
           cudaStream_t st) {
  constexpr int kSmem = Cfg<DP, DV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      attn_tc_flash_kernel<DP, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) {
    cudaGetLastError();              // clear it: no later launch reads it
    return int(err);
  }
  dim3 grid((Sq + kRows - 1) / kRows * (Hq / Hkv) * Cfg<DP, DV>::kColBlocks,
            B * Hkv);
  attn_tc_flash_kernel<DP, DV><<<grid, kThreads, kSmem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Hq, Hkv, Sq, Skv, D, causal,
      scale);
  return int(cudaGetLastError());
}

// The chunked instance (head dims past 384, D a runtime multiple of 128):
// a stage of the ring holds one 128-column chunk of Q (all 128 rows) and
// the same chunk of a 64-key K tile; V's tile of the CTA's column block
// has a ring of its own.
struct ChunkCfg {
  static constexpr int kBk = 64, kStages = 3, kVStages = 2;
  static constexpr int kQBlock = kRows * kSwizzleRow;    // a 64-column block
  static constexpr int kKVBlock = kBk * kSwizzleRow;
  static constexpr int kQBytes = 2 * kQBlock;            // 32 KB
  static constexpr int kKBytes = 2 * kKVBlock;           // 16 KB
  static constexpr int kVBytes = 2 * kKVBlock;           // 16 KB
  static constexpr int kStageBytes = kQBytes + kKBytes;
  static constexpr int kSmem =
      kStages * kStageBytes + kVStages * kVBytes + 1024;
  static_assert(kSmem <= 227 * 1024 - 64, "a block's shared memory");
};

// attn_tc_flash_kernel<0, 128>: the same CTA (b * Hkv + kv head, query
// block, column block of O), warpgroups, masks, softmax and P.V as the
// other instances; S(j) is accumulated over the D / 128 chunks of Q and
// K(j) as they come through the ring.  The warpgroups take no turns:
// each waits on every chunk of a tile, and a turn held across those waits
// would stall the other warpgroup on a stage they share.  An explicit
// specialization, not branches of the template: folded into it, the
// chunked path spilled 372 bytes and moved the other instances' register
// allocation (4 more bytes spilled in the 64- and 128-wide ones).
template <>
__global__ void __launch_bounds__(kThreads, 1)
attn_tc_flash_kernel<0, 128>(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
                             int Sq, int Skv, int D, int causal,
                             float scale) {
  using C = ChunkCfg;
  constexpr int kBk = C::kBk, kStages = C::kStages, kVStages = C::kVStages;
  constexpr int DV = 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t k_full[kStages], empty[kStages], v_full[kVStages],
      v_empty[kVStages];
  const uint32_t stages = (smem_u32(smem_raw) + 1023) & ~uint32_t(1023);
  const uint32_t vring = stages + kStages * C::kStageBytes;
  const int nc = D / 128;                       // chunks, column blocks
  const int group = Hq / Hkv;
  const int cb = blockIdx.x % nc;               // column block of O
  const int xq = blockIdx.x / nc;
  const int col0 = cb * DV;
  const int kvh = blockIdx.y;                   // b * Hkv + kv head
  const int bh = kvh * group + xq % group;      // b * Hq + q head
  const int nqb = gridDim.x / nc / group;
  const int qb = causal ? nqb - 1 - xq / group : xq / group;
  const int q0 = qb * kRows, offs = Skv - Sq;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  auto tiles = [&](int r0) {
    const int end = causal ? min(Skv, r0 + 64 + offs) : Skv;
    return end > 0 ? (end + kBk - 1) / kBk : 0;
  };
  const int n_cta = tiles(q0 + 64);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 128);
      mbar_init(&empty[s], kConsumerWarps);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&v_full[s], 128);
      mbar_init(&v_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    // per key tile: chunk c of Q and of K(j) into stage u % kStages (u
    // counts the chunks), then V(j)'s column block into the V ring
    const __nv_bfloat16* qh = q + size_t(bh) * Sq * D;
    const __nv_bfloat16* kh = k + size_t(kvh) * Skv * D;
    const __nv_bfloat16* vh = v + size_t(kvh) * Skv * D + col0;
    int u = 0;
    for (int j = 0; j < n_cta; ++j) {
      for (int c = 0; c < nc; ++c, ++u) {
        const int s = u % kStages;
        mbar_wait(&empty[s], ((u / kStages) & 1) ^ 1);
        const uint32_t st = stages + s * C::kStageBytes;
        stage_rows<128, kRows, true>(st, qh + c * 128, q0, Sq, 128, D, t);
        stage_rows<128, kBk, true>(st + C::kQBytes, kh + c * 128, j * kBk,
                                   Skv, 128, D, t);
        cp_async_arrive(&k_full[s]);
      }
      const int sv = j % kVStages;
      mbar_wait(&v_empty[sv], ((j / kVStages) & 1) ^ 1);
      stage_rows<DV, kBk, true>(vring + sv * C::kVBytes, vh, j * kBk, Skv,
                                DV, D, t);
      cp_async_arrive(&v_full[sv]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  // consumer warpgroup wg: rows r0 .. r0 + 63 (fragment layout as in the
  // other instances)
  const int lane = t & 31;
  const int r0 = q0 + 64 * wg;
  const int n_mine = tiles(r0);
  const int row_a = r0 + 16 * (t >> 5) + (lane >> 2), row_b = row_a + 8;
  const float c = __fmul_rn(scale, kLog2e);
  float acc[DV / 2];
  uint32_t p_hi[kBk / 16][4], p_lo[kBk / 16][4];
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < n_mine; ++j) {
    // S(j): the k-steps of each chunk add into the same registers; a
    // chunk's stage is released as soon as its products are done
    float sc[kBk / 2];
#pragma unroll 1
    for (int cc = 0; cc < nc; ++cc) {
      const int u = j * nc + cc, s = u % kStages;
      mbar_wait(&k_full[s], (u / kStages) & 1);
      const uint32_t st = stages + s * C::kStageBytes;
      const uint32_t qa = st + wg * 64 * kSwizzleRow;
      const uint32_t ka = st + C::kQBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {          // 16 of the chunk a wgmma
        mma_qk(sc, desc_sw128(qa + (kk >> 2) * C::kQBlock + (kk & 3) * 32),
               desc_sw128(ka + (kk >> 2) * C::kKVBlock + (kk & 3) * 32),
               cc > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the online softmax step on S(j) -> m, l, alpha, P(j)
    const int k0 = j * kBk;
    if (k0 + kBk > Skv || (causal && k0 + kBk - 1 > r0 + offs)) {
#pragma unroll
      for (int i = 0; i < kBk / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        const int row = (i & 2) ? row_b : row_a;
        if (col >= Skv || (causal && col > row + offs)) sc[i] = kMasked;
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int i = 0; i < kBk / 2; ++i) {
      if (i & 2) {
        mx_b = fmaxf(mx_b, sc[i]);
      } else {
        mx_a = fmaxf(mx_a, sc[i]);
      }
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
    }
    const float alpha_a = ex2(__fmul_rn(__fsub_rn(m_a, mx_a), c));
    const float alpha_b = ex2(__fmul_rn(__fsub_rn(m_b, mx_b), c));
    m_a = mx_a;
    m_b = mx_b;
    const float mc_a = __fmul_rn(m_a, c), mc_b = __fmul_rn(m_b, c);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int cc = 0; cc < kBk / 16; ++cc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * cc + 2 * r;
        const float mc = (r & 1) ? mc_b : mc_a;
        const float p0 = ex2(__fmaf_rn(sc[i], c, -mc));
        const float p1 = ex2(__fmaf_rn(sc[i + 1], c, -mc));
        if (r & 1) {
          sum_b = __fadd_rn(sum_b, __fadd_rn(p0, p1));
        } else {
          sum_a = __fadd_rn(sum_a, __fadd_rn(p0, p1));
        }
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[cc][r] = pack(hi);
        p_lo[cc][r] = pack(__floats2bfloat162_rn(__fsub_rn(p0, hf.x),
                                                 __fsub_rn(p1, hf.y)));
      }
    }
    l_a = __fmaf_rn(l_a, alpha_a, sum_a);
    l_b = __fmaf_rn(l_b, alpha_b, sum_b);
    // O = O alpha + P(j) . V(j)
    const int sv = j % kVStages;
    mbar_wait(&v_full[sv], (j / kVStages) & 1);
    if (j > 0) {
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) {
        acc[i] = __fmul_rn(acc[i], (i & 2) ? alpha_b : alpha_a);
      }
    }
    fence_acc(acc);
    wgmma_fence();
    const uint32_t svb = vring + sv * C::kVBytes;
#pragma unroll
    for (int cc = 0; cc < kBk / 16; ++cc) {     // 16 keys a wgmma pair
      const uint64_t dv = desc_sw128(svb + cc * 16 * kSwizzleRow,
                                     C::kKVBlock);
      mma_pv(acc, p_hi[cc], dv, j > 0 || cc > 0);
      mma_pv(acc, p_lo[cc], dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&v_empty[sv]);
  }
  // warpgroup 0 may see one tile fewer: it releases that tile's stages
  for (int j = n_mine; j < n_cta; ++j) {
    for (int cc = 0; cc < nc; ++cc) {
      const int u = j * nc + cc;
      mbar_wait(&k_full[u % kStages], (u / kStages) & 1);
      if (lane == 0) mbar_arrive(&empty[u % kStages]);
    }
    mbar_wait(&v_full[j % kVStages], (j / kVStages) & 1);
    if (lane == 0) mbar_arrive(&v_empty[j % kVStages]);
  }

  // epilogue: l summed over the quad; rows that see no key are 0
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l_a = __fadd_rn(l_a, __shfl_xor_sync(0xffffffffu, l_a, x));
    l_b = __fadd_rn(l_b, __shfl_xor_sync(0xffffffffu, l_b, x));
  }
  const float n_a = fmaxf(l_a, kMinNorm), n_b = fmaxf(l_b, kMinNorm);
  const bool live_a = n_mine > 0 && (!causal || row_a + offs >= 0);
  const bool live_b = n_mine > 0 && (!causal || row_b + offs >= 0);
  __nv_bfloat16* oh = o + size_t(bh) * Sq * D;
#pragma unroll
  for (int i = 0; i < DV / 2; i += 2) {
    const int col = col0 + 8 * (i / 4) + 2 * (lane & 3);
    const bool b = i & 2;
    const int row = b ? row_b : row_a;
    if (row >= Sq) continue;
    const bool live = b ? live_b : live_a;
    const float n = b ? n_b : n_a;
    const float x0 = live ? __fdiv_rn(acc[i], n) : 0.f;
    const float x1 = live ? __fdiv_rn(acc[i + 1], n) : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(oh + size_t(row) * D + col) =
        __floats2bfloat162_rn(x0, x1);
  }
}

int launch_chunked(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                   float scale, cudaStream_t st) {
  if (D % 128 != 0 || D < 256) return int(cudaErrorInvalidValue);
  constexpr int kSmem = ChunkCfg::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      attn_tc_flash_kernel<0, 128>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return int(err);
  }
  dim3 grid((Sq + kRows - 1) / kRows * (Hq / Hkv) * (D / 128), B * Hkv);
  attn_tc_flash_kernel<0, 128><<<grid, kThreads, kSmem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Hq, Hkv, Sq, Skv, D, causal,
      scale);
  return int(cudaGetLastError());
}

}  // namespace attntc

extern "C" {

// flash attention on bf16 q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D),
// D in {16, 32, 64, 128, 256, 384} or a multiple of 128 past 384; o like q
int attn_tc_flash(const void* q, const void* k, const void* v, void* o,
                  int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                  float scale, cudaStream_t st) {
  if (D == 16 || D == 32 || D == 64) {
    return attntc::launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                              scale, st);
  }
  if (D == 128) {
    return attntc::launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                               scale, st);
  }
  if (D == 256) {
    return attntc::launch<256, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                     causal, scale, st);
  }
  if (D == 384) {
    return attntc::launch<384, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                     causal, scale, st);
  }
  return attntc::launch_chunked(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                                scale, st);
}

}  // extern "C"
