// The CUDA-core attention kernels of the port: three __global__ kernels
// and their plain C launchers, loaded with ctypes by
// src/repro_torch/kernels/cuda.py.  bf16 flash attention runs on the
// tensor cores instead (attn_tc_kernels.cu; attn_flash hands it over).
//
// Built with the flags of cnn_kernels.cu (-fmad=false; widen and vmax
// from cnn_device.cuh, cp.async from tc_device.cuh).  q (B, Hq, Sq, D),
// k and v (B, Hkv, Skv, D) are contiguous, of one dtype: f32, or
// (decode) bf16 widened exactly to f32 on use; the output has q's dtype
// (bf16 by __float2bfloat16_rn).  q head h reads kv head h / (Hq / Hkv)
// (GQA).  Scores, softmax state and accumulators are f32, as in the
// reference: q is scaled by D^-0.5 (the f32 of the wrapper's Python
// float) before the dot, masked scores are -1e30, the normalizer is
// clamped at 1e-30.  Dots and sums are explicit __fmaf_rn / __fadd_rn
// chains on CUDA cores.  Decode merges key blocks through
// online_softmax_step (expf); the flash kernel takes the same step in
// base 2 (ex2.approx of the argument times log2(e)), which holds
// ATTN_F32_TOL.
//
// flash_attention_kernel<D>
//   replaces src/repro/kernels/attention/flash.py::flash_attention on f32
//   4*B*Hq*D operations per visible (query, key) pair on
//   (2*B*Hq*Sq + 2*B*Hkv*Skv)*D elements moved: bound by the FP32 rate
//   at training shapes (one exponential a pair is a sixteenth of it at
//   the MUFU rate).  A FlashAttention-2 schedule on the FP32 FMA pipe,
//   which issues one instruction a clock: every instruction that is not
//   an FMA costs an FMA's slot, so the design counts them.  One CTA of
//   128 threads per (b*Hq + h, block of kRows = 64 query rows), the
//   blocks with the most keys launched first, two CTAs an SM.  The
//   scaled Q block stays in shared memory for the whole key loop; K and
//   V tiles of kKeys keys (64, or 32 at D = 128) come through a
//   two-stage cp.async ring, the next tile's copies in flight while this
//   one's FMAs issue (one barrier a tile).  Both products are
//   register-tiled as mm_mxu_f32_kernel is.  S: thread (rg, cg) keeps 8
//   rows (rg + 8 i) x 4 keys (cg + 16 c), reading per 4 dims its rows' q
//   and its keys' k as 16-byte loads in K's layout as it lies ([key][d],
//   rows padded by 4 floats, so a quarter-warp's 8 keys fall in 8 bank
//   groups): 12 loads per 128 FMAs.  O += P.V: the same thread keeps the
//   same 8 rows x 8 dims over one half of the tile's keys (at D <= 64;
//   the halves' partial sums are added once, at the end), reading per 4
//   keys its rows' P and the keys' V rows as they lie: 16 loads per 256
//   FMAs.  The online softmax runs once a tile, in base 2: a row's max
//   is combined over its 16 threads by shuffles, each (row, key)
//   exponential is one MUFU.EX2 of s log2(e) - m log2(e), each thread
//   keeps its part of the row's normalizer l (summed over the 16 at the
//   end).  A thread rescales only its own rows, and the rows of P it
//   reads were written by its own warp (a __syncwarp, not a barrier).
//   Only tiles that the causal diagonal or the end of Skv crosses are
//   masked.  Keys past Skv are zero-filled by the copies and masked;
//   with causal, key j is visible to row i when j <= i + Skv - Sq, and
//   the key loop stops at the last tile any row of the block sees (the
//   reference skips the same blocks).  A row that sees no key (causal
//   with Sq > Skv) is written as 0.  No MMA instruction: Hopper has no
//   IEEE-f32 MMA, and TF32 misses the f32 tolerance.
//   Head dims past 128 (D = 256, 384; the wrapper zero-pads to them):
//   the same 64 query rows a CTA over 16 row groups of 4 rows (256
//   threads), so a thread's O is 4 rows x D / 16 dims; K/V tiles of 32
//   keys (16 at D = 384) keep Q, P and two stages within 208 KB, one
//   CTA of 8 warps an SM.  Each CTA computes S once for all of O.
//   Past 384 (flash_attention_kernel<0>, D a runtime multiple of 128):
//   neither Q nor all of O fits, so each CTA of 256 threads owns 64
//   query rows and one 128-column block of O (a grid axis), and Q and K
//   come through a two-stage ring a 128-column chunk at a time (Q's
//   chunk re-read from L2 once a key tile, scaled in shared memory by
//   the thread that copied it); each score is still one FMA chain over
//   d = 0 .. D - 1, so S is computed once a column block.
//
// flash_decode_split_kernel<T, D, GP> + decode_combine_kernel<T>
//   replace src/repro/kernels/attention/decode.py::flash_decode
//   One query token per head against the whole cache: device memory
//   bounds it (2*B*Hkv*Skv*D elements read once; about 4*group
//   operations a cache element, a fifth of the FP32 rate at group 4).
//   Split-KV: the grid is (B*Hkv x row blocks, splits); a CTA of 8 warps
//   takes up to GP = 8 rows of a kv head's GQA group (a larger group
//   takes several row blocks) against one chunk of the keys, a whole
//   number of stages long, and attn_decode_plan picks the splits from
//   Skv, the SM count and the resident CTAs an SM so that the grid's
//   last wave is at least 90% full where it can be.  The chunk streams
//   through a ring of 16-byte cp.async copies that keep K and V in their
//   own dtype (bf16 widened at use): at up to 4 rows a CTA two stages
//   (one in flight while the other is consumed) and three CTAs an SM,
//   at 8 rows three stages and two CTAs (DecodeDepth).  Every warp works
//   in every phase: each owns a slice of a stage's keys (kLanesPerKey
//   lanes a key for the scores, then the key's lanes' sums), keeps its
//   own online softmax (m, l) and its acc[GP][D] spread over its lanes
//   by dim, and the 8 warps' states merge once at the end of the chunk.
//   Past head dim 384 (<T, 0, GP>) a CTA owns one 128-column block of O
//   (a grid axis) and each stage of keys streams as 128-column units of
//   K, then its block of V (DecodeChunked); the query rows stay whole in
//   shared memory (decode_plan takes fewer GQA rows a CTA where they
//   would pass 96 KB).  Each split
//   writes its partial (m, l, acc) to a workspace the wrapper allocates;
//   decode_combine_kernel merges the splits in ascending order.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "cnn_device.cuh"
#include "tc_device.cuh"

namespace attn {

using cnn::vmax;
using cnn::widen;

enum DType { kF32 = 0, kBF16 = 4 };   // codes of cnn_kernels.cu

constexpr float kMasked = -1e30f;     // the reference's _NEG_INF
constexpr float kMinNorm = 1e-30f;    // l clamp before the division
constexpr int kDecWarps = 8;          // decode: warps a CTA
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecRows = 8;           // decode: GQA rows a CTA at most

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One step of the online softmax (flash.py:58-63, decode.py:44-49): fold
// a key block whose largest score is tile_max into the running max m and
// normalizer l.  Sets m to the new max, scales l by alpha and returns
// alpha, the factor for the running accumulator; the caller then adds
// the block's exp(s - m) to l and their v-weighted sum to the
// accumulator.
__device__ __forceinline__ float online_softmax_step(float& m, float& l,
                                                     float tile_max) {
  const float m_new = vmax(m, tile_max);
  const float alpha = expf(__fsub_rn(m, m_new));
  l = __fmul_rn(l, alpha);
  m = m_new;
  return alpha;
}

// The f32 flash kernel's tile for head dim D: a CTA of kRG row groups
// x kCG column groups; thread (rg, cg) owns rows rg + kRG i (i < RT) of
// the query block, of each K/V tile keys cg + kCG c (c < KT) for S, and
// for O += P.V the keys of split ks = cg / DG (kKS splits of the tile)
// and DT dims (dims_of, dim group dg = cg % DG): the kKS partial sums of
// O are added once, at the end.  The threads of a row group are kCG
// neighbouring lanes of one warp.  Shared memory: the scaled Q block and
// P (rows padded to kQLD and kPLD floats; P's key splits 4 floats apart,
// so the splits' reads fall in other banks), and kStages K/V tiles, K
// padded and V as it lies.  At D = 64 a CTA takes 101 KB, so two fit
// an SM.
// Past D = 128, 16 row groups of 4 rows and one CTA an SM.
template <int D> struct FlashTile {
  static constexpr int kCG = 16;                    // column groups
  static constexpr int kRG = D <= 128 ? 8 : 16;     // row groups
  static constexpr int kKeys =                      // keys a K/V tile
      D <= 64 ? 64 : D <= 256 ? 32 : 16;
  static constexpr int kKS = D <= 64 ? 2 : 1;       // key splits of P.V
  static constexpr int kCtasPerSm = D <= 128 ? 2 : 1;
  static constexpr int kStages = 2;
  static constexpr int RT = D <= 128 ? 8 : 4;       // rows a thread
  static constexpr int kRows = kRG * RT;            // query rows a CTA
  static constexpr int kThreads = kRG * kCG;
  static constexpr int KT = kKeys / kCG;            // keys a thread in S
  static constexpr int DG = kCG / kKS;              // dim groups
  static constexpr int DT = D / DG;                 // dims of O a thread
  static constexpr int kSplit = kKeys / kKS;        // keys a split
  static constexpr int kQLD = D + 4;                // Q and K row pitch
  static constexpr int kPLD = kKeys + 4 * kKS;      // P row pitch
  static constexpr int kQ = kRows * kQLD;           // floats
  static constexpr int kP = kRows * kPLD;
  static constexpr int kK = kKeys * kQLD;
  static constexpr int kStage = kK + kKeys * D;     // K then V
  static constexpr size_t kSmem =
      size_t(kQ + kP + kStages * kStage) * sizeof(float);
  static constexpr int kRowChunks = D / 4;          // 16-byte words a row
  // a thread's copies: a fixed word of every kCopyRows-th row where the
  // threads cover whole rows, else words kThreads apart (D = 384)
  static constexpr bool kRowCopies = kThreads % kRowChunks == 0;
  static constexpr int kCopyRows = kThreads / kRowChunks;   // rows a pass
  static_assert(kRowCopies ? kKeys % kCopyRows == 0 &&
                                 kRows % kCopyRows == 0
                           : kKeys * kRowChunks % kThreads == 0 &&
                                 kRows * kRowChunks % kThreads == 0,
                "whole 16-byte copies a thread");
  static_assert(32 % kCG == 0 && DT >= 1, "a row group within one warp");
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
};

// P's column of key k of a tile: the key splits 4 floats apart
template <int SPLIT>
__device__ __forceinline__ int pcol(int k) {
  return k + 4 * (k / SPLIT);
}

// Dim e of the DT dims of O that dim group dg of DG owns: 4-dim runs
// 4 DG apart from 4 dg (a quarter-warp reads neighbouring 16-byte words
// of a V row), or DT neighbouring dims where DT < 4.
template <int DG, int DT>
__device__ __forceinline__ int dims_of(int dg, int e) {
  return DT >= 4 ? 4 * DG * (e / 4) + 4 * dg + e % 4 : dg * DT + e;
}

// The DT values of a D-wide row at the dims dim group dg owns.
template <int DG, int DT>
__device__ __forceinline__ void load_dims(const float* row, int dg,
                                          float (&v)[DT]) {
  if constexpr (DT >= 4) {
#pragma unroll
    for (int h = 0; h < DT / 4; ++h) {
      const float4 f =
          *reinterpret_cast<const float4*>(row + 4 * DG * h + 4 * dg);
      v[4 * h] = f.x;
      v[4 * h + 1] = f.y;
      v[4 * h + 2] = f.z;
      v[4 * h + 3] = f.w;
    }
  } else if constexpr (DT == 2) {
    const float2 f = *reinterpret_cast<const float2*>(row + 2 * dg);
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = row[dg];
  }
}

// 2^x by the multi-function unit (one MUFU.EX2; results below 2^-126
// flush to 0): the flash kernel's exponentials, with log2(e) folded
// into the argument
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__global__ void __launch_bounds__(FlashTile<D>::kThreads,
                                  FlashTile<D>::kCtasPerSm)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Hq, int Hkv, int Sq, int Skv, int causal,
                       float scale, int /*width: D*/) {
  using Tile = FlashTile<D>;
  constexpr int RT = Tile::RT, KT = Tile::KT, DT = Tile::DT;
  constexpr int BK = Tile::kKeys, QLD = Tile::kQLD, PLD = Tile::kPLD;
  constexpr int CG = Tile::kCG, RG = Tile::kRG, DG = Tile::DG;
  constexpr int SPLIT = Tile::kSplit, CR = Tile::kCopyRows;
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [kRows][QLD], q * scale
  float* ps = qs + Tile::kQ;               // [kRows][PLD], this tile's P
  float* ring = ps + Tile::kP;             // kStages x (K [BK][QLD], V [BK][D])
  const int t = threadIdx.x, rg = t / CG, cg = t % CG;
  const int ks = cg / DG, dg = cg % DG;
  const int bh = blockIdx.x;               // b * Hq + h
  const int group = Hq / Hkv;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / group;
  // the last query blocks see the most keys: launch them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * Tile::kRows;
  const int offs = Skv - Sq;
  // keys past q0 + kRows - 1 + offs are masked for every row of the block
  const int kv_end = causal ? min(Skv, q0 + Tile::kRows + offs) : Skv;
  const int tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
  // this thread's 16-byte word of the rows it copies: row cr + CR u
  const int cr = t / Tile::kRowChunks, cd = 4 * (t % Tile::kRowChunks);
  const float* kt = k + (size_t(kvh) * Skv + cr) * D + cd;
  const float* vt = v + (size_t(kvh) * Skv + cr) * D + cd;
  const uint32_t ring_k = tc::smem_u32(ring + cr * QLD + cd);
  const uint32_t ring_v = tc::smem_u32(ring + Tile::kK + cr * D + cd);

  // K and V rows [k0, k0 + BK) of tile `tile` into its stage, 16 bytes a
  // copy; rows at or past Skv zero-filled
  auto stage = [&](int tile) {
    const int k0 = tile * BK;
    const uint32_t at = (tile % Tile::kStages) * Tile::kStage * 4;
    if constexpr (Tile::kRowCopies) {
#pragma unroll
      for (int u = 0; u < BK / CR; ++u) {
        const bool ok = k0 + cr + CR * u < Skv;
        const size_t off = size_t(k0 + CR * u) * D;
        tc::cp_async16(ring_k + at + CR * u * QLD * 4, ok ? kt + off : k, ok);
        tc::cp_async16(ring_v + at + CR * u * D * 4, ok ? vt + off : v, ok);
      }
    } else {
      const uint32_t base = tc::smem_u32(ring) + at;
      const size_t head = size_t(kvh) * Skv * D;
#pragma unroll
      for (int u = 0; u < BK * Tile::kRowChunks / Tile::kThreads; ++u) {
        const int e = t + Tile::kThreads * u;
        const int r = e / Tile::kRowChunks, c = 4 * (e % Tile::kRowChunks);
        const bool ok = k0 + r < Skv;
        const size_t off = head + size_t(k0 + r) * D + c;
        tc::cp_async16(base + (r * QLD + c) * 4, ok ? k + off : k, ok);
        tc::cp_async16(base + (Tile::kK + r * D + c) * 4, ok ? v + off : v,
                       ok);
      }
    }
  };
  if (tiles > 0) stage(0);
  tc::cp_async_commit();
  if constexpr (Tile::kRowCopies) {
    const float* qt = q + (size_t(bh) * Sq + q0 + cr) * D + cd;
#pragma unroll
    for (int u = 0; u < Tile::kRows / CR; ++u) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + cr + CR * u < Sq) {
        x = __ldg(reinterpret_cast<const float4*>(qt + size_t(CR * u) * D));
        x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                        __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
      }
      *reinterpret_cast<float4*>(qs + (cr + CR * u) * QLD + cd) = x;
    }
  } else {
#pragma unroll
    for (int u = 0; u < Tile::kRows * Tile::kRowChunks / Tile::kThreads;
         ++u) {
      const int e = t + Tile::kThreads * u;
      const int r = e / Tile::kRowChunks, c = 4 * (e % Tile::kRowChunks);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < Sq) {
        x = __ldg(reinterpret_cast<const float4*>(
            q + (size_t(bh) * Sq + q0 + r) * D + c));
        x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                        __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
      }
      *reinterpret_cast<float4*>(qs + r * QLD + c) = x;
    }
  }

  float m[RT], l[RT], acc[RT][DT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DT; ++e) acc[i][e] = 0.f;
  }
  for (int tile = 0; tile < tiles; ++tile) {
    tc::cp_async_wait<0>();
    __syncthreads();        // the tile landed (and Q); the last P.V is done
    if (tile + 1 < tiles) stage(tile + 1);
    tc::cp_async_commit();
    const float* ks_ = ring + (tile % Tile::kStages) * Tile::kStage;
    const float* vs = ks_ + Tile::kK;
    const int k0 = tile * BK;

    // S = Q.K^T: each dot one FMA chain over d
    float s[RT][KT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int c = 0; c < KT; ++c) s[i][c] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 qv[RT], kv[KT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg + RG * i) * QLD + d);
      }
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        kv[c] = *reinterpret_cast<const float4*>(ks_ + (cg + CG * c) * QLD + d);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          s[i][c] = __fmaf_rn(qv[i].x, kv[c].x, s[i][c]);
          s[i][c] = __fmaf_rn(qv[i].y, kv[c].y, s[i][c]);
          s[i][c] = __fmaf_rn(qv[i].z, kv[c].z, s[i][c]);
          s[i][c] = __fmaf_rn(qv[i].w, kv[c].w, s[i][c]);
        }
      }
    }
    // the mask, only where the diagonal or the end of Skv crosses the tile
    if (k0 + BK > Skv || (causal && k0 + BK - 1 > q0 + offs)) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int qi = q0 + rg + RG * i;
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          const int kp = k0 + cg + CG * c;
          if (kp >= Skv || (causal && kp > qi + offs)) s[i][c] = kMasked;
        }
      }
    }
    // the online softmax step (flash.py:58-63) in base 2: the row's max
    // over its CG threads; alpha = 2^((m - m') log2 e), P = 2^(s log2 e
    // - m' log2 e); each thread sums its own keys' P into its part of l
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int c = 1; c < KT; ++c) mx = fmaxf(mx, s[i][c]);
#pragma unroll
      for (int x = 1; x < CG; x <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = ex2(__fmul_rn(__fsub_rn(m[i], m_new), kLog2e));
      const float mc = __fmul_rn(m_new, kLog2e);
      m[i] = m_new;
      l[i] = __fmul_rn(l[i], alpha);
#pragma unroll
      for (int e = 0; e < DT; ++e) acc[i][e] = __fmul_rn(acc[i][e], alpha);
      float* prow = ps + (rg + RG * i) * PLD;
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        const float p = ex2(__fmaf_rn(s[i][c], kLog2e, -mc));
        l[i] = __fadd_rn(l[i], p);
        prow[pcol<SPLIT>(cg + CG * c)] = p;
      }
    }
    // P complete: a thread reads P only from its own rows, which the
    // threads of its own row group, in its own warp, wrote
    __syncwarp();
    // O += P.V over this thread's key split: each partial one FMA chain
    // over its keys in order
    const float* pk = ps + pcol<SPLIT>(ks * SPLIT);
    const float* vk = vs + ks * SPLIT * D;
#pragma unroll
    for (int j = 0; j < SPLIT; j += 4) {
      float4 pv[RT];
      float vv[4][DT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(pk + (rg + RG * i) * PLD + j);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) load_dims<DG, DT>(vk + (j + u) * D, dg, vv[u]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int e = 0; e < DT; ++e) {
          acc[i][e] = __fmaf_rn(pv[i].x, vv[0][e], acc[i][e]);
          acc[i][e] = __fmaf_rn(pv[i].y, vv[1][e], acc[i][e]);
          acc[i][e] = __fmaf_rn(pv[i].z, vv[2][e], acc[i][e]);
          acc[i][e] = __fmaf_rn(pv[i].w, vv[3][e], acc[i][e]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
  // each row's normalizer (its CG threads' parts) and O (its kKS splits'
  // partial sums)
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int x = 1; x < CG; x <<= 1) {
      l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], x));
    }
#pragma unroll
    for (int x = DG; x < CG; x <<= 1) {
#pragma unroll
      for (int e = 0; e < DT; ++e) {
        acc[i][e] = __fadd_rn(acc[i][e],
                              __shfl_xor_sync(0xffffffffu, acc[i][e], x));
      }
    }
  }
  // split ks stores rows i = ks, ks + kKS, ..
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qi = q0 + rg + RG * i;
    if (i % Tile::kKS != ks || qi >= Sq) continue;
    const bool sees_a_key = !causal || qi + offs >= 0;
    const float norm = fmaxf(l[i], kMinNorm);
    float* orow = o + (size_t(bh) * Sq + qi) * D;
#pragma unroll
    for (int e = 0; e < DT; ++e) {
      orow[dims_of<DG, DT>(dg, e)] =
          sees_a_key ? __fdiv_rn(acc[i][e], norm) : 0.f;
    }
  }
}

// The chunked instance (D = 0: head dims past 384, a multiple of 128 at
// run time): a CTA of 16 row groups x 16 column groups owns 64 query rows
// and one 128-column block of O.  S needs every column of D, so Q and K
// come through the ring a 128-column chunk at a time (Q's chunk re-read
// from L2 once a key tile); V's 128 columns of the tile come with the
// tile's last chunk.  Two stages of (Q chunk, K chunk) and one V tile:
// 141 KB, one CTA of 8 warps an SM.
template <> struct FlashTile<0> {
  static constexpr int kW = 128;                    // chunk, column block
  static constexpr int kCG = 16, kRG = 16, RT = 4, kKeys = 32, kKS = 1;
  static constexpr int kCtasPerSm = 1, kStages = 2;
  static constexpr int kRows = kRG * RT, kThreads = kRG * kCG;
  static constexpr int KT = kKeys / kCG, DG = kCG, DT = kW / DG;
  static constexpr int kSplit = kKeys, kQLD = kW + 4, kPLD = kKeys + 4;
  static constexpr int kQ = kRows * kQLD, kK = kKeys * kQLD;
  static constexpr int kV = kKeys * kW, kP = kRows * kPLD;
  static constexpr int kStage = kQ + kK;            // a chunk of Q, of K
  static constexpr size_t kSmem =
      size_t(kStages * kStage + kV + kP) * sizeof(float);
  static constexpr int kRowChunks = kW / 4;
  static constexpr int kCopyRows = kThreads / kRowChunks;
  static_assert(kRows % kCopyRows == 0 && kKeys % kCopyRows == 0,
                "whole 16-byte copies a thread");
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
};

// flash_attention_kernel<0>: D (a multiple of 128, at least 256) is
// `width`.  The same arithmetic as the other instances, in the same order:
// each score is one FMA chain over d = 0 .. D - 1 (the chunks in order),
// then the base-2 online softmax step and O += P.V over the tile's keys.
// Unit u = tile * nc + chunk; its copies are in flight while unit u - 1
// computes, one barrier a unit.  Needs nc >= 2: V of tile t lands with
// unit (t, nc - 1), whose copies start after the barrier of unit (t, nc
// - 2), when every thread has done tile t - 1's P.V.
template <>
__global__ void __launch_bounds__(FlashTile<0>::kThreads,
                                  FlashTile<0>::kCtasPerSm)
flash_attention_kernel<0>(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int Hq, int Hkv, int Sq, int Skv, int causal,
                          float scale, int width) {
  using Tile = FlashTile<0>;
  constexpr int RT = Tile::RT, KT = Tile::KT, DT = Tile::DT, W = Tile::kW;
  constexpr int BK = Tile::kKeys, QLD = Tile::kQLD, PLD = Tile::kPLD;
  constexpr int CG = Tile::kCG, RG = Tile::kRG, DG = Tile::DG;
  constexpr int CR = Tile::kCopyRows;
  extern __shared__ __align__(16) uint8_t smem[];
  float* ring = reinterpret_cast<float*>(smem);  // 2 x (Q, K chunks)
  float* vs = ring + Tile::kStages * Tile::kStage;   // [BK][W]
  float* ps = vs + Tile::kV;                     // [kRows][PLD]
  const int D = width, nc = D / W;
  const int t = threadIdx.x, rg = t / CG, cg = t % CG, dg = cg;
  const int cb = blockIdx.x % nc;                // column block of O
  const int bh = blockIdx.x / nc;                // b * Hq + h
  const int col0 = cb * W;
  const int group = Hq / Hkv;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * Tile::kRows;
  const int offs = Skv - Sq;
  const int kv_end = causal ? min(Skv, q0 + Tile::kRows + offs) : Skv;
  const int tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
  const int units = tiles * nc;
  const int cr = t / Tile::kRowChunks, cd = 4 * (t % Tile::kRowChunks);
  const float* qt = q + (size_t(bh) * Sq + q0 + cr) * D + cd;
  const float* kt = k + (size_t(kvh) * Skv + cr) * D + cd;
  const float* vt = v + (size_t(kvh) * Skv + cr) * D + col0 + cd;

  // unit u: columns [W c, W c + W) of the Q block and of K tile `tile`
  // into stage u % 2, and with the tile's last chunk its V columns; rows
  // at or past Sq / Skv zero-filled
  auto stage = [&](int u) {
    const int tile = u / nc, c = u % nc, k0 = tile * BK;
    float* st = ring + (u % Tile::kStages) * Tile::kStage;
    const uint32_t sq_ = tc::smem_u32(st + cr * QLD + cd);
    const uint32_t sk_ = tc::smem_u32(st + Tile::kQ + cr * QLD + cd);
#pragma unroll
    for (int r = 0; r < Tile::kRows / CR; ++r) {
      const bool ok = q0 + cr + CR * r < Sq;
      tc::cp_async16(sq_ + CR * r * QLD * 4,
                     ok ? qt + size_t(CR * r) * D + c * W : q, ok);
    }
#pragma unroll
    for (int r = 0; r < BK / CR; ++r) {
      const bool ok = k0 + cr + CR * r < Skv;
      tc::cp_async16(sk_ + CR * r * QLD * 4,
                     ok ? kt + size_t(k0 + CR * r) * D + c * W : k, ok);
    }
    if (c == nc - 1) {
      const uint32_t sv_ = tc::smem_u32(vs + cr * W + cd);
#pragma unroll
      for (int r = 0; r < BK / CR; ++r) {
        const bool ok = k0 + cr + CR * r < Skv;
        tc::cp_async16(sv_ + CR * r * W * 4,
                       ok ? vt + size_t(k0 + CR * r) * D : v, ok);
      }
    }
  };
  if (units > 0) stage(0);
  tc::cp_async_commit();

  float m[RT], l[RT], acc[RT][DT], s[RT][KT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DT; ++e) acc[i][e] = 0.f;
  }
  for (int u = 0; u < units; ++u) {
    const int tile = u / nc, c = u % nc, k0 = tile * BK;
    float* qs = ring + (u % Tile::kStages) * Tile::kStage;
    const float* ks_ = qs + Tile::kQ;
    tc::cp_async_wait<0>();
    // this thread's own copies of the Q chunk landed: scale them
#pragma unroll
    for (int r = 0; r < Tile::kRows / CR; ++r) {
      float4* p = reinterpret_cast<float4*>(qs + (cr + CR * r) * QLD + cd);
      const float4 x = *p;
      *p = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                       __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
    }
    __syncthreads();        // the unit landed and is scaled; unit u - 1 done
    if (u + 1 < units) stage(u + 1);
    tc::cp_async_commit();
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int j = 0; j < KT; ++j) s[i][j] = 0.f;
      }
    }
    // S += Q_c . K_c^T: each score's FMA chain goes on over this chunk
#pragma unroll 8
    for (int d = 0; d < W; d += 4) {
      float4 qv[RT], kv[KT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg + RG * i) * QLD + d);
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(ks_ + (cg + CG * j) * QLD + d);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          s[i][j] = __fmaf_rn(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].w, kv[j].w, s[i][j]);
        }
      }
    }
    if (c != nc - 1) continue;
    // the tile's scores are whole: mask, softmax step, O += P.V
    if (k0 + BK > Skv || (causal && k0 + BK - 1 > q0 + offs)) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int qi = q0 + rg + RG * i;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const int kp = k0 + cg + CG * j;
          if (kp >= Skv || (causal && kp > qi + offs)) s[i][j] = kMasked;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KT; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int x = 1; x < CG; x <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = ex2(__fmul_rn(__fsub_rn(m[i], m_new), kLog2e));
      const float mc = __fmul_rn(m_new, kLog2e);
      m[i] = m_new;
      l[i] = __fmul_rn(l[i], alpha);
#pragma unroll
      for (int e = 0; e < DT; ++e) acc[i][e] = __fmul_rn(acc[i][e], alpha);
      float* prow = ps + (rg + RG * i) * PLD;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float p = ex2(__fmaf_rn(s[i][j], kLog2e, -mc));
        l[i] = __fadd_rn(l[i], p);
        prow[cg + CG * j] = p;
      }
    }
    __syncwarp();           // P of a row group is its own warp's
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[RT];
      float vv[4][DT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(ps + (rg + RG * i) * PLD + j);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) load_dims<DG, DT>(vs + (j + x) * W, dg, vv[x]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int e = 0; e < DT; ++e) {
          acc[i][e] = __fmaf_rn(pv[i].x, vv[0][e], acc[i][e]);
          acc[i][e] = __fmaf_rn(pv[i].y, vv[1][e], acc[i][e]);
          acc[i][e] = __fmaf_rn(pv[i].z, vv[2][e], acc[i][e]);
          acc[i][e] = __fmaf_rn(pv[i].w, vv[3][e], acc[i][e]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int x = 1; x < CG; x <<= 1) {
      l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], x));
    }
    const int qi = q0 + rg + RG * i;
    if (qi >= Sq) continue;
    const bool sees_a_key = !causal || qi + offs >= 0;
    const float norm = fmaxf(l[i], kMinNorm);
    float* orow = o + (size_t(bh) * Sq + qi) * D + col0;
#pragma unroll
    for (int e = 0; e < DT; ++e) {
      orow[dims_of<DG, DT>(dg, e)] =
          sees_a_key ? __fdiv_rn(acc[i][e], norm) : 0.f;
    }
  }
}

// The cp.async ring's depth and the CTAs an SM that the register cap
// allows: at up to 4 GQA rows a CTA, two stages and three CTAs an SM; at
// 8 rows (twice the registers) three stages and two CTAs.  Past head dim
// 128 (rows of 512 bytes or more, 32-key stages of 32-96 KB) one CTA an
// SM, and three stages where they take at most 160 KB, else two.
template <typename T, int D, int GP> struct DecodeDepth {
  static constexpr int kStageBytes = 64 * D * int(sizeof(T));
  static constexpr int kStages =
      D > 128 ? (3 * kStageBytes <= 160 * 1024 ? 3 : 2) : GP <= 4 ? 2 : 3;
  static constexpr int kCtasPerSm =                 // D = 0: chunked
      D == 0 ? (GP <= 4 ? 2 : 1) : D > 128 ? 1 : GP <= 4 ? 3 : 2;
};

// The split-KV decode tile of a head dim and dtype: a warp takes
// kKeysPerWarp keys of each stage, kLanesPerKey lanes a key, each lane
// 16-byte chunks kLanesPerKey apart of the key's row; in P.V a lane owns
// kDims neighbouring dims of every row.  Rows of 128 bytes or more are
// XOR-swizzled by 16-byte chunk, so the lanes of a quarter-warp reading
// K for their keys, or V for one key, touch every bank once.
template <typename T, int D> struct DecodeTile {
  static constexpr int kRowBytes = D * int(sizeof(T));
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kVals = 16 / int(sizeof(T));       // a chunk's values
  static constexpr int kKeysPerWarp =
      kRowBytes <= 128 ? 16 : kRowBytes <= 256 ? 8 : 4;
  static constexpr int kLanesPerKey = 32 / kKeysPerWarp;
  static constexpr int kTile = kDecWarps * kKeysPerWarp;   // keys a stage
  static constexpr int kStageBytes = 2 * kTile * kRowBytes;  // K and V
  static constexpr int kDims = D >= 32 ? D / 32 : 1;
  __device__ static int swizzle(int row) {
    return kChunks >= 8 ? (row % (8 / kLanesPerKey)) * kLanesPerKey : 0;
  }
};

template <typename T, int D, int GP>
constexpr size_t decode_smem() {
  using Tile = DecodeTile<T, D>;
  // the warps' states are merged in the ring once it is drained
  constexpr int stages = DecodeDepth<T, D, GP>::kStages;
  static_assert(sizeof(float) * kDecWarps * GP * (D + 2) <=
                    size_t(stages) * Tile::kStageBytes,
                "decode merge scratch exceeds the ring");
  return size_t(stages) * Tile::kStageBytes +
         sizeof(float) * (GP * D + kDecWarps * Tile::kKeysPerWarp * GP);
}

// A 16-byte chunk's values, widened exactly to f32.
__device__ __forceinline__ void widen_chunk(const uint4& c, float (&v)[4]) {
  v[0] = __uint_as_float(c.x); v[1] = __uint_as_float(c.y);
  v[2] = __uint_as_float(c.z); v[3] = __uint_as_float(c.w);
}
__device__ __forceinline__ void widen_chunk(const uint4& c, float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = (&c.x)[i];
    v[2 * i] = __uint_as_float(x << 16);
    v[2 * i + 1] = __uint_as_float(x & 0xffff0000u);
  }
}

// N neighbouring values of T at p (N * sizeof(T) bytes, aligned), in f32;
// past 4, in runs of 4 (head dims past 128: their rows are not swizzled,
// DecodeTile::swizzle, so a lane's dims lie side by side).
template <typename T, int N>
__device__ __forceinline__ void load_widened(const uint8_t* p, float (&v)[N]) {
  if constexpr (N > 4) {
    static_assert(N % 4 == 0, "runs of 4");
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      float w[4];
      load_widened<T, 4>(p + 4 * h * int(sizeof(T)), w);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * h + e] = w[e];
    }
  } else if constexpr (sizeof(T) == 4 && N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (sizeof(T) == 4 && N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else if constexpr (sizeof(T) == 4) {
    v[0] = *reinterpret_cast<const float*>(p);
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(x.x << 16); v[1] = __uint_as_float(x.x & 0xffff0000u);
    v[2] = __uint_as_float(x.y << 16); v[3] = __uint_as_float(x.y & 0xffff0000u);
  } else if constexpr (N == 2) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    v[0] = __uint_as_float(x << 16); v[1] = __uint_as_float(x & 0xffff0000u);
  } else {
    v[0] = __uint_as_float(uint32_t(*reinterpret_cast<const uint16_t*>(p)) << 16);
  }
}

// A key's GP probabilities from shared memory (16-byte aligned for
// GP >= 4), in vector loads.
template <int GP>
__device__ __forceinline__ void load_probs(const float* p, float (&v)[GP]) {
  if constexpr (GP % 4 == 0) {
#pragma unroll
    for (int i = 0; i < GP / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
    }
  } else if constexpr (GP == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

// One (b * Hkv + kv head, block of GP rows of its GQA group) against keys
// [split * chunk, min(split * chunk + chunk, Skv)).  The CTA streams the
// keys through a ring of cp.async stages (DecodeDepth); each warp keeps its
// own online softmax (m, l, acc) over its keys of every stage, and the
// warps' states are merged once at the end into the split's partial
// (m, l, acc[GP][D]) in the workspace.
template <typename T, int D, int GP>
__device__ __forceinline__ void decode_split(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    float* __restrict__ ws, int group, int rowblocks, int Skv, int chunk,
    float scale) {
  using Tile = DecodeTile<T, D>;
  constexpr int KPW = Tile::kKeysPerWarp, LPK = Tile::kLanesPerKey;
  constexpr int NC = Tile::kChunks, NV = Tile::kVals, ND = Tile::kDims;
  constexpr int kStages = DecodeDepth<T, D, GP>::kStages;
  static_assert(ND <= 4 || LPK == 8,    // 8 lanes a key: rows unswizzled
                "a lane's dims side by side past 4");
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem + kStages * Tile::kStageBytes);
  float* pbuf = qs + GP * D;                   // [warp][key][GP]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hk = blockIdx.x / rowblocks, row0 = (blockIdx.x % rowblocks) * GP;
  const int rows = min(GP, group - row0);
  const int k0 = blockIdx.y * chunk, k1 = min(k0 + chunk, Skv);
  const T* qh = q + (size_t(hk) * group + row0) * D;
  for (int e = tid; e < GP * D; e += kDecThreads) {
    qs[e] = e < rows * D ? __fmul_rn(widen<float>(qh[e]), scale) : 0.f;
  }
  const T* kh = k + size_t(hk) * Skv * D;
  const T* vh = v + size_t(hk) * Skv * D;
  const int ntiles = (k1 - k0 + Tile::kTile - 1) / Tile::kTile;
  const uint32_t ring = tc::smem_u32(smem);

  auto load = [&](int stage, int t) {
    const int base = k0 + t * Tile::kTile;
    const uint32_t dst = ring + stage * Tile::kStageBytes;
    for (int e = tid; e < 2 * Tile::kTile * NC; e += kDecThreads) {
      const int which = e / (Tile::kTile * NC), rem = e % (Tile::kTile * NC);
      const int row = rem / NC, c = rem % NC, key = base + row;
      const bool ok = key < k1;
      const T* src = (which ? vh : kh) + (ok ? size_t(key) * D + c * NV : 0);
      tc::cp_async16(dst + (which * Tile::kTile + row) * Tile::kRowBytes +
                         ((c ^ Tile::swizzle(row)) << 4),
                     src, ok);
    }
  };

  float m[GP], l[GP], acc[GP][ND];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kMasked;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < ND; ++e) acc[g][e] = 0.f;
  }
  const int key_l = lane / LPK, part = lane % LPK;
  const int row = warp * KPW + key_l;          // this lane's key in a stage
  float* pw = pbuf + warp * KPW * GP;
  const int d0 = lane * ND;                    // this lane's P.V dims
  const int vchunk = (d0 * int(sizeof(T))) >> 4;
  const int vbyte = (d0 * int(sizeof(T))) & 15;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load(s, s);
    tc::cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();                           // the stage landed for all;
    const int pre = t + kStages - 1;        // the one read last is free
    if (pre < ntiles) load(pre % kStages, pre);
    tc::cp_async_commit();
    const uint8_t* ks = smem + (t % kStages) * Tile::kStageBytes;
    const uint8_t* vs = ks + Tile::kTile * Tile::kRowBytes;
    // scores of this lane's key: its chunks, then the key's lanes summed
    float sc[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) sc[g] = 0.f;
    const uint8_t* kr = ks + row * Tile::kRowBytes;
#pragma unroll
    for (int st = 0; st < NC / LPK; ++st) {
      const int c = st * LPK + part;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          kr + ((c ^ Tile::swizzle(row)) << 4));
      float kv[NV];
      widen_chunk(raw, kv);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float* qr = qs + g * D + c * NV;
#pragma unroll
        for (int e = 0; e < NV; e += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qr + e);
          sc[g] = __fmaf_rn(qq.x, kv[e], sc[g]);
          sc[g] = __fmaf_rn(qq.y, kv[e + 1], sc[g]);
          sc[g] = __fmaf_rn(qq.z, kv[e + 2], sc[g]);
          sc[g] = __fmaf_rn(qq.w, kv[e + 3], sc[g]);
        }
      }
    }
    const bool valid = k0 + t * Tile::kTile + row < k1;
    float alpha[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
#pragma unroll
      for (int x = 1; x < LPK; x <<= 1) {
        sc[g] = __fadd_rn(sc[g], __shfl_xor_sync(0xffffffffu, sc[g], x));
      }
      float tile_max = valid ? sc[g] : kMasked;
#pragma unroll
      for (int x = LPK; x < 32; x <<= 1) {
        tile_max = vmax(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, x));
      }
      alpha[g] = online_softmax_step(m[g], l[g], tile_max);
      const float p = valid ? expf(__fsub_rn(sc[g], m[g])) : 0.f;
      float psum = p;
#pragma unroll
      for (int x = LPK; x < 32; x <<= 1) {
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, x));
      }
      l[g] = __fadd_rn(l[g], psum);
      if (part == 0) pw[key_l * GP + g] = p;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < GP; ++g) {
#pragma unroll
      for (int e = 0; e < ND; ++e) acc[g][e] = __fmul_rn(acc[g][e], alpha[g]);
    }
    if (d0 < D) {
#pragma unroll 4
      for (int kk = 0; kk < KPW; ++kk) {
        const int vrow = warp * KPW + kk;
        float vv[ND];
        load_widened<T, ND>(vs + vrow * Tile::kRowBytes +
                                ((vchunk ^ Tile::swizzle(vrow)) << 4) + vbyte,
                            vv);
        float pk[GP];
        load_probs(pw + kk * GP, pk);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
#pragma unroll
          for (int e = 0; e < ND; ++e) acc[g][e] = __fmaf_rn(pk[g], vv[e], acc[g][e]);
        }
      }
    }
    __syncwarp();                              // pw is rewritten next stage
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  // merge the warps' states in ascending warp order (the ring is free)
  float* mw = reinterpret_cast<float*>(smem);  // [warp][GP]
  float* lw = mw + kDecWarps * GP;
  float* aw = lw + kDecWarps * GP;             // [warp][GP][D]
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      mw[warp * GP + g] = m[g];
      lw[warp * GP + g] = l[g];
    }
  }
  if (d0 < D) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
#pragma unroll
      for (int e = 0; e < ND; ++e) aw[(warp * GP + g) * D + d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  float* out = ws + (size_t(blockIdx.x) * gridDim.y + blockIdx.y) * GP * (D + 2);
  for (int e = tid; e < GP * D; e += kDecThreads) {
    const int g = e / D, d = e % D;
    float mx = kMasked;
    for (int w = 0; w < kDecWarps; ++w) mx = vmax(mx, mw[w * GP + g]);
    float a = 0.f, ls = 0.f;
    for (int w = 0; w < kDecWarps; ++w) {
      const float f = expf(__fsub_rn(mw[w * GP + g], mx));
      a = __fmaf_rn(f, aw[(w * GP + g) * D + d], a);
      ls = __fmaf_rn(f, lw[w * GP + g], ls);
    }
    out[2 * GP + e] = a;
    if (d == 0) {
      out[g] = mx;
      out[GP + g] = ls;
    }
  }
}

// The chunked decode (D = 0: head dims past 384, a multiple of 128 at run
// time, `width`): a CTA owns one 128-column block of O (a grid axis: the
// blocks of one row block and split launch side by side) of GP rows of a
// kv head's GQA group against one chunk of the keys.  A stage's scores
// need every column of D: its keys stream through the ring as nc
// 128-column units of K, then one unit of V's 128 columns, each unit
// kTile rows of DecodeTile<T, 128> (16 KB); the scaled query rows (GP x D
// floats) stay in shared memory.  Each lane's partial score goes on over
// the chunks in order, so it is the same FMA chain over its 16-byte
// chunks of the row as the other instances'; the softmax step runs once
// a stage is scored, P.V once its V unit lands.  Every column block
// computes the same m and l; block 0 writes them to the workspace.
template <typename T> struct DecodeChunked {
  using Tile = DecodeTile<T, 128>;
  static constexpr int kW = 128;
  static constexpr int kUnitBytes = Tile::kTile * Tile::kRowBytes;
  static constexpr int kUnits = 4;                 // ring depth
  static constexpr int kRing = kUnits * kUnitBytes;
  template <int GP> static size_t smem(int d) {
    return size_t(kRing) +
           sizeof(float) * (size_t(GP) * d + kDecWarps * Tile::kKeysPerWarp * GP);
  }
};

template <typename T, int GP>
__device__ __forceinline__ void decode_chunked(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    float* __restrict__ ws, int group, int rowblocks, int Skv, int chunk,
    float scale, int D) {
  using DC = DecodeChunked<T>;
  using Tile = typename DC::Tile;
  constexpr int KPW = Tile::kKeysPerWarp, LPK = Tile::kLanesPerKey;
  constexpr int NC = Tile::kChunks, NV = Tile::kVals, ND = Tile::kDims;
  constexpr int W = DC::kW, kUnits = DC::kUnits;
  static_assert(ND == 4 && W / 32 == ND, "a lane's 4 dims of the block");
  static_assert(sizeof(float) * kDecWarps * GP * (W + 2) <= DC::kRing,
                "decode merge scratch exceeds the ring");
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem + DC::kRing);   // [GP][D]
  float* pbuf = qs + GP * D;                   // [warp][key][GP]
  const int nc = D / W;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cb = blockIdx.x % nc, rbx = blockIdx.x / nc;
  const int col0 = cb * W;
  const int hk = rbx / rowblocks, row0 = (rbx % rowblocks) * GP;
  const int rows = min(GP, group - row0);
  const int k0 = blockIdx.y * chunk, k1 = min(k0 + chunk, Skv);
  const T* qh = q + (size_t(hk) * group + row0) * D;
  for (int e = tid; e < GP * D; e += kDecThreads) {
    qs[e] = e < rows * D ? __fmul_rn(widen<float>(qh[e]), scale) : 0.f;
  }
  const T* kh = k + size_t(hk) * Skv * D;
  const T* vh = v + size_t(hk) * Skv * D + col0;
  const int ntiles = (k1 - k0 + Tile::kTile - 1) / Tile::kTile;
  const int units = ntiles * (nc + 1);         // nc K units, then V
  const uint32_t ring = tc::smem_u32(smem);

  auto load = [&](int slot, int u) {
    const int tile = u / (nc + 1), c = u % (nc + 1);
    const int base = k0 + tile * Tile::kTile;
    const T* src0 = c < nc ? kh + c * W : vh;
    const uint32_t dst = ring + slot * DC::kUnitBytes;
    for (int e = tid; e < Tile::kTile * NC; e += kDecThreads) {
      const int row = e / NC, ch = e % NC, key = base + row;
      const bool ok = key < k1;
      tc::cp_async16(dst + row * Tile::kRowBytes +
                         ((ch ^ Tile::swizzle(row)) << 4),
                     src0 + (ok ? size_t(key) * D + ch * NV : 0), ok);
    }
  };

  float m[GP], l[GP], acc[GP][ND], sc[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kMasked;
    l[g] = 0.f;
    sc[g] = 0.f;
#pragma unroll
    for (int e = 0; e < ND; ++e) acc[g][e] = 0.f;
  }
  const int key_l = lane / LPK, part = lane % LPK;
  const int row = warp * KPW + key_l;          // this lane's key in a unit
  float* pw = pbuf + warp * KPW * GP;
  const int d0 = lane * ND;                    // this lane's P.V dims
  const int vchunk = (d0 * int(sizeof(T))) >> 4;
  const int vbyte = (d0 * int(sizeof(T))) & 15;
#pragma unroll
  for (int s = 0; s < kUnits - 1; ++s) {
    if (s < units) load(s, s);
    tc::cp_async_commit();
  }
  for (int u = 0; u < units; ++u) {
    tc::cp_async_wait<kUnits - 2>();
    __syncthreads();                           // the unit landed for all;
    const int pre = u + kUnits - 1;            // the one read last is free
    if (pre < units) load(pre % kUnits, pre);
    tc::cp_async_commit();
    const int tile = u / (nc + 1), c = u % (nc + 1);
    const uint8_t* us = smem + (u % kUnits) * DC::kUnitBytes;
    if (c < nc) {
      // this lane's partial scores over chunk c of its key's row
      const uint8_t* kr = us + row * Tile::kRowBytes;
#pragma unroll
      for (int st = 0; st < NC / LPK; ++st) {
        const int ch = st * LPK + part;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            kr + ((ch ^ Tile::swizzle(row)) << 4));
        float kv[NV];
        widen_chunk(raw, kv);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float* qr = qs + g * D + c * W + ch * NV;
#pragma unroll
          for (int e = 0; e < NV; e += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(qr + e);
            sc[g] = __fmaf_rn(qq.x, kv[e], sc[g]);
            sc[g] = __fmaf_rn(qq.y, kv[e + 1], sc[g]);
            sc[g] = __fmaf_rn(qq.z, kv[e + 2], sc[g]);
            sc[g] = __fmaf_rn(qq.w, kv[e + 3], sc[g]);
          }
        }
      }
      if (c < nc - 1) continue;
      // the stage is scored: the key's lanes summed, the softmax step
      const bool valid = k0 + tile * Tile::kTile + row < k1;
#pragma unroll
      for (int g = 0; g < GP; ++g) {
#pragma unroll
        for (int x = 1; x < LPK; x <<= 1) {
          sc[g] = __fadd_rn(sc[g], __shfl_xor_sync(0xffffffffu, sc[g], x));
        }
        float tile_max = valid ? sc[g] : kMasked;
#pragma unroll
        for (int x = LPK; x < 32; x <<= 1) {
          tile_max = vmax(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, x));
        }
        const float alpha = online_softmax_step(m[g], l[g], tile_max);
        const float p = valid ? expf(__fsub_rn(sc[g], m[g])) : 0.f;
        float psum = p;
#pragma unroll
        for (int x = LPK; x < 32; x <<= 1) {
          psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, x));
        }
        l[g] = __fadd_rn(l[g], psum);
        if (part == 0) pw[key_l * GP + g] = p;
#pragma unroll
        for (int e = 0; e < ND; ++e) acc[g][e] = __fmul_rn(acc[g][e], alpha);
        sc[g] = 0.f;
      }
      __syncwarp();
      continue;
    }
    // the V unit: O += P.V over this warp's keys, 4 dims a lane
#pragma unroll 4
    for (int kk = 0; kk < KPW; ++kk) {
      const int vrow = warp * KPW + kk;
      float vv[ND];
      load_widened<T, ND>(us + vrow * Tile::kRowBytes +
                              ((vchunk ^ Tile::swizzle(vrow)) << 4) + vbyte,
                          vv);
      float pk[GP];
      load_probs(pw + kk * GP, pk);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
#pragma unroll
        for (int e = 0; e < ND; ++e) acc[g][e] = __fmaf_rn(pk[g], vv[e], acc[g][e]);
      }
    }
    __syncwarp();                              // pw is rewritten next stage
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  // merge the warps' states in ascending warp order (the ring is free)
  float* mw = reinterpret_cast<float*>(smem);  // [warp][GP]
  float* lw = mw + kDecWarps * GP;
  float* aw = lw + kDecWarps * GP;             // [warp][GP][W]
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      mw[warp * GP + g] = m[g];
      lw[warp * GP + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < GP; ++g) {
#pragma unroll
    for (int e = 0; e < ND; ++e) aw[(warp * GP + g) * W + d0 + e] = acc[g][e];
  }
  __syncthreads();
  float* out = ws + (size_t(rbx) * gridDim.y + blockIdx.y) * GP * (D + 2);
  for (int e = tid; e < GP * W; e += kDecThreads) {
    const int g = e / W, d = e % W;
    float mx = kMasked;
    for (int w = 0; w < kDecWarps; ++w) mx = vmax(mx, mw[w * GP + g]);
    float a = 0.f, ls = 0.f;
    for (int w = 0; w < kDecWarps; ++w) {
      const float f = expf(__fsub_rn(mw[w * GP + g], mx));
      a = __fmaf_rn(f, aw[(w * GP + g) * W + d], a);
      ls = __fmaf_rn(f, lw[w * GP + g], ls);
    }
    out[2 * GP + g * D + col0 + d] = a;
    if (d == 0 && cb == 0) {
      out[g] = mx;
      out[GP + g] = ls;
    }
  }
}

// The split kernel: head dims up to 384 on their instance (decode_split),
// past 384 on the chunked one (D = 0, width the padded head dim).
template <typename T, int D, int GP>
__global__ void __launch_bounds__(kDecThreads,
                                  DecodeDepth<T, D, GP>::kCtasPerSm)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, float* __restrict__ ws,
                          int group, int rowblocks, int Skv, int chunk,
                          float scale, int width) {
  if constexpr (D == 0) {
    decode_chunked<T, GP>(q, k, v, ws, group, rowblocks, Skv, chunk, scale,
                          width);
  } else {
    decode_split<T, D, GP>(q, k, v, ws, group, rowblocks, Skv, chunk, scale);
  }
}

// The splits' partials of one output element merged in ascending split
// order, o = sum_s e_s acc_s / max(sum_s e_s l_s, 1e-30) with
// e_s = exp(m_s - max_s m_s), narrowed to T.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ ws,
                                      T* __restrict__ o, int D, int GP,
                                      int group, int rowblocks, int splits,
                                      long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = int(idx % D);
  const long long hr = idx / D;                // hk * group + r
  const int r = int(hr % group);
  const long long hk = hr / group;
  const size_t stride = size_t(GP) * (D + 2);
  const float* base =
      ws + (size_t(hk) * rowblocks + r / GP) * splits * stride;
  const int g = r % GP;
  float mx = kMasked;
  for (int s = 0; s < splits; ++s) mx = vmax(mx, base[s * stride + g]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* part = base + s * stride;
    const float f = expf(__fsub_rn(part[g], mx));
    num = __fmaf_rn(f, part[2 * GP + g * D + d], num);
    den = __fmaf_rn(f, part[GP + g], den);
  }
  o[idx] = narrow<T>(__fdiv_rn(num, fmaxf(den, kMinNorm)));
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, int causal, float scale,
                 cudaStream_t st, int width = D) {
  using Tile = FlashTile<D>;
  auto kernel = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tile::kSmem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return int(err);
  }
  // chunked (D = 0): a CTA a 128-column block of O, the blocks of one
  // (head, query block) side by side
  if (D == 0 && (width % 128 != 0 || width < 256)) {
    return int(cudaErrorInvalidValue);
  }
  const int ncb = D == 0 ? width / 128 : 1;
  dim3 grid(B * Hq * ncb, (Sq + Tile::kRows - 1) / Tile::kRows);
  kernel<<<grid, Tile::kThreads, Tile::kSmem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Hq, Hkv,
      Sq, Skv, causal, scale, width);
  return int(cudaGetLastError());
}

constexpr int kDecMaxSplits = 64;

// Keys a split, a whole number of stages, for `splits` asked; and the
// splits that chunk gives (no empty one).  kernels/attention/decode.py::
// split_chunk mirrors these for its emulation.
inline int decode_chunk(int Skv, int splits, int tile) {
  const int per = (Skv + splits - 1) / splits;
  return (per + tile - 1) / tile * tile;
}
inline int decode_splits(int Skv, int splits, int tile) {
  const int chunk = decode_chunk(Skv, splits, tile);
  return (Skv + chunk - 1) / chunk;
}

// One decode call: GP rows of a GQA group a CTA (the group rounded up to
// a power of two, at most kDecRows), rowblocks CTAs a kv head.
struct DecodePlan {
  int B, Hq, Hkv, Skv, D, group, gp, rowblocks, splits;
};

inline DecodePlan decode_plan(int B, int Hq, int Hkv, int Skv, int D,
                              int splits) {
  DecodePlan p{B, Hq, Hkv, Skv, D, Hkv > 0 ? Hq / Hkv : 0, 1, 1, splits};
  while (p.gp < p.group && p.gp < kDecRows) p.gp *= 2;
  // past 384 the query rows stay whole in shared memory: at most 96 KB
  while (D > 384 && p.gp > 1 && size_t(p.gp) * D * sizeof(float) > 96 * 1024) {
    p.gp /= 2;
  }
  p.rowblocks = (p.group + p.gp - 1) / p.gp;
  return p;
}

// The decode launch of one (T, D, GP) instance: its shared memory
// allowed, then (plan) the splits and resident CTAs an SM, or (run) the
// split kernel and the combine.
template <typename T, int D, int GP>
int decode_instance(const DecodePlan& p, const void* q, const void* k,
                    const void* v, void* o, float* ws, float scale,
                    cudaStream_t st, int* splits, int* resident) {
  using Tile = std::conditional_t<D == 0, DecodeTile<T, 128>,
                                  DecodeTile<T, D>>;
  auto kernel = flash_decode_split_kernel<T, D, GP>;
  size_t bytes;
  if constexpr (D == 0) {
    bytes = DecodeChunked<T>::template smem<GP>(p.D);
  } else {
    bytes = decode_smem<T, D, GP>();
  }
  const int ncb = D == 0 ? p.D / 128 : 1;      // column blocks of O
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return int(err);
  }
  const int ctas = p.B * p.Hkv * p.rowblocks;
  if (splits != nullptr) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kDecThreads, bytes);
    }
    if (err != cudaSuccess) return int(err);
    if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
    // the fewest splits that fill a wave and leave the last wave at least
    // 90% full, else the fullest last wave; no chunk shorter than a stage
    const long long slots = (long long)sms * per_sm;
    const int most = min(kDecMaxSplits, (p.Skv + Tile::kTile - 1) / Tile::kTile);
    int best = 1;
    double best_fill = 0.0;
    for (int s = 1; s <= most; ++s) {
      const long long n = (long long)ctas * ncb * s;
      const double fill = double(n) / double((n + slots - 1) / slots * slots);
      if (fill > best_fill) {
        best = s;
        best_fill = fill;
      }
      if (n >= slots && fill >= 0.9) {
        best = s;
        break;
      }
    }
    *splits = decode_splits(p.Skv, best, Tile::kTile);
    *resident = per_sm;
    return 0;
  }
  if (p.splits < 1 || p.splits > kDecMaxSplits ||
      decode_splits(p.Skv, p.splits, Tile::kTile) != p.splits) {
    return int(cudaErrorInvalidValue);
  }
  const int chunk = decode_chunk(p.Skv, p.splits, Tile::kTile);
  kernel<<<dim3(ctas * ncb, p.splits), kDecThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, ws, p.group, p.rowblocks, p.Skv,
      chunk, scale, p.D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long total = (long long)p.B * p.Hq * p.D;
  decode_combine_kernel<T><<<unsigned((total + 255) / 256), 256, 0, st>>>(
      ws, (T*)o, p.D, GP, p.group, p.rowblocks, p.splits, total);
  return int(cudaGetLastError());
}

template <typename T, int D>
int decode_rows(const DecodePlan& p, const void* q, const void* k,
                const void* v, void* o, float* ws, float scale,
                cudaStream_t st, int* splits, int* resident) {
  switch (p.gp) {
    case 1: return decode_instance<T, D, 1>(p, q, k, v, o, ws, scale, st,
                                            splits, resident);
    case 2: return decode_instance<T, D, 2>(p, q, k, v, o, ws, scale, st,
                                            splits, resident);
    case 4: return decode_instance<T, D, 4>(p, q, k, v, o, ws, scale, st,
                                            splits, resident);
    case 8: return decode_instance<T, D, 8>(p, q, k, v, o, ws, scale, st,
                                            splits, resident);
  }
  return int(cudaErrorInvalidValue);
}

int flash_by_dim(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                 float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch_flash<16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                     scale, st);
    case 32: return launch_flash<32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                     scale, st);
    case 64: return launch_flash<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                     scale, st);
    case 128: return launch_flash<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                       causal, scale, st);
    case 256: return launch_flash<256>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                       causal, scale, st);
    case 384: return launch_flash<384>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                       causal, scale, st);
  }
  // past 384: the chunked instance (D a multiple of 128)
  return launch_flash<0>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, st,
                         D);
}

template <typename T>
int decode_by_dim(const DecodePlan& p, const void* q, const void* k,
                  const void* v, void* o, float* ws, float scale,
                  cudaStream_t st, int* splits, int* resident) {
  switch (p.D) {
    case 16: return decode_rows<T, 16>(p, q, k, v, o, ws, scale, st, splits,
                                       resident);
    case 32: return decode_rows<T, 32>(p, q, k, v, o, ws, scale, st, splits,
                                       resident);
    case 64: return decode_rows<T, 64>(p, q, k, v, o, ws, scale, st, splits,
                                       resident);
    case 128: return decode_rows<T, 128>(p, q, k, v, o, ws, scale, st,
                                         splits, resident);
    case 256: return decode_rows<T, 256>(p, q, k, v, o, ws, scale, st,
                                         splits, resident);
    case 384: return decode_rows<T, 384>(p, q, k, v, o, ws, scale, st,
                                         splits, resident);
  }
  if (p.D > 384 && p.D % 128 == 0) {           // the chunked instance
    return decode_rows<T, 0>(p, q, k, v, o, ws, scale, st, splits,
                             resident);
  }
  return int(cudaErrorInvalidValue);
}

int decode_dispatch(int dtype, const DecodePlan& p, const void* q,
                    const void* k, const void* v, void* o, float* ws,
                    float scale, cudaStream_t st, int* splits,
                    int* resident) {
  if (p.B < 1 || p.Hkv < 1 || p.Skv < 1 || p.group < 1 ||
      p.Hq % p.Hkv != 0) {
    return int(cudaErrorInvalidValue);
  }
  if (dtype == kF32) {
    return decode_by_dim<float>(p, q, k, v, o, ws, scale, st, splits,
                                resident);
  }
  if (dtype == kBF16) {
    return decode_by_dim<__nv_bfloat16>(p, q, k, v, o, ws, scale, st, splits,
                                        resident);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace attn

extern "C" {

// bf16 flash attention on the tensor cores (attn_tc_kernels.cu)
int attn_tc_flash(const void* q, const void* k, const void* v, void* o,
                  int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                  float scale, cudaStream_t st);

int attn_flash(int dtype, const void* q, const void* k, const void* v,
               void* o, int B, int Hq, int Hkv, int Sq, int Skv, int D,
               int causal, float scale, void* stream) {
  cudaStream_t st = cudaStream_t(stream);
  if (dtype == attn::kF32) {
    return attn::flash_by_dim(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                              scale, st);
  }
  if (dtype == attn::kBF16) {
    return attn_tc_flash(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale,
                         st);
  }
  return int(cudaErrorInvalidValue);
}

// The split count and resident CTAs an SM that attn_decode will use for
// these shapes, and the workspace (floats) it needs.
int attn_decode_plan(int dtype, int B, int Hq, int Hkv, int Skv, int D,
                     int* splits, int* resident, long long* ws_floats) {
  const attn::DecodePlan p = attn::decode_plan(B, Hq, Hkv, Skv, D, 1);
  int err = attn::decode_dispatch(dtype, p, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, 0.f, nullptr, splits,
                                  resident);
  if (err == 0) *ws_floats = (long long)B * Hkv * p.rowblocks * *splits *
                             p.gp * (D + 2);
  return err;
}

// Split-KV decode: the split kernel writes each split's partial to ws
// (attn_decode_plan's size), the combine merges them into o.
int attn_decode(int dtype, const void* q, const void* k, const void* v,
                void* o, float* ws, int B, int Hq, int Hkv, int Skv, int D,
                int splits, float scale, void* stream) {
  const attn::DecodePlan p = attn::decode_plan(B, Hq, Hkv, Skv, D, splits);
  return attn::decode_dispatch(dtype, p, q, k, v, o, ws, scale,
                               cudaStream_t(stream), nullptr, nullptr);
}

}  // extern "C"
