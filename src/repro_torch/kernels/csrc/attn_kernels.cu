// The CUDA-core attention kernels of the port: two __global__ kernels and
// their plain C launchers, loaded with ctypes by
// src/repro_torch/kernels/cuda.py.  bf16 flash attention runs on the
// tensor cores instead (attn_tc_kernels.cu; attn_flash hands it over).
//
// Built with the flags of cnn_kernels.cu (-fmad=false; widen and vmax
// from cnn_device.cuh).  q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) are
// contiguous, of one dtype: f32, or (decode) bf16 widened exactly to f32
// on load; the output has q's dtype (bf16 by __float2bfloat16_rn).  q
// head h reads kv head h / (Hq / Hkv) (GQA).  Scores, softmax state and
// accumulators are f32, as in the reference: q is scaled by D^-0.5 (the
// f32 of the wrapper's Python float) before the dot, masked scores are
// -1e30, the normalizer is clamped at 1e-30.  Both kernels merge key
// blocks through one online-softmax step (online_softmax_step).  Dots
// and sums are explicit __fmaf_rn / __fadd_rn chains on CUDA cores and
// exponentials are expf.
//
// flash_attention_kernel<float, D>
//   replaces src/repro/kernels/attention/flash.py::flash_attention on f32
//   4*B*Hq*D operations per visible (query, key) pair on
//   (2*B*Hq*Sq + 2*B*Hkv*Skv)*D elements moved: compute-bound at
//   training shapes (the bf16 tensor-core peak is the card's bound).
//   One CTA per (b*Hq + h, block of kBq = 64 query rows); a query row
//   belongs to TPR = max(1, D/32) neighbouring threads, each holding 32
//   (or D) of its q values and accumulators in registers, interleaved
//   by float4 so the threads of a row read neighbouring shared-memory
//   words.  K and V tiles of kBk = 32 keys are staged in shared memory
//   as f32 with 16-byte loads.  Keys past Skv are masked by bounds
//   checks (no padding); with causal, key j is visible to row i when
//   j <= i + Skv - Sq, and the key loop stops at the last key any row of
//   the block sees (the reference skips the same blocks).  A row that
//   sees no key (causal with Sq > Skv) is written as 0.
//
// flash_decode_kernel<T, D>
//   replaces src/repro/kernels/attention/decode.py::flash_decode
//   One query token per head against the whole cache: device memory
//   bounds it (2*B*Hkv*Skv*D elements read once).  One CTA of 256
//   threads per (b, kv head); its GQA group's q rows are the q tile.
//   The cache streams in blocks of kDecBk = 64 keys (16-byte loads into
//   shared memory, rows padded to D + 1 words so threads reading
//   different keys hit different banks); scores one (row, key) per
//   thread, the online step one warp per row, the accumulator update
//   one (row, dim) per thread.  The accumulators live in shared memory,
//   so any group size fits that the card's shared memory holds.
#include <cuda_runtime.h>

#include <cstdint>

#include "cnn_device.cuh"

namespace attn {

using cnn::vmax;
using cnn::widen;

enum DType { kF32 = 0, kBF16 = 4 };   // codes of cnn_kernels.cu

constexpr float kMasked = -1e30f;     // the reference's _NEG_INF
constexpr float kMinNorm = 1e-30f;    // l clamp before the division
constexpr int kBq = 64;               // flash: query rows per CTA
constexpr int kBk = 32;               // flash: keys per shared tile
constexpr int kDecBk = 64;            // decode: keys per shared tile
constexpr int kDecThreads = 256;

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

// Stage rows [k0, k0 + kRows) of one head's (S, D) slice into shared
// memory as f32, `stride` words apart; rows at or past S are zero.
// 16-byte loads: D * sizeof(T) is a multiple of 16 for every D the
// kernels take, and the wrapper checks that each tensor starts aligned.
template <typename T, int D, int kRows>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* dst, int stride, int k0,
                                           int S) {
  constexpr int kVec = 16 / sizeof(T);
  for (int e = threadIdx.x * kVec; e < kRows * D; e += blockDim.x * kVec) {
    const int j = e / D, d = e % D;
    float* out = dst + j * stride + d;
    if (k0 + j < S) {
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(src + size_t(k0 + j) * D + d));
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[i] = widen<float>(vals[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[i] = 0.f;
    }
  }
}

template <int D> struct RowSplit {
  static constexpr int kThreads = D >= 32 ? D / 32 : 1;   // per query row
  static constexpr int kDims = D / kThreads;              // per thread
};

template <typename T, int D>
__global__ void __launch_bounds__(kBq * RowSplit<D>::kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int Hkv, int Sq, int Skv, int causal, float scale) {
  constexpr int TPR = RowSplit<D>::kThreads;
  constexpr int DT = RowSplit<D>::kDims;
  constexpr int NC = DT / 4;                  // float4 chunks per thread
  __shared__ __align__(16) float ks[kBk * D];
  __shared__ __align__(16) float vs[kBk * D];
  const int bh = blockIdx.x;                  // b * Hq + h
  const int group = Hq / Hkv;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / group;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int q0 = blockIdx.y * kBq, qi = q0 + row;
  const int offs = Skv - Sq;
  const bool live = qi < Sq;
  // chunk c of this thread covers dims 4 * (c * TPR + part) + 0..3
  float qv[DT], acc[DT];
  const T* qrow = q + (size_t(bh) * Sq + qi) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * (c * TPR + part) + i;
      qv[4 * c + i] = live ? __fmul_rn(widen<float>(qrow[d]), scale) : 0.f;
      acc[4 * c + i] = 0.f;
    }
  }
  float m = kMasked, l = 0.f;
  // keys past q0 + kBq - 1 + offs are masked for every row of the block
  const int kv_end = causal ? min(Skv, q0 + kBq + offs) : Skv;
  const T* kh = k + size_t(kvh) * Skv * D;
  const T* vh = v + size_t(kvh) * Skv * D;
  for (int k0 = 0; k0 < kv_end; k0 += kBk) {
    __syncthreads();                          // the last tile is consumed
    stage_rows<T, D, kBk>(kh, ks, D, k0, Skv);
    stage_rows<T, D, kBk>(vh, vs, D, k0, Skv);
    __syncthreads();
    float s[kBk];
    float tile_max = kMasked;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      const float* kr = ks + j * D;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(kr + 4 * (c * TPR + part));
        dot = __fmaf_rn(qv[4 * c], kk.x, dot);
        dot = __fmaf_rn(qv[4 * c + 1], kk.y, dot);
        dot = __fmaf_rn(qv[4 * c + 2], kk.z, dot);
        dot = __fmaf_rn(qv[4 * c + 3], kk.w, dot);
      }
#pragma unroll
      for (int x = 1; x < TPR; x <<= 1) {
        dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, x));
      }
      const int kp = k0 + j;
      const bool visible = kp < Skv && (!causal || kp <= qi + offs);
      s[j] = visible ? dot : kMasked;
      tile_max = vmax(tile_max, s[j]);
    }
    const float alpha = online_softmax_step(m, l, tile_max);
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i] = __fmul_rn(acc[i], alpha);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      const float p = expf(__fsub_rn(s[j], m));
      psum = __fadd_rn(psum, p);
      const float* vr = vs + j * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vr + 4 * (c * TPR + part));
        acc[4 * c] = __fmaf_rn(p, vv.x, acc[4 * c]);
        acc[4 * c + 1] = __fmaf_rn(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = __fmaf_rn(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = __fmaf_rn(p, vv.w, acc[4 * c + 3]);
      }
    }
    l = __fadd_rn(l, psum);
  }
  if (!live) return;
  const bool sees_a_key = !causal || qi + offs >= 0;
  const float norm = fmaxf(l, kMinNorm);
  T* orow = o + (size_t(bh) * Sq + qi) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * (c * TPR + part) + i;
      orow[d] = narrow<T>(sees_a_key ? __fdiv_rn(acc[4 * c + i], norm) : 0.f);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int group,
                    int Skv, float scale) {
  constexpr int KS = D + 1;                   // padded shared row
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                           // [kDecBk][KS]
  float* vs = ks + kDecBk * KS;               // [kDecBk][KS]
  float* qs = vs + kDecBk * KS;               // [group][D], scaled
  float* acc = qs + group * D;                // [group][D]
  float* ss = acc + group * D;                // [group][kDecBk]
  float* ms = ss + group * kDecBk;            // [group] running max
  float* ls = ms + group;                     // [group] normalizer
  float* alphas = ls + group;                 // [group] this block's alpha
  const int hk = blockIdx.x;                  // b * Hkv + kv head
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kWarps = kDecThreads / 32;
  const int rows = group * D;
  // q heads hk * group .. hk * group + group - 1 are this kv head's group
  const T* qh = q + size_t(hk) * rows;
  for (int e = tid; e < rows; e += kDecThreads) {
    qs[e] = __fmul_rn(widen<float>(qh[e]), scale);
    acc[e] = 0.f;
  }
  for (int g = tid; g < group; g += kDecThreads) {
    ms[g] = kMasked;
    ls[g] = 0.f;
  }
  const T* kh = k + size_t(hk) * Skv * D;
  const T* vh = v + size_t(hk) * Skv * D;
  for (int k0 = 0; k0 < Skv; k0 += kDecBk) {
    __syncthreads();                          // the last block is consumed
    stage_rows<T, D, kDecBk>(kh, ks, KS, k0, Skv);
    stage_rows<T, D, kDecBk>(vh, vs, KS, k0, Skv);
    __syncthreads();
    for (int e = tid; e < group * kDecBk; e += kDecThreads) {
      const int g = e / kDecBk, j = e % kDecBk;
      const float* qr = qs + g * D;
      const float* kr = ks + j * KS;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = __fmaf_rn(qr[d], kr[d], dot);
      ss[e] = k0 + j < Skv ? dot : kMasked;
    }
    __syncthreads();
    for (int g = warp; g < group; g += kWarps) {
      float* sr = ss + g * kDecBk;
      float tile_max = kMasked;
      for (int j = lane; j < kDecBk; j += 32) tile_max = vmax(tile_max, sr[j]);
#pragma unroll
      for (int x = 16; x > 0; x >>= 1) {
        tile_max = vmax(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, x));
      }
      float m = ms[g], l = ls[g];
      const float alpha = online_softmax_step(m, l, tile_max);
      float psum = 0.f;
      for (int j = lane; j < kDecBk; j += 32) {
        const float p = expf(__fsub_rn(sr[j], m));
        sr[j] = p;
        psum = __fadd_rn(psum, p);
      }
#pragma unroll
      for (int x = 16; x > 0; x >>= 1) {
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, x));
      }
      if (lane == 0) {
        ms[g] = m;
        ls[g] = __fadd_rn(l, psum);
        alphas[g] = alpha;
      }
    }
    __syncthreads();
    for (int e = tid; e < rows; e += kDecThreads) {
      const int g = e / D, d = e % D;
      const float* pr = ss + g * kDecBk;
      float a = __fmul_rn(acc[e], alphas[g]);
#pragma unroll 16
      for (int j = 0; j < kDecBk; ++j) a = __fmaf_rn(pr[j], vs[j * KS + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();
  T* oh = o + size_t(hk) * rows;
  for (int e = tid; e < rows; e += kDecThreads) {
    oh[e] = narrow<T>(__fdiv_rn(acc[e], fmaxf(ls[e / D], kMinNorm)));
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, int causal, float scale,
                 cudaStream_t st) {
  dim3 grid(B * Hq, (Sq + kBq - 1) / kBq);
  flash_attention_kernel<T, D><<<grid, kBq * RowSplit<D>::kThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, Sq, Skv, causal,
      scale);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v, void* o, int B,
                  int Hq, int Hkv, int Skv, float scale, cudaStream_t st) {
  const int group = Hq / Hkv;
  const size_t bytes = sizeof(float) * (2 * kDecBk * (D + 1) + 2 * group * D +
                                        group * kDecBk + 3 * group);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(bytes));
    if (err != cudaSuccess) {
      cudaGetLastError();  // a group too large for shared memory: clear it
      return int(err);
    }
  }
  flash_decode_kernel<T, D><<<B * Hkv, kDecThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, group, Skv, scale);
  return int(cudaGetLastError());
}

template <typename T>
int flash_by_dim(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                 float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch_flash<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                        causal, scale, st);
    case 32: return launch_flash<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                        causal, scale, st);
    case 64: return launch_flash<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                        causal, scale, st);
    case 128: return launch_flash<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                          causal, scale, st);
  }
  return int(cudaErrorInvalidValue);
}

template <typename T>
int decode_by_dim(const void* q, const void* k, const void* v, void* o, int B,
                  int Hq, int Hkv, int Skv, int D, float scale,
                  cudaStream_t st) {
  switch (D) {
    case 16: return launch_decode<T, 16>(q, k, v, o, B, Hq, Hkv, Skv, scale, st);
    case 32: return launch_decode<T, 32>(q, k, v, o, B, Hq, Hkv, Skv, scale, st);
    case 64: return launch_decode<T, 64>(q, k, v, o, B, Hq, Hkv, Skv, scale, st);
    case 128:
      return launch_decode<T, 128>(q, k, v, o, B, Hq, Hkv, Skv, scale, st);
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
    return attn::flash_by_dim<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                     causal, scale, st);
  }
  if (dtype == attn::kBF16) {
    return attn_tc_flash(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale,
                         st);
  }
  return int(cudaErrorInvalidValue);
}

int attn_decode(int dtype, const void* q, const void* k, const void* v,
                void* o, int B, int Hq, int Hkv, int Skv, int D, float scale,
                void* stream) {
  cudaStream_t st = cudaStream_t(stream);
  if (dtype == attn::kF32) {
    return attn::decode_by_dim<float>(q, k, v, o, B, Hq, Hkv, Skv, D, scale,
                                      st);
  }
  if (dtype == attn::kBF16) {
    return attn::decode_by_dim<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Skv, D,
                                              scale, st);
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
