// Shared __device__ bodies of the CNN kernels (cnn_kernels.cu).
//
// Replaces the shared Pallas bodies of the reference:
//   src/repro/kernels/conv2d/inner.py::accumulate_vpu   -> conv_taps_vpu,
//       conv_part_vpu (a register tile of outputs)
//   src/repro/kernels/conv2d/inner.py::accumulate_mxu   -> conv_taps_mxu,
//       conv_run (a register tile of outputs, of one or two streams)
//   src/repro/kernels/pool2d/vpu_window.py::window_reduce -> window_reduce
//       (window_step, window_end)
//   src/repro/kernels/activation/ref.py::_FNS            -> activate
//
// The standalone kernels (the tiled kernels of conv2d_ip1, conv2d_ip2
// and Conv4, pool2d_window, activation_exact) and the fused
// conv->pool->act kernel all run these functions, in the same order, so
// a float32 fused block is bitwise equal to its three-launch chain and
// each Conv4 stream to a conv2d_ip2 launch: the tiled convs and the
// fused kernel fill their register tiles through the same staging and
// conv bodies (conv1_tile / conv2_tile of cnn_kernels.cu), and the fused
// kernel pools them from shared memory with window_step in
// window_reduce's order.
// Two things keep that true:
//   * every float add and multiply-add is an explicit round-to-nearest
//     intrinsic (__fadd_rn, __fmaf_rn, __fmul_rn, __fdiv_rn), and the
//     library is compiled with -fmad=false, so the compiler cannot
//     contract differently in the two call contexts;
//   * the loop orders below are the reference's orders:
//       vpu: for each tap (i, j): partial = sum over cin; acc += partial
//       mxu: one dot over K flattened as (i, j, cin)
//       pool: start from the window's first element, then i-major;
//             avg divides by kh*kw (integer avg floors, as jnp // does).
//
// The "mxu" order runs on CUDA cores (FP32 FMA, int32 multiply-add for
// int8): Hopper has no IEEE-f32 tensor-core MMA, and TF32 misses the
// reference tolerance.  A 3xTF32 route would change the results of
// conv2d_ip2, conv2d_ip4 and fused_cnn_mxu together (ROADMAP queue 2).
//
// Integer accumulators wrap modulo 2^32, as the reference's int32
// accumulators do (full-range int16 taps overflow them); the sums are
// taken in uint32_t because signed overflow is undefined in C++.
#pragma once

#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

namespace cnn {

enum Mode { kMax = 0, kAvg = 1 };
// Same order as src/repro_torch/kernels/activation/ref.py::KINDS.
enum Kind { kRelu = 0, kRelu6 = 1, kSigmoid = 2, kTanh = 3, kGelu = 4 };

// Accumulator type: float operands (f32, bf16) accumulate in f32,
// integers (int8, int16) in int32.
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int32_t; };
template <> struct AccOf<int16_t> { using type = int32_t; };

// An operand widened to its accumulator type (exact: bf16 -> f32 keeps
// every value, by a 16-bit shift).
template <typename A, typename T>
__device__ __forceinline__ A widen(T v) { return A(v); }
template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A reduce or activation result stored as O: bf16 rounds once to
// nearest even (as torch's .to(torch.bfloat16)), every other type
// converts as C++ does.
template <typename O, typename V>
__device__ __forceinline__ O narrow(V v) { return O(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}

// A zero of T (bf16's constructors from integers are not always
// declared).
template <typename T>
__device__ __forceinline__ T zero() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

struct ConvShape {
  int H, W, Cin, KH, KW, Cout;
};

__device__ __forceinline__ float mac(float acc, float x, float w) {
  return __fmaf_rn(x, w, acc);
}
__device__ __forceinline__ int32_t mac(int32_t acc, int32_t x, int32_t w) {
  return int32_t(uint32_t(acc) + uint32_t(x) * uint32_t(w));
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return int32_t(uint32_t(a) + uint32_t(b));
}

// jnp.maximum / jnp.minimum semantics: a NaN operand gives NaN
// (fmaxf/fminf would drop it).
__device__ __forceinline__ float vmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float vmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ int32_t vmax(int32_t a, int32_t b) {
  return a > b ? a : b;
}

// Average: float divides by the count; integers floor (jnp //), where C
// division would truncate toward zero on negative sums.
__device__ __forceinline__ float avg_div(float sum, int count) {
  return __fdiv_rn(sum, float(count));
}
__device__ __forceinline__ int32_t avg_div(int32_t sum, int count) {
  int32_t q = sum / count;
  if ((sum % count != 0) && (sum < 0)) --q;
  return q;
}

// The Conv1 order (inner.py::accumulate_vpu), for a register tile of NP
// output points x NC output channels: for each tap (i, j), a partial
// that starts at 0 takes the tap's products over the input channels in
// ascending order, then adds into the accumulator.  conv_taps_vpu runs
// the taps; tap(i, j, part) feeds tap (i, j)'s channels into part
// through conv_part_vpu, in one call or in several consecutive ranges
// of channels (the partial carries across them).  KS > 0 fixes the taps
// at KS x KS at compile time, so the tap loops unroll.  Every output is
// the same chain of operations whatever NP, NC, KS and the loaders are.
template <typename A, int NP, int NC, int KS, typename Tap>
__device__ __forceinline__ void conv_taps_vpu(int KH, int KW, Tap tap,
                                              A (&acc)[NP][NC]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int q = 0; q < NC; ++q) acc[p][q] = A(0);
  }
  auto one_tap = [&](int i, int j) {
    A part[NP][NC];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int q = 0; q < NC; ++q) part[p][q] = A(0);
    }
    tap(i, j, part);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int q = 0; q < NC; ++q) acc[p][q] = add(acc[p][q], part[p][q]);
    }
  };
  if constexpr (KS > 0) {
#pragma unroll
    for (int i = 0; i < KS; ++i) {
#pragma unroll
      for (int j = 0; j < KS; ++j) one_tap(i, j);
    }
  } else {
    for (int i = 0; i < KH; ++i) {
      for (int j = 0; j < KW; ++j) one_tap(i, j);
    }
  }
}

// n channels of one tap into part, in ascending order: load(c, xv, wv)
// yields the NP points' inputs and the NC channels' weights of channel c.
template <typename A, int NP, int NC, typename Load>
__device__ __forceinline__ void conv_part_vpu(int n, Load load,
                                              A (&part)[NP][NC]) {
  for (int c = 0; c < n; ++c) {
    A xv[NP], wv[NC];
    load(c, xv, wv);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int q = 0; q < NC; ++q) part[p][q] = mac(part[p][q], xv[p], wv[q]);
    }
  }
}

// Conv2 order (inner.py::accumulate_mxu), for a register tile of NP
// output points x NC output channels: ONE chain per output over K =
// (i, j, cin), starting from 0.  conv_taps_mxu runs the taps in (i, j)
// order; tap(i, j, acc) feeds tap (i, j)'s channels into acc through
// conv_run, in one call or in several consecutive ranges of channels.
// KS > 0 fixes the taps at KS x KS at compile time, so the tap loops
// unroll.  Every output is the same chain of operations whatever NP,
// NC, KS, U and the loaders are.
template <typename A, int NP, int NC, int KS, typename Tap>
__device__ __forceinline__ void conv_taps_mxu(int KH, int KW, Tap tap,
                                              A (&acc)[NP][NC]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int q = 0; q < NC; ++q) acc[p][q] = A(0);
  }
  if constexpr (KS > 0) {
#pragma unroll
    for (int i = 0; i < KS; ++i) {
#pragma unroll
      for (int j = 0; j < KS; ++j) tap(i, j, acc);
    }
  } else {
    for (int i = 0; i < KH; ++i) {
      for (int j = 0; j < KW; ++j) tap(i, j, acc);
    }
  }
}

// n channels (a multiple of U) into acc, in ascending order, U at a
// time: load(c, xv, wv) yields channels c .. c + U - 1 of the NP points'
// inputs, xv[p][u], and of the NC channels' weights, wv[u][q].  It is
// called once for each c in turn, so a loader may walk pointers.
template <typename A, int NP, int NC, int U, typename Load>
__device__ __forceinline__ void conv_run(int n, Load load,
                                         A (&acc)[NP][NC]) {
  for (int c = 0; c < n; c += U) {
    A xv[NP][U], wv[U][NC];
    load(c, xv, wv);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          acc[p][q] = mac(acc[p][q], xv[p][u], wv[u][q]);
        }
      }
    }
  }
}

// vpu_window.py::window_reduce, a step at a time: window_step takes the
// value v of tap (i, j) into acc (tap (0, 0) starts it), window_end
// divides an average.  Taps fed in i-major order from (0, 0) are
// window_reduce's chain, however a caller splits them.
template <typename V>
__device__ __forceinline__ V window_step(V acc, V v, int i, int j,
                                         int mode) {
  if (i == 0 && j == 0) return v;
  return (mode == kMax) ? vmax(acc, v) : add(acc, v);
}
template <typename V>
__device__ __forceinline__ V window_end(V acc, int kh, int kw, int mode) {
  return (mode == kAvg) ? avg_div(acc, kh * kw) : acc;
}

// vpu_window.py::window_reduce for one output: load(i, j) yields the
// window element at tap (i, j).
template <typename V, typename Load>
__device__ __forceinline__ V window_reduce(Load load, int kh, int kw,
                                           int mode) {
  V acc = load(0, 0);
  for (int i = 0; i < kh; ++i) {
    for (int j = 0; j < kw; ++j) {
      if (i == 0 && j == 0) continue;
      acc = window_step(acc, V(load(i, j)), i, j, mode);
    }
  }
  return window_end(acc, kh, kw, mode);
}

// activation/ref.py::_FNS in f32.  gelu is jax.nn.gelu's default, the
// tanh approximation.  expf/tanhf, not the __expf intrinsics.
__device__ __forceinline__ float activate(float x, int kind) {
  switch (kind) {
    case kRelu:
      return vmax(x, 0.0f);
    case kRelu6:
      return vmin(vmax(x, 0.0f), 6.0f);
    case kSigmoid:
      return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
    case kTanh:
      return tanhf(x);
    default: {  // kGelu
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      float cube = __fmul_rn(__fmul_rn(x, x), x);
      float inner = __fmul_rn(k, __fadd_rn(x, __fmul_rn(0.044715f, cube)));
      float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner)));
      return __fmul_rn(x, cdf);
    }
  }
}

}  // namespace cnn
