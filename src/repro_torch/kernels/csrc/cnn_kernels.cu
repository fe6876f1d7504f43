// The CNN kernels of the port: nine __global__ kernels and their plain C
// launchers, loaded with ctypes by src/repro_torch/kernels/cuda.py.
//
// Built with: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -fmad=false -Xcompiler -fPIC -c, then linked with
//             mm_kernels.cu's object by nvcc -shared
//
// Layouts are the reference's: NHWC activations, HWIO weights, all
// tensors contiguous.  Every kernel maps one thread to one output element;
// the channel tiling hints (block_cout / block_c) shape the grid and the
// kernel masks the ragged edge, so results never depend on them.  The
// activations' block_rows hints are validated and do not shape a grid.
//
// Kernel notes (what each replaces, what bounds it on the H100, and what
// this design does about it):
//
// conv2d_kernel<T, kVpu>  replaces src/repro/kernels/conv2d/ip1_vpu.py::conv2d_ip1
// conv2d_kernel<T, kMxu>  replaces src/repro/kernels/conv2d/ip2_mxu.py::conv2d_ip2
//   2*K flops per 4-byte output, K = KH*KW*Cin.  The FP32 ridge point of
//   the H100 SXM is 67 TFLOP/s / 3.35 TB/s = 20 flops per byte, so at
//   block 0 (K = 27) device memory bounds the ideal kernel and at block 1
//   (K = 144) the FP32 CUDA-core rate does.  This version runs on CUDA
//   cores (FMA / int32 multiply-add), one thread per output, re-reading
//   each input window through L1/L2 once per output channel; threads of a
//   block cover neighbouring output channels of the same pixels, so the
//   re-reads hit cache.  Shared-memory tiling and tensor cores are later
//   work (ROADMAP queue 2).
//
// pool2d_kernel           replaces src/repro/kernels/pool2d/vpu_window.py::pool2d_window
//   kh*kw compares or adds per output: bound by device memory.  One thread
//   per output, neighbouring threads on neighbouring channels, so loads
//   and stores coalesce along C.
//
// activation_kernel       replaces src/repro/kernels/activation/vpu_exact.py::activation_exact
//   A few flops per 4-byte element (tanh/gelu a few tens): bound by device
//   memory.  One thread per element, neighbouring threads on neighbouring
//   addresses, so loads and stores coalesce.
//
// activation_lut_kernel   replaces src/repro/kernels/activation/lut_poly.py::activation_lut
//   One f32 index computation and one table read per 4-byte element:
//   bound by device memory (the 1 KB table stays on chip).  Each block
//   first copies the 256-entry table into shared memory, so the gather
//   never leaves the SM; then one thread per element, neighbouring
//   threads on neighbouring addresses.  The index is
//   rintf(__fmul_rn(__fadd_rn(x, r), s)) (rint: half to even, as
//   jnp.round), clamped fmaxf(.., 0) first so NaN lands on entry 0.
//
// pool2d_im2col_kernel    replaces src/repro/kernels/pool2d/mxu_im2col.py::pool2d_im2col
//   kh*kw loads and adds (or compares) per output: bound by device
//   memory.  The TPU kernel stacks the taps into a VMEM patch tensor so
//   that avg becomes one MXU pass, ones(1, kh*kw) @ patches.  On Hopper
//   a one-row product would waste the tensor cores and TF32 would miss
//   f32 exactness, so the "patch" is each thread's tap loop in
//   registers and the ones-product is kh*kw adds on CUDA cores, taken in
//   the stacked (i-major) order; integer avg floors.  One thread per
//   output, neighbouring threads on neighbouring channels, so loads and
//   stores coalesce along C.
//
// fused_cnn_kernel<T, S>  replaces src/repro/kernels/fused/cnn_block.py::_fused_call
//   (members fused_cnn_vpu / fused_cnn_mxu).  One thread per pooled output
//   (n, po, qo, co) computes the ph*pw conv values its window needs with
//   the shared conv body, rescales them (int8 rung), reduces the window,
//   applies the activation and writes once: the conv and pool
//   intermediates never reach device memory, which is what the fusion
//   buys.  With the conv output's bytes gone, both served blocks are
//   bound by the FP32 rate of their conv flops; the bodies are the
//   standalone conv's, so the same later tiling work applies.
//
// conv2d_ip3_kernel       replaces src/repro/kernels/conv2d/ip3_packed.py::conv2d_ip3
//   Conv3: two int8 convs sharing one weight tensor, ONE int32 multiply
//   per tap pair.  Per tap the two int8 operands are packed as
//   p = a * 65536 + b (a multiplication, not a << 16: shifting a
//   negative int is undefined in C++17), m = p * w (|m| < 2^31 for int8),
//   b*w is the signed low 16 bits of m and a*w = (m - low) / 65536, an
//   exact division.  Logic-only: IMAD and ALU ops, no MMA instruction.
//   The work is two convs' taps on the INT32 lanes (64 per SM, half the
//   FP32 lanes), so the lane rate bounds it at block 1; one thread per
//   output pixel and channel writes both streams, as conv2d_kernel.
//
// conv2d_ip4_kernel<T>    replaces src/repro/kernels/conv2d/ip4_dual.py::conv2d_ip4
//   Conv4: two full-precision convs (int8/int16 -> int32, bf16/f32 ->
//   f32) sharing each weight tap.  One thread per output pixel and
//   channel runs conv_points_mxu with two streams: each tap is loaded
//   once and feeds both accumulators, in Conv2's order, so each stream
//   is bitwise equal to a conv2d_ip2 launch.  2*K flops per output of
//   each stream: the FP32 rate bounds it at block 1, as for Conv2.
#include <cuda_runtime.h>

#include <cstdint>

#include "cnn_device.cuh"

namespace cnn {

constexpr int kThreads = 256;
constexpr int kTableSize = 256;
enum Style { kVpu = 0, kMxu = 1 };
enum DType { kF32 = 0, kI8 = 1, kI32 = 2, kI16 = 3, kBF16 = 4 };

template <typename T, int STYLE>
__device__ __forceinline__ typename AccOf<T>::type conv_point(
    const T* __restrict__ x, const T* __restrict__ w, const ConvShape& s,
    int n, int oh, int ow, int co) {
  if constexpr (STYLE == kVpu) {
    return conv_point_vpu<T>(x, w, s, n, oh, ow, co);
  } else {
    return conv_point_mxu<T>(x, w, s, n, oh, ow, co);
  }
}

// Thread -> (pixel p, channel co) over a (pixels, channel tiles of bc) grid.
struct Slot {
  long long p;
  int co;
  bool live;
};

__device__ __forceinline__ Slot slot(long long pixels, int channels, int bc) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  Slot s;
  s.p = idx / bc;
  s.co = blockIdx.y * bc + int(idx % bc);
  s.live = s.p < pixels && s.co < channels;
  return s;
}

template <typename T, int STYLE>
__global__ void conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                              typename AccOf<T>::type* __restrict__ y, int N,
                              ConvShape s, int Ho, int Wo, int bc) {
  Slot t = slot((long long)N * Ho * Wo, s.Cout, bc);
  if (!t.live) return;
  int ow = int(t.p % Wo);
  long long r = t.p / Wo;
  int oh = int(r % Ho);
  int n = int(r / Ho);
  y[t.p * s.Cout + t.co] = conv_point<T, STYLE>(x, w, s, n, oh, ow, t.co);
}

// V: the reduce type (f32 or int32); O: the stored type.
template <typename T, typename V, typename O>
__global__ void pool2d_kernel(const T* __restrict__ x, O* __restrict__ y,
                              int N, int H, int W, int C, int KH, int KW,
                              int SH, int SW, int Ho, int Wo, int mode,
                              int bc) {
  Slot t = slot((long long)N * Ho * Wo, C, bc);
  if (!t.live) return;
  int ow = int(t.p % Wo);
  long long r = t.p / Wo;
  int oh = int(r % Ho);
  int n = int(r / Ho);
  const T* base = x + ((size_t(n) * H + size_t(oh) * SH) * W +
                       size_t(ow) * SW) * C + t.co;
  auto load = [&](int i, int j) -> V {
    return V(base[(size_t(i) * W + j) * C]);
  };
  y[t.p * C + t.co] = O(window_reduce<V>(load, KH, KW, mode));
}

// One thread per element over a flat 1-D grid.
template <typename T>
__global__ void activation_kernel(const T* __restrict__ x,
                                  float* __restrict__ y, long long numel,
                                  int kind) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < numel) y[i] = activate(float(x[i]), kind);
}

// One thread per element; the block stages the table in shared memory.
template <typename T>
__global__ void activation_lut_kernel(const T* __restrict__ x,
                                      const float* __restrict__ table,
                                      float* __restrict__ y,
                                      long long numel, float r, float s) {
  __shared__ float lut[kTableSize];
  for (int k = threadIdx.x; k < kTableSize; k += blockDim.x) {
    lut[k] = table[k];
  }
  __syncthreads();
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= numel) return;
  float q = rintf(__fmul_rn(__fadd_rn(float(x[i]), r), s));
  q = fminf(fmaxf(q, 0.0f), float(kTableSize - 1));   // NaN -> 0
  y[i] = lut[int(q)];
}

// The taps in stacked order (i-major): max over them, or their sum and
// the count's division (integer: floor).
template <typename T, typename V, typename O>
__global__ void pool2d_im2col_kernel(const T* __restrict__ x,
                                     O* __restrict__ y, int N, int H, int W,
                                     int C, int KH, int KW, int SH, int SW,
                                     int Ho, int Wo, int mode, int bc) {
  Slot t = slot((long long)N * Ho * Wo, C, bc);
  if (!t.live) return;
  int ow = int(t.p % Wo);
  long long r = t.p / Wo;
  int oh = int(r % Ho);
  int n = int(r / Ho);
  const T* base = x + ((size_t(n) * H + size_t(oh) * SH) * W +
                       size_t(ow) * SW) * C + t.co;
  V acc = V(base[0]);
  for (int tap = 1; tap < KH * KW; ++tap) {
    V v = V(base[(size_t(tap / KW) * W + tap % KW) * C]);
    acc = (mode == kMax) ? vmax(acc, v) : add(acc, v);
  }
  if (mode == kAvg) acc = avg_div(acc, KH * KW);
  y[t.p * C + t.co] = O(acc);
}

template <typename T, int STYLE>
__global__ void fused_cnn_kernel(const T* __restrict__ x,
                                 const T* __restrict__ w,
                                 const float* __restrict__ scale,
                                 float* __restrict__ y, int N, ConvShape s,
                                 int PH, int PW, int SH, int SW, int Po,
                                 int Qo, int mode, int kind, int bc) {
  using A = typename AccOf<T>::type;
  Slot t = slot((long long)N * Po * Qo, s.Cout, bc);
  if (!t.live) return;
  int qo = int(t.p % Qo);
  long long r = t.p / Qo;
  int po = int(r % Po);
  int n = int(r / Po);
  int co = t.co;
  auto conv_at = [&](int i, int j) -> A {
    return conv_point<T, STYLE>(x, w, s, n, po * SH + i, qo * SW + j, co);
  };
  float pooled;
  if (scale != nullptr) {
    // int8 rung: the int32 accumulator is rescaled in register, then
    // pooled in f32 (cnn_block.py:71-75).
    float sc = scale[co];
    auto load = [&](int i, int j) -> float {
      return __fmul_rn(float(conv_at(i, j)), sc);
    };
    pooled = window_reduce<float>(load, PH, PW, mode);
  } else {
    pooled = float(window_reduce<A>(conv_at, PH, PW, mode));
  }
  y[t.p * s.Cout + co] = activate(pooled, kind);
}

// Conv3: both int8 streams through one multiply per tap pair; the two
// products are recovered exactly from the packed product and summed into
// two wrapping int32 accumulators.
__global__ void conv2d_ip3_kernel(const int8_t* __restrict__ xa,
                                  const int8_t* __restrict__ xb,
                                  const int8_t* __restrict__ w,
                                  int32_t* __restrict__ ya,
                                  int32_t* __restrict__ yb, int N,
                                  ConvShape s, int Ho, int Wo, int bc) {
  Slot t = slot((long long)N * Ho * Wo, s.Cout, bc);
  if (!t.live) return;
  int ow = int(t.p % Wo);
  long long r = t.p / Wo;
  int oh = int(r % Ho);
  int n = int(r / Ho);
  uint32_t acc_a = 0, acc_b = 0;
  for (int i = 0; i < s.KH; ++i) {
    for (int j = 0; j < s.KW; ++j) {
      size_t xo = ((size_t(n) * s.H + oh + i) * s.W + ow + j) * s.Cin;
      const int8_t* wp = w + (size_t(i) * s.KW + j) * s.Cin * s.Cout + t.co;
      for (int c = 0; c < s.Cin; ++c) {
        int32_t p = int32_t(xa[xo + c]) * 65536 + int32_t(xb[xo + c]);
        int32_t m = p * int32_t(wp[size_t(c) * s.Cout]);
        int32_t low = int32_t((uint32_t(m) + 32768u) & 0xFFFFu) - 32768;
        int32_t high = (m - low) / 65536;
        acc_a += uint32_t(high);
        acc_b += uint32_t(low);
      }
    }
  }
  ya[t.p * s.Cout + t.co] = int32_t(acc_a);
  yb[t.p * s.Cout + t.co] = int32_t(acc_b);
}

// Conv4: two streams through the shared Conv2 body, each tap loaded once.
template <typename T>
__global__ void conv2d_ip4_kernel(const T* __restrict__ xa,
                                  const T* __restrict__ xb,
                                  const T* __restrict__ w,
                                  typename AccOf<T>::type* __restrict__ ya,
                                  typename AccOf<T>::type* __restrict__ yb,
                                  int N, ConvShape s, int Ho, int Wo, int bc) {
  Slot t = slot((long long)N * Ho * Wo, s.Cout, bc);
  if (!t.live) return;
  int ow = int(t.p % Wo);
  long long r = t.p / Wo;
  int oh = int(r % Ho);
  int n = int(r / Ho);
  const T* const xs[2] = {xa, xb};
  typename AccOf<T>::type acc[2];
  conv_points_mxu<T, 2>(xs, w, s, n, oh, ow, t.co, acc);
  ya[t.p * s.Cout + t.co] = acc[0];
  yb[t.p * s.Cout + t.co] = acc[1];
}

inline unsigned blocks_for(long long items) {
  return unsigned((items + kThreads - 1) / kThreads);
}

}  // namespace cnn

using namespace cnn;

extern "C" {

const char* cnn_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

int cnn_conv2d(int style, int dtype, const void* x, const void* w, void* y,
               int N, int H, int W, int Cin, int KH, int KW, int Cout, int bc,
               void* stream) {
  ConvShape s{H, W, Cin, KH, KW, Cout};
  int Ho = H - KH + 1, Wo = W - KW + 1;
  dim3 grid(blocks_for((long long)N * Ho * Wo * bc), (Cout + bc - 1) / bc);
  cudaStream_t st = cudaStream_t(stream);
  if (dtype == kF32 && style == kVpu) {
    conv2d_kernel<float, kVpu><<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)w, (float*)y, N, s, Ho, Wo, bc);
  } else if (dtype == kF32 && style == kMxu) {
    conv2d_kernel<float, kMxu><<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)w, (float*)y, N, s, Ho, Wo, bc);
  } else if (dtype == kI8 && style == kVpu) {
    conv2d_kernel<int8_t, kVpu><<<grid, kThreads, 0, st>>>(
        (const int8_t*)x, (const int8_t*)w, (int32_t*)y, N, s, Ho, Wo, bc);
  } else if (dtype == kI8 && style == kMxu) {
    conv2d_kernel<int8_t, kMxu><<<grid, kThreads, 0, st>>>(
        (const int8_t*)x, (const int8_t*)w, (int32_t*)y, N, s, Ho, Wo, bc);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

int cnn_pool2d(int dtype, int mode, const void* x, void* y, int N, int H,
               int W, int C, int KH, int KW, int SH, int SW, int bc,
               void* stream) {
  int Ho = (H - KH) / SH + 1, Wo = (W - KW) / SW + 1;
  dim3 grid(blocks_for((long long)N * Ho * Wo * bc), (C + bc - 1) / bc);
  cudaStream_t st = cudaStream_t(stream);
#define CNN_POOL(T, V, O)                                                  \
  pool2d_kernel<T, V, O><<<grid, kThreads, 0, st>>>(                       \
      (const T*)x, (O*)y, N, H, W, C, KH, KW, SH, SW, Ho, Wo, mode, bc)
  if (dtype == kF32) {
    CNN_POOL(float, float, float);
  } else if (dtype == kI8 && mode == kMax) {
    CNN_POOL(int8_t, int32_t, int8_t);
  } else if (dtype == kI8 && mode == kAvg) {
    CNN_POOL(int8_t, int32_t, int32_t);
  } else if (dtype == kI32) {
    CNN_POOL(int32_t, int32_t, int32_t);
  } else {
    return int(cudaErrorInvalidValue);
  }
#undef CNN_POOL
  return int(cudaGetLastError());
}

int cnn_activation(int dtype, int kind, const void* x, float* y,
                   long long numel, void* stream) {
  unsigned grid = blocks_for(numel);
  cudaStream_t st = cudaStream_t(stream);
  if (dtype == kF32) {
    activation_kernel<float><<<grid, kThreads, 0, st>>>((const float*)x, y,
                                                        numel, kind);
  } else if (dtype == kI8) {
    activation_kernel<int8_t><<<grid, kThreads, 0, st>>>((const int8_t*)x, y,
                                                         numel, kind);
  } else if (dtype == kI32) {
    activation_kernel<int32_t><<<grid, kThreads, 0, st>>>((const int32_t*)x,
                                                          y, numel, kind);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

int cnn_activation_lut(int dtype, const void* x, const float* table,
                       float* y, long long numel, float r, float s,
                       void* stream) {
  unsigned grid = blocks_for(numel);
  cudaStream_t st = cudaStream_t(stream);
#define CNN_LUT(T)                                                          \
  activation_lut_kernel<T><<<grid, kThreads, 0, st>>>((const T*)x, table,   \
                                                      y, numel, r, s)
  if (dtype == kF32) {
    CNN_LUT(float);
  } else if (dtype == kI8) {
    CNN_LUT(int8_t);
  } else if (dtype == kI32) {
    CNN_LUT(int32_t);
  } else {
    return int(cudaErrorInvalidValue);
  }
#undef CNN_LUT
  return int(cudaGetLastError());
}

int cnn_pool2d_im2col(int dtype, int mode, const void* x, void* y, int N,
                      int H, int W, int C, int KH, int KW, int SH, int SW,
                      int bc, void* stream) {
  int Ho = (H - KH) / SH + 1, Wo = (W - KW) / SW + 1;
  dim3 grid(blocks_for((long long)N * Ho * Wo * bc), (C + bc - 1) / bc);
  cudaStream_t st = cudaStream_t(stream);
#define CNN_IM2COL(T, V, O)                                                 \
  pool2d_im2col_kernel<T, V, O><<<grid, kThreads, 0, st>>>(                 \
      (const T*)x, (O*)y, N, H, W, C, KH, KW, SH, SW, Ho, Wo, mode, bc)
  if (dtype == kF32) {
    CNN_IM2COL(float, float, float);
  } else if (dtype == kI8 && mode == kMax) {
    CNN_IM2COL(int8_t, int32_t, int8_t);
  } else if (dtype == kI8 && mode == kAvg) {
    CNN_IM2COL(int8_t, int32_t, int32_t);
  } else if (dtype == kI32) {
    CNN_IM2COL(int32_t, int32_t, int32_t);
  } else {
    return int(cudaErrorInvalidValue);
  }
#undef CNN_IM2COL
  return int(cudaGetLastError());
}

int cnn_fused(int style, int dtype, const void* x, const void* w,
              const float* scale, float* y, int N, int H, int W, int Cin,
              int KH, int KW, int Cout, int PH, int PW, int SH, int SW,
              int mode, int kind, int bc, void* stream) {
  ConvShape s{H, W, Cin, KH, KW, Cout};
  int Po = (H - KH + 1 - PH) / SH + 1, Qo = (W - KW + 1 - PW) / SW + 1;
  dim3 grid(blocks_for((long long)N * Po * Qo * bc), (Cout + bc - 1) / bc);
  cudaStream_t st = cudaStream_t(stream);
#define CNN_FUSED(T, S)                                                     \
  fused_cnn_kernel<T, S><<<grid, kThreads, 0, st>>>(                        \
      (const T*)x, (const T*)w, scale, y, N, s, PH, PW, SH, SW, Po, Qo,     \
      mode, kind, bc)
  if (dtype == kF32 && style == kVpu) {
    CNN_FUSED(float, kVpu);
  } else if (dtype == kF32 && style == kMxu) {
    CNN_FUSED(float, kMxu);
  } else if (dtype == kI8 && style == kVpu) {
    CNN_FUSED(int8_t, kVpu);
  } else if (dtype == kI8 && style == kMxu) {
    CNN_FUSED(int8_t, kMxu);
  } else {
    return int(cudaErrorInvalidValue);
  }
#undef CNN_FUSED
  return int(cudaGetLastError());
}

// ip: 3 (Conv3, int8 only) or 4 (Conv4).
int cnn_conv2d_dual(int ip, int dtype, const void* xa, const void* xb,
                    const void* w, void* ya, void* yb, int N, int H, int W,
                    int Cin, int KH, int KW, int Cout, int bc,
                    void* stream) {
  ConvShape s{H, W, Cin, KH, KW, Cout};
  int Ho = H - KH + 1, Wo = W - KW + 1;
  dim3 grid(blocks_for((long long)N * Ho * Wo * bc), (Cout + bc - 1) / bc);
  cudaStream_t st = cudaStream_t(stream);
#define CNN_IP4(T)                                                          \
  conv2d_ip4_kernel<T><<<grid, kThreads, 0, st>>>(                          \
      (const T*)xa, (const T*)xb, (const T*)w,                              \
      (AccOf<T>::type*)ya, (AccOf<T>::type*)yb, N, s, Ho, Wo, bc)
  if (ip == 3 && dtype == kI8) {
    conv2d_ip3_kernel<<<grid, kThreads, 0, st>>>(
        (const int8_t*)xa, (const int8_t*)xb, (const int8_t*)w,
        (int32_t*)ya, (int32_t*)yb, N, s, Ho, Wo, bc);
  } else if (ip == 4 && dtype == kF32) {
    CNN_IP4(float);
  } else if (ip == 4 && dtype == kBF16) {
    CNN_IP4(__nv_bfloat16);
  } else if (ip == 4 && dtype == kI8) {
    CNN_IP4(int8_t);
  } else if (ip == 4 && dtype == kI16) {
    CNN_IP4(int16_t);
  } else {
    return int(cudaErrorInvalidValue);
  }
#undef CNN_IP4
  return int(cudaGetLastError());
}

}  // extern "C"
