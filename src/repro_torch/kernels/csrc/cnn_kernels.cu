// The CNN kernels of the port: seven __global__ kernels and their plain C
// launchers, loaded with ctypes by src/repro_torch/kernels/cuda.py.
//
// Built with: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -fmad=false -shared -Xcompiler -fPIC
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
#include <cuda_runtime.h>

#include <cstdint>

#include "cnn_device.cuh"

namespace cnn {

constexpr int kThreads = 256;
constexpr int kTableSize = 256;
enum Style { kVpu = 0, kMxu = 1 };
enum DType { kF32 = 0, kI8 = 1, kI32 = 2 };

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

}  // extern "C"
