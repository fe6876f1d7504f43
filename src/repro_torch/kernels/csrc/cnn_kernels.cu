// The CNN kernels of the port: eight __global__ kernels and their plain C
// launchers, loaded with ctypes by src/repro_torch/kernels/cuda.py.
//
// Built with: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -fmad=false -Xcompiler -fPIC -c, then linked with
//             mm_kernels.cu's object by nvcc -shared
//
// Layouts are the reference's: NHWC activations, HWIO weights, all
// tensors contiguous.  Operand dtypes: the convs and the fused block take
// f32, bf16 (widened exactly into f32 accumulators), int8 and int16
// (int32 accumulators); the pools and activations f32, bf16, int8 and
// int32.  Every kernel but the tiled convs (Conv1's, and Conv2's, which
// Conv4 runs with two streams) and activation_kernel maps one thread to
// one output element; those two tile outputs and stage their inputs in
// shared memory.  The channel tiling hints (block_cout /
// block_c) shape the grid and the kernels mask the ragged edge, so
// results never depend on them.  The activations' block_rows hints are validated and do not
// shape a grid.
//
// Kernel notes (what each replaces, what bounds it on the H100, and what
// this design does about it):
//
// conv2d_vpu_tiled_kernel<T, KS, WHOLE>  replaces src/repro/kernels/conv2d/ip1_vpu.py::conv2d_ip1
//   2*K operations per 4-byte output, K = KH*KW*Cin.  The FP32 ridge
//   point of the H100 SXM is 67 TFLOP/s / 3.35 TB/s = 20 per byte, so at
//   block 0 (K = 27) device memory bounds it, mostly the output's
//   writes, and at block 1 (K = 144) the FP32 rate does.  A CTA of 256
//   threads owns th x tw output pixels of one image and 4 << glog output
//   channels (the tile plan of kernels/conv2d/inner.py::tile_plan).
//   It stages the input halo, (th + KH - 1) x (tw + KW - 1) x Cin, and
//   every tap's weights in shared memory once, the halo's rows with
//   16-byte cp.async where they are aligned; where that does not fit
//   (large Cin), it stages each (tap, chunk of Cin) in turn instead.
//   Each thread keeps 8 pixels x 4 channels in registers, so every
//   input it loads feeds 4 channels and every weight (one 16-byte load
//   for 4 channels) 8 pixels; stores are 16 bytes along Cout where Cout
//   allows.  Index math is 32-bit, the (n, tile) split once per CTA.
//   Each output is the Conv1 chain of cnn_device.cuh (conv_taps_vpu),
//   as the fused kernel computes it; KS = 3 unrolls the 3 x 3 taps.
//   Logic-only: FFMA / IMAD, no MMA instruction.
//
// conv2d_mxu_tiled_kernel<T, NS, KS, WHOLE>  replaces src/repro/kernels/conv2d/ip2_mxu.py::conv2d_ip2
//   (NS = 1) and src/repro/kernels/conv2d/ip4_dual.py::conv2d_ip4 (NS = 2)
//   2*K operations per output as above; at block 1 the FP32 rate bounds
//   it (int8: the INT32 lanes').  Conv1's tile plan, staging and thread
//   mapping (8 pixels x 4 channels a thread), in the Conv2 order: each
//   output is ONE chain over K = (i, j, cin) from 0 (conv_taps_mxu, as
//   the fused kernel computes it).  Each thread reads a
//   pixel's 4 next channels as one 16-byte shared load (4 bytes on int8)
//   and the quad's weights of those 4 channels as four, so per 4
//   channels 12 loads feed 128 multiply-adds.  The halo
//   is staged a pixel at a time at an odd number of 16-byte chunks
//   (pixel_pitch), so the neighbouring pixels a warp reads at once fall
//   in different banks; the weights by 16-byte cp.async where aligned.
//   Where the halo does not fit, each (tap, chunk of Cin) is staged in
//   turn, taps outermost, so the chain keeps its order.  FFMA / IMAD, no
//   MMA instruction: Hopper has no IEEE-f32 MMA and TF32 misses the
//   reference tolerance.
//   Conv4 (NS = 2): two full-precision convs (f32, bf16 widened exactly,
//   int8, int16 -> int32 wrapping) sharing the weights, as the reference
//   stacks two streams' im2col against one weight block.  A CTA stages
//   the halo of its pixel tile for both streams and the weights once
//   (tile_plan(streams=2): the halo term doubles; at block 1 f32, 72.8 KB,
//   still whole), and each thread keeps 8 pixels x 4 channels of each
//   stream (64 accumulators): each weight quad it loads feeds 16 points.
//   Each stream's chain is Conv2's, so each stream is bitwise equal to a
//   conv2d_ip2 launch.
//
// pool2d_kernel<T, V, O>  replaces src/repro/kernels/pool2d/vpu_window.py::pool2d_window
//   kh*kw compares or adds per output (reduced in V: f32 for f32 and bf16,
//   int32 for integers; bf16 max stored as bf16, exactly): bound by device
//   memory.  One thread
//   per output, neighbouring threads on neighbouring channels, so loads
//   and stores coalesce along C.
//
// activation_kernel<T, KIND>  replaces src/repro/kernels/activation/vpu_exact.py::activation_exact
//   A few flops per element (tanh/gelu a few tens): bound by device
//   memory, and at the served (4,111,111,16) by the launch and one
//   memory round trip.  16-byte vector loads and stores (4 f32 or int32,
//   8 bf16, 16 int8 a load), kActVecs of them a thread loaded before any
//   is converted, in tiles that the CTAs walk a grid apart; the elements
//   before the input's first 16-byte boundary and after its last whole
//   vector one a thread in the same launch; a vector's results are
//   stored as 16-byte vectors where the output meets a boundary at the
//   same element as the input (always, for an aligned input), else
//   element by element.  Each
//   element through the shared activate, KIND fixed at compile time;
//   bf16 out rounded once to nearest even.
//
// activation_lut_kernel<T>  replaces src/repro/kernels/activation/lut_poly.py::activation_lut
//   One f32 index computation and one table read per element (bf16 in,
//   the f32 entry rounded to bf16 out; other inputs give f32):
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
//   bound by the FP32 rate of their conv flops; the conv bodies are the
//   standalone convs' (read from device memory here), so the shared-
//   memory tiling of Conv1 and Conv2 is still to come for this kernel
//   (ROADMAP queue 2, item 17).
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
//   output pixel and channel writes both streams.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "cnn_device.cuh"
#include "tc_device.cuh"

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

// conv2d_vpu_tiled_kernel: each thread keeps kConvPix output pixels x
// kConvCh output channels in registers.
constexpr int kConvPix = 8;
constexpr int kConvCh = 4;

// The tile plan of the tiled conv kernels, made by the wrapper
// (kernels/conv2d/inner.py::tile_plan): a CTA covers 4 << glog output
// channels (2^glog channel quads) and a tile of th x 2^twlog output
// pixels of one image ((256 >> glog) pixel lanes x kConvPix pixels);
// input channels are staged cc at a time.  tiles_w, tiles_h and cblocks
// count the tiles across a row, down an image and along Cout.
struct TilePlan {
  int glog, twlog, th, cc, tiles_w, tiles_h, cblocks;
};

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Four neighbouring channels' weights from shared memory, widened.
__device__ __forceinline__ void load_quad(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_quad(const int8_t* p, int32_t (&v)[4]) {
  const uint32_t q = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = int32_t(q << (24 - 8 * e)) >> 24;
}
// bf16 widened exactly by a shift; int16 sign-extended
__device__ __forceinline__ void load_quad(const __nv_bfloat16* p,
                                          float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void load_quad(const int16_t* p, int32_t (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = int32_t(q.x << 16) >> 16;
  v[1] = int32_t(q.x) >> 16;
  v[2] = int32_t(q.y << 16) >> 16;
  v[3] = int32_t(q.y) >> 16;
}
__device__ __forceinline__ void store_quad(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_quad(int32_t* p, const int32_t (&v)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// Copy `runs` runs of len elements into shared memory, run k from src(k)
// to dst(k) (16-byte aligned): a 16-byte cp.async where a chunk is whole
// and its source aligned, element by element elsewhere.  The caller
// waits for the copies and syncs.
template <typename T, typename Dst, typename Src>
__device__ __forceinline__ void stage_runs(int runs, int len, Dst dst,
                                           Src src) {
  constexpr int V = 16 / int(sizeof(T));
  const int chunks = (len + V - 1) / V;
  for (int e = threadIdx.x; e < runs * chunks; e += blockDim.x) {
    const int k = e / chunks, q = e - k * chunks;
    const T* from = src(k) + q * V;
    T* to = dst(k) + q * V;
    const int n = min(V, len - q * V);
    if (n == V && (reinterpret_cast<uintptr_t>(from) & 15) == 0) {
      tc::cp_async16(tc::smem_u32(to), from, true);
    } else {
      for (int i = 0; i < n; ++i) to[i] = from[i];
    }
  }
}

// rows x (1 << bclog) weights into shared memory: row r's output
// channels co0 .. from src(r) (the row's channel 0); channels past Cout
// are zero.
template <typename T, typename Src>
__device__ __forceinline__ void stage_weights(T* ws, int rows, int bclog,
                                              int co0, int cout, Src src) {
  const int mask = (1 << bclog) - 1;
  for (int e = threadIdx.x; e < (rows << bclog); e += blockDim.x) {
    const int co = co0 + (e & mask);
    ws[e] = co < cout ? src(e >> bclog)[co] : zero<T>();
  }
}

// The tile of a tiled conv CTA: image n, output rows
// h0 .., columns w0 .., channels co0 .. (the channel block fastest in
// the grid, so neighbouring CTAs share their halo in L2).
struct ConvTile {
  int n, h0, w0, co0;
};

__device__ __forceinline__ ConvTile conv_tile(int tile, const TilePlan& pl) {
  const int cb = tile % pl.cblocks;
  tile /= pl.cblocks;
  const int tx = tile % pl.tiles_w;
  tile /= pl.tiles_w;
  return {tile / pl.tiles_h, (tile % pl.tiles_h) * pl.th, tx << pl.twlog,
          cb << (pl.glog + 2)};
}

// The tile pixels of pixel lane `lane` (of 256 >> glog): pixel k lies
// at tile row pr[k], column pc[k], the lanes of a warp on neighbouring
// columns.
__device__ __forceinline__ void tile_pixels(const TilePlan& pl, int lane,
                                            int (&pr)[kConvPix],
                                            int (&pc)[kConvPix]) {
#pragma unroll
  for (int k = 0; k < kConvPix; ++k) {
    const int lin = lane + k * (kThreads >> pl.glog);
    pr[k] = lin >> pl.twlog;
    pc[k] = lin & ((1 << pl.twlog) - 1);
  }
}

// A thread's kConvPix pixels x kConvCh channels (channel quad cg) of the
// tile, points p0 .. p0 + kConvPix - 1 of acc, into y, 16 bytes along
// Cout where Cout allows; outputs past the image or past Cout are
// dropped.
template <typename A, int NP>
__device__ __forceinline__ void store_tile(A* __restrict__ y,
                                           const ConvShape& s, int Ho,
                                           int Wo, const ConvTile& t, int cg,
                                           const int (&pr)[kConvPix],
                                           const int (&pc)[kConvPix],
                                           const A (&acc)[NP][kConvCh],
                                           int p0 = 0) {
  const int co = t.co0 + cg * kConvCh;
  if (co >= s.Cout) return;
  A* yn = y + size_t(t.n) * Ho * Wo * s.Cout + co;
  const bool quads = s.Cout % kConvCh == 0;    // then co + 3 < Cout
#pragma unroll
  for (int k = 0; k < kConvPix; ++k) {
    const int oh = t.h0 + pr[k], ow = t.w0 + pc[k];
    if (oh >= Ho || ow >= Wo) continue;
    A* yp = yn + (size_t(oh) * Wo + ow) * s.Cout;
    if (quads) {
      store_quad(yp, acc[p0 + k]);
    } else {
#pragma unroll
      for (int q = 0; q < kConvCh; ++q) {
        if (co + q < s.Cout) yp[q] = acc[p0 + k][q];
      }
    }
  }
}

// conv2d_mxu_tiled_kernel's pixel pitch in shared memory for n channels:
// whole 16-byte chunks, an odd number of them, so the neighbouring
// pixels whose 16 bytes a warp reads at once lie in different banks.
__host__ __device__ __forceinline__ int pixel_pitch(int n, int V) {
  const int p = round_up(n, V);
  return (p / V) % 2 ? p : p + V;
}

// The shared-memory bytes of a tile: WHOLE, the halo then the weights;
// else one chunk's shifted tile then its weights.  Conv1 (kVpu) stages
// the halo's rows as they lie, Conv2 (kMxu) each pixel at pixel_pitch,
// one halo (or chunk) for each of its ns streams and the weights once.
__host__ __forceinline__ size_t tile_smem_bytes(int style, int ns,
                                                const ConvShape& s,
                                                const TilePlan& pl, int sz,
                                                bool whole) {
  const int V = 16 / sz, TW = 1 << pl.twlog, bc = 4 << pl.glog;
  const size_t wbytes = size_t(whole ? s.KH * s.KW * s.Cin : pl.cc) * bc * sz;
  if (style == kMxu) {
    const size_t pixels =
        whole ? size_t(pl.th + s.KH - 1) * (TW + s.KW - 1) : size_t(pl.th) * TW;
    return ns * pixels * pixel_pitch(whole ? s.Cin : pl.cc, V) * sz + wbytes;
  }
  if (whole) {
    const int rp = round_up((TW + s.KW - 1) * s.Cin, V);
    return size_t(round_up((pl.th + s.KH - 1) * rp * sz, 16)) + wbytes;
  }
  return size_t(pl.th) * TW * round_up(pl.cc, V) * sz + wbytes;
}

// Conv1 on shared-memory tiles, one tile a CTA.  WHOLE: the tile's input
// halo over all Cin and every tap's weights are staged in one go, then
// the taps run from shared memory.  Otherwise each (tap, chunk of cc
// input channels) is staged in turn (the tap's shifted tile and its
// weights), and the tap's partial carries across the chunks.  KS = 3
// unrolls the 3 x 3 taps.
template <typename T, int KS, bool WHOLE>
__global__ void __launch_bounds__(kThreads)
conv2d_vpu_tiled_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        typename AccOf<T>::type* __restrict__ y, ConvShape s,
                        int Ho, int Wo, TilePlan pl) {
  using A = typename AccOf<T>::type;
  using Part = A(&)[kConvPix][kConvCh];
  using Vals = A(&)[kConvPix];
  using Quad = A(&)[kConvCh];
  constexpr int V = 16 / int(sizeof(T));
  extern __shared__ __align__(16) uint8_t smem[];
  const int TW = 1 << pl.twlog, bclog = pl.glog + 2;
  const ConvTile t = conv_tile(blockIdx.x, pl);
  const int cg = threadIdx.x & ((1 << pl.glog) - 1);
  const int lane = threadIdx.x >> pl.glog;
  int pr[kConvPix], pc[kConvPix];              // pixel k: tile row, column
  tile_pixels(pl, lane, pr, pc);
  const T* xn = x + size_t(t.n) * s.H * s.W * s.Cin;
  A acc[kConvPix][kConvCh];
  if constexpr (WHOLE) {
    const int rp = round_up((TW + s.KW - 1) * s.Cin, V);   // row pitch
    T* xs = reinterpret_cast<T*>(smem);
    T* ws = reinterpret_cast<T*>(
        smem + round_up((pl.th + s.KH - 1) * rp * int(sizeof(T)), 16));
    stage_runs<T>(min(pl.th + s.KH - 1, s.H - t.h0),
                  min(TW + s.KW - 1, s.W - t.w0) * s.Cin,
                  [&](int k) { return xs + k * rp; },
                  [&](int k) {
                    return xn + (size_t(t.h0 + k) * s.W + t.w0) * s.Cin;
                  });
    stage_weights(ws, s.KH * s.KW * s.Cin, bclog, t.co0, s.Cout,
                  [&](int r) { return w + size_t(r) * s.Cout; });
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    int xo[kConvPix];
#pragma unroll
    for (int k = 0; k < kConvPix; ++k) xo[k] = pr[k] * rp + pc[k] * s.Cin;
    conv_taps_vpu<A, kConvPix, kConvCh, KS>(s.KH, s.KW, [&](int i, int j,
                                                           Part part) {
      const T* xt = xs + i * rp + j * s.Cin;
      const T* wt = ws + (((i * s.KW + j) * s.Cin) << bclog) + cg * kConvCh;
      conv_part_vpu<A, kConvPix, kConvCh>(s.Cin, [&](int c, Vals xv,
                                                      Quad wv) {
#pragma unroll
        for (int k = 0; k < kConvPix; ++k) xv[k] = widen<A>(xt[xo[k] + c]);
        load_quad(wt + (c << bclog), wv);
      }, part);
    }, acc);
  } else {
    const int cs = round_up(pl.cc, V);         // a pixel's staged channels
    T* xs = reinterpret_cast<T*>(smem);
    T* ws = xs + (pl.th << pl.twlog) * cs;
    int xo[kConvPix];
#pragma unroll
    for (int k = 0; k < kConvPix; ++k) {
      xo[k] = ((pr[k] << pl.twlog) + pc[k]) * cs;
    }
    const int rows = min(pl.th, Ho - t.h0), cols = min(TW, Wo - t.w0);
    conv_taps_vpu<A, kConvPix, kConvCh, KS>(s.KH, s.KW, [&](int i, int j,
                                                           Part part) {
      for (int c0 = 0; c0 < s.Cin; c0 += pl.cc) {
        const int len = min(pl.cc, s.Cin - c0);
        __syncthreads();                     // the last chunk is consumed
        stage_runs<T>(rows * cols, len,
                      [&](int k) {
                        const int r = k / cols;
                        return xs + ((r << pl.twlog) + k - r * cols) * cs;
                      },
                      [&](int k) {
                        const int r = k / cols;
                        return xn + (size_t(t.h0 + i + r) * s.W + t.w0 +
                                     j + k - r * cols) * s.Cin + c0;
                      });
        stage_weights(ws, len, bclog, t.co0, s.Cout, [&](int r) {
          return w + (size_t(i * s.KW + j) * s.Cin + c0 + r) * s.Cout;
        });
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
        const T* wt = ws + cg * kConvCh;
        conv_part_vpu<A, kConvPix, kConvCh>(len, [&](int c, Vals xv,
                                                      Quad wv) {
#pragma unroll
          for (int k = 0; k < kConvPix; ++k) xv[k] = widen<A>(xs[xo[k] + c]);
          load_quad(wt + (c << bclog), wv);
        }, part);
      }
    }, acc);
  }
  store_tile(y, s, Ho, Wo, t, cg, pr, pc, acc);
}

// The inputs and outputs of a tiled conv launch of NS streams.
template <typename T, int NS>
struct Streams {
  const T* x[NS];
  typename AccOf<T>::type* y[NS];
};

// Conv2 of NS streams sharing the weights (Conv2: NS = 1, Conv4: NS = 2)
// on shared-memory tiles, one tile a CTA: the tile plan, staging and
// thread mapping of conv2d_vpu_tiled_kernel, in the Conv2 order: each
// output is ONE chain over K = (i, j, cin) from 0 (conv_taps_mxu).
// WHOLE: the tile's input halo of every stream over all Cin, each pixel
// at pixel_pitch, and every tap's weights (once) are staged in one go.
// Otherwise each (tap, chunk of cc input channels) is staged in turn,
// every stream's shifted chunk and the chunk's weights together, the
// taps outermost and the chunks ascending, so the chain keeps its order
// across chunks.  A thread's register tile is kConvPix pixels of every
// stream x kConvCh channels: point j * kConvPix + k is pixel k of stream
// j, so each weight quad it loads feeds the pixels of every stream, and
// each stream's chain is the one-stream chain.  Channels run 4 at a
// time where a whole quad remains (one 8- or 16-byte load of a pixel's
// inputs, four of the quad's weights), then one at a time; the order is
// the same.  Weight channels past Cout are not staged: they feed only
// accumulators that are never stored.  KS = 3 unrolls the 3 x 3 taps.
template <typename T, int NS, int KS, bool WHOLE>
__global__ void __launch_bounds__(kThreads)
conv2d_mxu_tiled_kernel(Streams<T, NS> io, const T* __restrict__ w,
                        ConvShape s, int Ho, int Wo, TilePlan pl) {
  using A = typename AccOf<T>::type;
  constexpr int NP = NS * kConvPix;            // points a thread
  using Acc = A(&)[NP][kConvCh];
  constexpr int V = 16 / int(sizeof(T));
  extern __shared__ __align__(16) uint8_t smem[];
  const int TW = 1 << pl.twlog, bclog = pl.glog + 2;
  const ConvTile t = conv_tile(blockIdx.x, pl);
  const int cg = threadIdx.x & ((1 << pl.glog) - 1);
  int pr[kConvPix], pc[kConvPix];              // pixel k: tile row, column
  tile_pixels(pl, threadIdx.x >> pl.glog, pr, pc);
  const size_t xn = size_t(t.n) * s.H * s.W * s.Cin;   // the image's offset
  const int wlen = min(4 << pl.glog, s.Cout - t.co0);   // staged channels
  T* xs = reinterpret_cast<T*>(smem);
  // n channels of one tap into a: stream j's pixels at xt + j * sp + xo[k],
  // the thread's weight quad at wt (rows 1 << bclog apart)
  auto run = [&](int n, const T* xt, int sp, const int (&xo)[kConvPix],
                 const T* wt, Acc a) {
    const int n4 = n & ~3;
    conv_run<A, NP, kConvCh, 4>(n4, [&](int c, A (&xv)[NP][4],
                                        A (&wv)[4][kConvCh]) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int k = 0; k < kConvPix; ++k) {
          load_quad(xt + j * sp + xo[k] + c, xv[j * kConvPix + k]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) load_quad(wt + ((c + u) << bclog), wv[u]);
    }, a);
    conv_run<A, NP, kConvCh, 1>(n - n4, [&](int c, A (&xv)[NP][1],
                                            A (&wv)[1][kConvCh]) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int k = 0; k < kConvPix; ++k) {
          xv[j * kConvPix + k][0] = widen<A>(xt[j * sp + xo[k] + n4 + c]);
        }
      }
      load_quad(wt + ((n4 + c) << bclog), wv[0]);
    }, a);
  };
  A acc[NP][kConvCh];
  if constexpr (WHOLE) {
    const int HW = TW + s.KW - 1, pp = pixel_pitch(s.Cin, V);
    const int sp = (pl.th + s.KH - 1) * HW * pp;        // a stream's halo
    T* ws = xs + NS * sp;
    const int cols = min(HW, s.W - t.w0);
    const int runs = min(pl.th + s.KH - 1, s.H - t.h0) * cols;
    for (int j = 0; j < NS; ++j) {
      stage_runs<T>(runs, s.Cin,
                    [&](int k) {
                      const int r = k / cols;
                      return xs + j * sp + (r * HW + k - r * cols) * pp;
                    },
                    [&](int k) {
                      const int r = k / cols;
                      return io.x[j] + xn +
                             (size_t(t.h0 + r) * s.W + t.w0 + k - r * cols) *
                                 s.Cin;
                    });
    }
    stage_runs<T>(s.KH * s.KW * s.Cin, wlen,
                  [&](int r) { return ws + (r << bclog); },
                  [&](int r) { return w + size_t(r) * s.Cout + t.co0; });
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    int xo[kConvPix];
#pragma unroll
    for (int k = 0; k < kConvPix; ++k) xo[k] = (pr[k] * HW + pc[k]) * pp;
    conv_taps_mxu<A, NP, kConvCh, KS>(s.KH, s.KW, [&](int i, int j, Acc a) {
      run(s.Cin, xs + (i * HW + j) * pp, sp, xo,
          ws + (((i * s.KW + j) * s.Cin) << bclog) + cg * kConvCh, a);
    }, acc);
  } else {
    const int cs = pixel_pitch(pl.cc, V);      // a pixel's staged channels
    const int sp = (pl.th << pl.twlog) * cs;   // a stream's chunk
    T* ws = xs + NS * sp;
    int xo[kConvPix];
#pragma unroll
    for (int k = 0; k < kConvPix; ++k) {
      xo[k] = ((pr[k] << pl.twlog) + pc[k]) * cs;
    }
    const int rows = min(pl.th, Ho - t.h0), cols = min(TW, Wo - t.w0);
    conv_taps_mxu<A, NP, kConvCh, KS>(s.KH, s.KW, [&](int i, int j, Acc a) {
      for (int c0 = 0; c0 < s.Cin; c0 += pl.cc) {
        const int len = min(pl.cc, s.Cin - c0);
        __syncthreads();                     // the last chunk is consumed
        for (int q = 0; q < NS; ++q) {
          stage_runs<T>(rows * cols, len,
                        [&](int k) {
                          const int r = k / cols;
                          return xs + q * sp +
                                 ((r << pl.twlog) + k - r * cols) * cs;
                        },
                        [&](int k) {
                          const int r = k / cols;
                          return io.x[q] + xn +
                                 (size_t(t.h0 + i + r) * s.W + t.w0 + j + k -
                                  r * cols) * s.Cin + c0;
                        });
        }
        stage_runs<T>(len, wlen, [&](int r) { return ws + (r << bclog); },
                      [&](int r) {
                        return w + (size_t(i * s.KW + j) * s.Cin + c0 + r) *
                                       s.Cout + t.co0;
                      });
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
        run(len, xs, sp, xo, ws + cg * kConvCh, a);
      }
    }, acc);
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    store_tile(io.y[j], s, Ho, Wo, t, cg, pr, pc, acc, j * kConvPix);
  }
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
    return widen<V>(base[(size_t(i) * W + j) * C]);
  };
  y[t.p * C + t.co] = narrow<O>(window_reduce<V>(load, KH, KW, mode));
}

// An activation's output type: bf16 stays bf16, every other input
// gives f32 (activation/ref.py::activation_out_dtype).
template <typename T> struct ActOut { using type = float; };
template <> struct ActOut<__nv_bfloat16> { using type = __nv_bfloat16; };

// activation_kernel: 16-byte vectors a thread keeps in flight (32 KB an
// SM at 8 CTAs, several times what the memory latency needs), and the
// CTAs an SM the grid holds at most (two rounds of 8 resident ones).
constexpr int kActVecs = 2;
constexpr int kActCtasPerSm = 16;

// One element through the shared activate, stored as O.
template <typename T, int KIND>
__device__ __forceinline__ typename ActOut<T>::type act_one(T v) {
  return narrow<typename ActOut<T>::type>(activate(widen<float>(v), KIND));
}

// Elements [head, head + nvec * VE) as 16-byte vectors (VE = 16 /
// sizeof(T) elements; x + head is 16-byte aligned, as cnn_activation
// works out head), in tiles of kThreads * kActVecs vectors: a CTA's
// threads load a tile's kActVecs vectors each (kThreads apart, so every
// load instruction is coalesced) before any is converted, and the CTAs
// walk the tiles a grid apart.  A vector's results are stored as OW
// 16-byte vectors where y + head is 16-byte aligned too (vstore), else
// element by element.  The head (before x's first 16-byte boundary) and
// the tail (after the last whole vector) go element by element, in the
// same launch.
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
activation_kernel(const T* __restrict__ x,
                  typename ActOut<T>::type* __restrict__ y, long long numel,
                  int head, bool vstore) {
  using O = typename ActOut<T>::type;
  constexpr int VE = 16 / int(sizeof(T));
  constexpr int OW = VE * int(sizeof(O)) / 16;    // 16-byte stores a vector
  constexpr int kTile = kThreads * kActVecs;
  const long long nvec = (numel - head) / VE;
  const long long tail0 = head + nvec * VE;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g < head) y[g] = act_one<T, KIND>(x[g]);
  if (g < numel - tail0) y[tail0 + g] = act_one<T, KIND>(x[tail0 + g]);
  const long long tiles = (nvec + kTile - 1) / kTile;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const uint4* xt = reinterpret_cast<const uint4*>(x + head) + tile * kTile;
    O* ye = y + head + tile * kTile * VE;
    const int n = int(min((long long)kTile, nvec - tile * kTile));
    uint4 in[kActVecs];
#pragma unroll
    for (int u = 0; u < kActVecs; ++u) {
      const int v = threadIdx.x + u * kThreads;
      if (v < n) in[u] = xt[v];
    }
#pragma unroll
    for (int u = 0; u < kActVecs; ++u) {
      const int v = threadIdx.x + u * kThreads;
      if (v < n) {
        union { uint4 q; T e[VE]; } a;
        union { uint4 q[OW]; O e[VE]; } b;
        a.q = in[u];
#pragma unroll
        for (int k = 0; k < VE; ++k) b.e[k] = act_one<T, KIND>(a.e[k]);
        if (vstore) {
          uint4* yt = reinterpret_cast<uint4*>(ye) + v * OW;
#pragma unroll
          for (int w = 0; w < OW; ++w) yt[w] = b.q[w];
        } else {
#pragma unroll
          for (int k = 0; k < VE; ++k) ye[v * VE + k] = b.e[k];
        }
      }
    }
  }
}

// One thread per element; the block stages the table in shared memory.
template <typename T>
__global__ void activation_lut_kernel(const T* __restrict__ x,
                                      const float* __restrict__ table,
                                      typename ActOut<T>::type* __restrict__ y,
                                      long long numel, float r, float s) {
  __shared__ float lut[kTableSize];
  for (int k = threadIdx.x; k < kTableSize; k += blockDim.x) {
    lut[k] = table[k];
  }
  __syncthreads();
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= numel) return;
  float q = rintf(__fmul_rn(__fadd_rn(widen<float>(x[i]), r), s));
  q = fminf(fmaxf(q, 0.0f), float(kTableSize - 1));   // NaN -> 0
  y[i] = narrow<typename ActOut<T>::type>(lut[int(q)]);
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
  V acc = widen<V>(base[0]);
  for (int tap = 1; tap < KH * KW; ++tap) {
    V v = widen<V>(base[(size_t(tap / KW) * W + tap % KW) * C]);
    acc = (mode == kMax) ? vmax(acc, v) : add(acc, v);
  }
  if (mode == kAvg) acc = avg_div(acc, KH * KW);
  y[t.p * C + t.co] = narrow<O>(acc);
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

inline unsigned blocks_for(long long items) {
  return unsigned((items + kThreads - 1) / kThreads);
}

// Conv1 (style kVpu) or Conv2 (kMxu) of ns streams sharing the weights
// (Conv4: Conv2 of two) on the tile plan (glog, twlog, th, cc, whole) of
// kernels/conv2d/inner.py::tile_plan, on f32, bf16, int8 or int16.
int conv_tiled(int style, int ns, int dtype, const void* const* x,
               const void* w, void* const* y, int N, int H, int W, int Cin,
               int KH, int KW, int Cout, int glog, int twlog, int th, int cc,
               int whole, void* stream) {
  const bool types = (ns == 1 || (ns == 2 && style == kMxu)) &&
                     (dtype == kF32 || dtype == kI8 || dtype == kI16 ||
                      dtype == kBF16);
  if (glog < 0 || glog > 3 || twlog < 0 || twlog > 5 || th < 1 ||
      (th << twlog) != (kThreads >> glog) * kConvPix || cc < 1 || cc > Cin ||
      (whole && cc != Cin) || !types || (style != kVpu && style != kMxu)) {
    return int(cudaErrorInvalidValue);
  }
  ConvShape s{H, W, Cin, KH, KW, Cout};
  const int Ho = H - KH + 1, Wo = W - KW + 1, TW = 1 << twlog;
  const int bc = 4 << glog;
  TilePlan pl{glog, twlog, th, cc, (Wo + TW - 1) / TW, (Ho + th - 1) / th,
               (Cout + bc - 1) / bc};
  const long long ctas = (long long)N * pl.tiles_h * pl.tiles_w * pl.cblocks;
  if (ctas > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const int sz = dtype == kF32 ? 4 : dtype == kI8 ? 1 : 2;
  const size_t bytes = tile_smem_bytes(style, ns, s, pl, sz, whole);
  cudaStream_t st = cudaStream_t(stream);
  auto run = [&](auto kernel, auto... args) {
    if (bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
      if (err != cudaSuccess) {
        cudaGetLastError();
        return int(err);
      }
    }
    kernel<<<unsigned(ctas), kThreads, bytes, st>>>(args..., s, Ho, Wo, pl);
    return int(cudaGetLastError());
  };
  const bool k3 = KH == 3 && KW == 3;
#define CNN_VPU(T)                                                          \
  {                                                                         \
    const T* xp = (const T*)x[0];                                           \
    const T* wp = (const T*)w;                                              \
    AccOf<T>::type* yp = (AccOf<T>::type*)y[0];                             \
    if (!whole) return run(conv2d_vpu_tiled_kernel<T, 0, false>, xp, wp, yp); \
    if (k3) return run(conv2d_vpu_tiled_kernel<T, 3, true>, xp, wp, yp);    \
    return run(conv2d_vpu_tiled_kernel<T, 0, true>, xp, wp, yp);            \
  }
#define CNN_MXU(T, NS)                                                      \
  {                                                                         \
    Streams<T, NS> io;                                                      \
    for (int j = 0; j < NS; ++j) {                                          \
      io.x[j] = (const T*)x[j];                                             \
      io.y[j] = (AccOf<T>::type*)y[j];                                      \
    }                                                                       \
    const T* wp = (const T*)w;                                              \
    if (!whole) return run(conv2d_mxu_tiled_kernel<T, NS, 0, false>, io, wp); \
    if (k3) return run(conv2d_mxu_tiled_kernel<T, NS, 3, true>, io, wp);    \
    return run(conv2d_mxu_tiled_kernel<T, NS, 0, true>, io, wp);            \
  }
  if (style == kVpu) {
    if (dtype == kF32) CNN_VPU(float)
    if (dtype == kBF16) CNN_VPU(__nv_bfloat16)
    if (dtype == kI8) CNN_VPU(int8_t)
    CNN_VPU(int16_t)
  }
  if (ns == 1) {
    if (dtype == kF32) CNN_MXU(float, 1)
    if (dtype == kBF16) CNN_MXU(__nv_bfloat16, 1)
    if (dtype == kI8) CNN_MXU(int8_t, 1)
    CNN_MXU(int16_t, 1)
  }
  if (dtype == kF32) CNN_MXU(float, 2)
  if (dtype == kBF16) CNN_MXU(__nv_bfloat16, 2)
  if (dtype == kI8) CNN_MXU(int8_t, 2)
  CNN_MXU(int16_t, 2)
#undef CNN_MXU
#undef CNN_VPU
}

}  // namespace cnn

using namespace cnn;

extern "C" {

const char* cnn_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

// Conv2 (conv2d_ip2) on the tile plan of tile_plan(style="mxu").
int cnn_conv2d(int dtype, const void* x, const void* w, void* y, int N, int H,
               int W, int Cin, int KH, int KW, int Cout, int glog, int twlog,
               int th, int cc, int whole, void* stream) {
  return conv_tiled(kMxu, 1, dtype, &x, w, &y, N, H, W, Cin, KH, KW, Cout,
                    glog, twlog, th, cc, whole, stream);
}

// Conv1 (conv2d_ip1) on the tile plan of tile_plan(style="vpu").
int cnn_conv1(int dtype, const void* x, const void* w, void* y, int N, int H,
              int W, int Cin, int KH, int KW, int Cout, int glog, int twlog,
              int th, int cc, int whole, void* stream) {
  return conv_tiled(kVpu, 1, dtype, &x, w, &y, N, H, W, Cin, KH, KW, Cout,
                    glog, twlog, th, cc, whole, stream);
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
  } else if (dtype == kBF16 && mode == kMax) {
    CNN_POOL(__nv_bfloat16, float, __nv_bfloat16);
  } else if (dtype == kBF16 && mode == kAvg) {
    CNN_POOL(__nv_bfloat16, float, float);
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

// activation_exact: head, the elements before x's first 16-byte
// boundary, is worked out here from x's address; y + head takes 16-byte
// stores where it is 16-byte aligned too.  The grid is kActCtasPerSm
// whole waves of the card's `sms` SMs, or one CTA a tile where the
// tensor has fewer tiles.
int cnn_activation(int dtype, int kind, const void* x, void* y,
                   long long numel, int sms, void* stream) {
  const int size = dtype == kF32 || dtype == kI32 ? 4 : dtype == kBF16 ? 2
                   : dtype == kI8 ? 1 : 0;
  const int osize = dtype == kBF16 ? 2 : 4;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (size == 0 || kind < kRelu || kind > kGelu || numel < 0 || sms < 1 ||
      xa % size != 0 || reinterpret_cast<uintptr_t>(y) % osize != 0) {
    return int(cudaErrorInvalidValue);
  }
  const long long head = std::min(numel, (long long)((16 - xa % 16) % 16) /
                                             size);
  const bool vstore =
      (reinterpret_cast<uintptr_t>(y) + head * osize) % 16 == 0;
  const long long per_tile = (long long)kThreads * kActVecs * (16 / size);
  const long long tiles = (numel - head + per_tile - 1) / per_tile;
  const long long grid =
      std::max(1LL, std::min(tiles, (long long)sms * kActCtasPerSm));
  cudaStream_t st = cudaStream_t(stream);
  auto run = [&](auto kernel, auto xp, auto yp) {
    kernel<<<unsigned(grid), kThreads, 0, st>>>(xp, yp, numel, int(head),
                                                vstore);
    return int(cudaGetLastError());
  };
#define CNN_ACT(T)                                                          \
  {                                                                         \
    const T* xp = (const T*)x;                                              \
    ActOut<T>::type* yp = (ActOut<T>::type*)y;                              \
    switch (kind) {                                                         \
      case kRelu: return run(activation_kernel<T, kRelu>, xp, yp);          \
      case kRelu6: return run(activation_kernel<T, kRelu6>, xp, yp);        \
      case kSigmoid: return run(activation_kernel<T, kSigmoid>, xp, yp);    \
      case kTanh: return run(activation_kernel<T, kTanh>, xp, yp);          \
      default: return run(activation_kernel<T, kGelu>, xp, yp);             \
    }                                                                       \
  }
  if (dtype == kF32) CNN_ACT(float)
  if (dtype == kBF16) CNN_ACT(__nv_bfloat16)
  if (dtype == kI8) CNN_ACT(int8_t)
  CNN_ACT(int32_t)
#undef CNN_ACT
}

int cnn_activation_lut(int dtype, const void* x, const float* table,
                       void* y, long long numel, float r, float s,
                       void* stream) {
  unsigned grid = blocks_for(numel);
  cudaStream_t st = cudaStream_t(stream);
#define CNN_LUT(T)                                                          \
  activation_lut_kernel<T><<<grid, kThreads, 0, st>>>(                      \
      (const T*)x, table, (ActOut<T>::type*)y, numel, r, s)
  if (dtype == kF32) {
    CNN_LUT(float);
  } else if (dtype == kBF16) {
    CNN_LUT(__nv_bfloat16);
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
  } else if (dtype == kBF16 && mode == kMax) {
    CNN_IM2COL(__nv_bfloat16, float, __nv_bfloat16);
  } else if (dtype == kBF16 && mode == kAvg) {
    CNN_IM2COL(__nv_bfloat16, float, float);
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
#define CNN_FUSED_STYLES(T)                                                 \
  if (style == kVpu) {                                                      \
    CNN_FUSED(T, kVpu);                                                     \
  } else {                                                                  \
    CNN_FUSED(T, kMxu);                                                     \
  }
  if (style != kVpu && style != kMxu) return int(cudaErrorInvalidValue);
  if (dtype == kF32) {
    CNN_FUSED_STYLES(float)
  } else if (dtype == kBF16) {
    CNN_FUSED_STYLES(__nv_bfloat16)
  } else if (dtype == kI8) {
    CNN_FUSED_STYLES(int8_t)
  } else if (dtype == kI16) {
    CNN_FUSED_STYLES(int16_t)
  } else {
    return int(cudaErrorInvalidValue);
  }
#undef CNN_FUSED_STYLES
#undef CNN_FUSED
  return int(cudaGetLastError());
}

// ip: 3 (Conv3, int8 only; bc output channels a block) or 4 (Conv4, on
// the tile plan (glog, twlog, th, cc, whole) of tile_plan(style="mxu",
// streams=2)).
int cnn_conv2d_dual(int ip, int dtype, const void* xa, const void* xb,
                    const void* w, void* ya, void* yb, int N, int H, int W,
                    int Cin, int KH, int KW, int Cout, int bc, int glog,
                    int twlog, int th, int cc, int whole, void* stream) {
  if (ip == 4) {
    const void* const x[2] = {xa, xb};
    void* const y[2] = {ya, yb};
    return conv_tiled(kMxu, 2, dtype, x, w, y, N, H, W, Cin, KH, KW, Cout,
                      glog, twlog, th, cc, whole, stream);
  }
  if (ip != 3 || dtype != kI8 || bc < 1) return int(cudaErrorInvalidValue);
  ConvShape s{H, W, Cin, KH, KW, Cout};
  int Ho = H - KH + 1, Wo = W - KW + 1;
  dim3 grid(blocks_for((long long)N * Ho * Wo * bc), (Cout + bc - 1) / bc);
  conv2d_ip3_kernel<<<grid, kThreads, 0, cudaStream_t(stream)>>>(
      (const int8_t*)xa, (const int8_t*)xb, (const int8_t*)w, (int32_t*)ya,
      (int32_t*)yb, N, s, Ho, Wo, bc);
  return int(cudaGetLastError());
}

}  // extern "C"
