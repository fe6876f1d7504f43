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
// int32.  The tiled kernels (Conv1's, Conv2's, which Conv4 runs with two
// streams, Conv3's and the fused block, which runs Conv1's or Conv2's
// staging and chain) tile outputs and stage their inputs in shared
// memory; the two pool kernels (one body, pool_window) and the two
// activation kernels walk 16-byte vectors.  The channel tiling hint
// block_cout shapes the grid and the kernels mask the ragged edge, so
// results never depend on it.  The pools' block_c and the activations'
// block_rows hints are validated and do not shape a grid.
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
//   staged and computed by conv1_tile, which the fused kernel runs too;
//   KS = 3 unrolls the 3 x 3 taps.
//   Logic-only: FFMA / IMAD, no MMA instruction.
//
// conv2d_mxu_tiled_kernel<T, NS, KS, WHOLE>  replaces src/repro/kernels/conv2d/ip2_mxu.py::conv2d_ip2
//   (NS = 1) and src/repro/kernels/conv2d/ip4_dual.py::conv2d_ip4 (NS = 2)
//   2*K operations per output as above; at block 1 the FP32 rate bounds
//   it (int8: the INT32 lanes').  Conv1's tile plan, staging and thread
//   mapping (8 pixels x 4 channels a thread), in the Conv2 order: each
//   output is ONE chain over K = (i, j, cin) from 0 (conv_taps_mxu, in
//   conv2_tile, which the fused kernel runs too).  Each thread reads a
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
// pool2d_kernel<T, V, O, MODE, VE>  replaces src/repro/kernels/pool2d/vpu_window.py::pool2d_window
//   kh*kw compares or adds per output (reduced in V: f32 for f32 and bf16,
//   int32 for integers; bf16 max stored as bf16, exactly): bound by device
//   memory, each input read once and each output written once.  A thread
//   owns VE channels, one 16-byte vector of input (4 f32 or int32, 8
//   bf16, 16 int8), of kPoolOuts outputs of one output row, lanes apart,
//   so a warp's loads and stores are 16-byte vectors on neighbouring
//   addresses; it issues the loads of kPoolTaps taps (a whole 2x2
//   window) for both outputs before it reduces any, and its (image, row,
//   lane, channel vector) split is three 32-bit divisions once a thread
//   (pool_plan's cut, WindowPlan).  Stores are 16-byte vectors of O (bf16
//   avg: two, int8 avg: four a vector).  Where C * sizeof(T) is no
//   multiple of 16 or x or y is not 16-byte aligned, VE is 1 (the scalar
//   path, the same code).  Each element takes its taps i-major from
//   (0, 0) through window_step, window_reduce's order, as the fused
//   kernel pools.  Overlapping windows (a stride below the window) read
//   an input up to kh*kw times, through L1 and L2; a probe of a
//   shared-memory band staged once a CTA was no faster on the H100.
//
// activation_kernel<T, KIND>  replaces src/repro/kernels/activation/vpu_exact.py::activation_exact
//   A few flops per element (tanh/gelu a few tens): bound by device
//   memory, and at the served (4,111,111,16) by the launch and one
//   memory round trip.  The walk it shares with the LUT (act_walk):
//   16-byte vector loads and stores (4 f32 or int32,
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
//   the f32 entry rounded to bf16 out; other inputs give f32): bound by
//   device memory (the 1 KB table stays on chip).  activation_kernel's
//   walk (act_walk: 16-byte vectors, kActVecs a thread in flight, a grid
//   of whole waves, head and tail in the same launch); each CTA issues
//   its first tile's loads, then copies the 256-entry table into shared
//   memory and meets the barrier while they are in flight, and gathers
//   every element's entry there (an __ldg gather from L1, probed
//   instead, measured no faster).  The index is
//   rintf(__fmul_rn(__fadd_rn(x, r), s)) (rint: half to even, as
//   jnp.round), clamped fmaxf(.., 0) first so NaN lands on entry 0.
//
// pool2d_im2col_kernel<T, V, O, MODE, VE>  replaces src/repro/kernels/pool2d/mxu_im2col.py::pool2d_im2col
//   kh*kw loads and adds (or compares) per output: bound by device
//   memory, as pool2d_kernel.  The TPU kernel stacks the taps into a
//   VMEM patch tensor so that avg becomes one MXU pass, ones(1, kh*kw) @
//   patches.  On Hopper a one-row product would waste the tensor cores
//   and TF32 would miss f32 exactness, so the "patch" is the taps a
//   thread holds in registers and the ones-product is kh*kw adds on CUDA
//   cores.  The stacked (i-major) order from tap (0, 0) is
//   window_reduce's, so the member runs the window pool's body
//   (pool_window, on pool_plan's cut: 16-byte vectors, two outputs a
//   thread) under its own kernel name, and its results are
//   pool2d_kernel's bit for bit; integer avg floors, max propagates NaN.
//
// fused_cnn_tiled_kernel<T, S, KS, WHOLE>  replaces src/repro/kernels/fused/cnn_block.py::_fused_call
//   (members fused_cnn_vpu / fused_cnn_mxu).  The conv and pool
//   intermediates never reach device memory, which is what the fusion
//   buys: the input, the weights and the pooled output are the only
//   bytes, so both served blocks are bound by the FP32 rate of their
//   conv flops.  The kernel runs the tiled convs' bodies: a CTA owns a
//   tile of pooled outputs (PoolPlan, made by inner.py::fused_plan next
//   to the conv tile plan) and the conv tile's channel block, fills the
//   conv values its windows read with conv1_tile (S = kVpu) or
//   conv2_tile (S = kMxu), the standalone convs' own staging and chains
//   (8 pixels x 4 channels a thread), a conv tile (band) at a time,
//   rescales them on the int8 rung, writes the register tile to shared
//   memory over the staged inputs' space, and each thread reduces its
//   pooled outputs from there with window_step in i-major order,
//   activates and stores them 16 bytes along Cout.  A window taller or
//   wider than one tile is walked in bands, its running reduce parked
//   in its output between them.  Same bodies, same order: f32 fused ==
//   conv -> pool -> activation chain bitwise, whatever block_cout.
//   Logic-only: FFMA / IMAD, no MMA instruction.
//
// conv2d_ip3_tiled_kernel<KS, WHOLE>  replaces src/repro/kernels/conv2d/ip3_packed.py::conv2d_ip3
//   Conv3: two int8 convs sharing one weight tensor, ONE multiply per
//   tap pair on the packed operand p = a * 2^16 + b.  The work is two
//   convs' taps on the INT32 lanes, so their rate bounds it at block 1.
//   The tiled convs' cut and thread mapping: both streams' halos staged
//   once, already packed (a pair packed once per input element, not per
//   output channel), each pixel at Conv2's pixel_pitch, the weights
//   widened to int32, so per 4 channels one 16-byte shared load of a
//   pixel's pairs and four of the weights feed 128 tap pairs.  The
//   reference unpacks every product (int32 lanes cannot accumulate
//   packed); here two products are summed packed with a bias that keeps
//   both streams' block sums within 16 unsigned bits, so a block's high
//   half is one shift and its low halves are recovered once, from the
//   plain sum of the blocks, at the end (take_block): per tap pair one
//   multiply-add and one more integer operation.  Measured
//   beside it on the H100: a per-pair unpack and a 64-bit packed
//   accumulation (a * 2^23 + b, one IMAD.WIDE a pair, split every 252
//   pairs) were slower.  Integer sums wrap modulo 2^32 whatever their
//   order: both streams are the reference's bit for bit.  Logic-only:
//   IMAD and integer ALU operations, no MMA instruction.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "cnn_device.cuh"
#include "tc_device.cuh"

namespace cnn {

constexpr int kThreads = 256;
constexpr int kTableSize = 256;
// Conv1 (kVpu), Conv2 (kMxu) and Conv3 (kPacked) staging
enum Style { kVpu = 0, kMxu = 1, kPacked = 2 };
enum DType { kF32 = 0, kI8 = 1, kI32 = 2, kI16 = 3, kBF16 = 4 };

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
__device__ __forceinline__ void load_quad(const int32_t* p, int32_t (&v)[4]) {
  const int4 q = *reinterpret_cast<const int4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
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
// one halo (or chunk) for each of its ns streams and the weights once;
// Conv3 (kPacked) Conv2's layout of packed int32 pairs, the weights
// widened to int32.
__host__ __forceinline__ size_t tile_smem_bytes(int style, int ns,
                                                const ConvShape& s,
                                                const TilePlan& pl, int sz,
                                                bool whole) {
  if (style == kPacked) {      // Conv2's layout of 4-byte pairs and weights
    style = kMxu;
    sz = 4;
  }
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

// Conv1's staging and compute for the tile t into the register tile acc
// (a thread's kConvPix pixels pr/pc x kConvCh channels of quad cg).
// WHOLE: the tile's input halo over all Cin and every tap's weights are
// staged in one go, then the taps run from shared memory.  Otherwise
// each (tap, chunk of cc input channels) is staged in turn (the tap's
// shifted tile and its weights), and the tap's partial carries across
// the chunks.  KS = 3 unrolls the 3 x 3 taps.  The standalone Conv1 and
// the fused block (style kVpu) both fill their tiles here.  A caller
// that stages the shared memory again syncs first.
template <typename T, int KS, bool WHOLE>
__device__ __forceinline__ void conv1_tile(
    const T* __restrict__ x, const T* __restrict__ w, const ConvShape& s,
    int Ho, int Wo, const TilePlan& pl, const ConvTile& t, int cg,
    const int (&pr)[kConvPix], const int (&pc)[kConvPix], uint8_t* smem,
    typename AccOf<T>::type (&acc)[kConvPix][kConvCh]) {
  using A = typename AccOf<T>::type;
  using Part = A(&)[kConvPix][kConvCh];
  using Vals = A(&)[kConvPix];
  using Quad = A(&)[kConvCh];
  constexpr int V = 16 / int(sizeof(T));
  const int TW = 1 << pl.twlog, bclog = pl.glog + 2;
  const T* xn = x + size_t(t.n) * s.H * s.W * s.Cin;
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
}

// A thread's place in a tiled CTA: channel quad cg, and its kConvPix
// tile pixels pr/pc.
struct TileThread {
  int cg, lane;
  int pr[kConvPix], pc[kConvPix];
};

__device__ __forceinline__ TileThread tile_thread(const TilePlan& pl) {
  TileThread tt;
  tt.cg = threadIdx.x & ((1 << pl.glog) - 1);
  tt.lane = threadIdx.x >> pl.glog;
  tile_pixels(pl, tt.lane, tt.pr, tt.pc);
  return tt;
}

// Conv1 on shared-memory tiles, one tile a CTA (conv1_tile), stored.
template <typename T, int KS, bool WHOLE>
__global__ void __launch_bounds__(kThreads)
conv2d_vpu_tiled_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        typename AccOf<T>::type* __restrict__ y, ConvShape s,
                        int Ho, int Wo, TilePlan pl) {
  extern __shared__ __align__(16) uint8_t smem[];
  const ConvTile t = conv_tile(blockIdx.x, pl);
  const TileThread tt = tile_thread(pl);
  typename AccOf<T>::type acc[kConvPix][kConvCh];
  conv1_tile<T, KS, WHOLE>(x, w, s, Ho, Wo, pl, t, tt.cg, tt.pr, tt.pc, smem,
                           acc);
  store_tile(y, s, Ho, Wo, t, tt.cg, tt.pr, tt.pc, acc);
}

// The inputs and outputs of a tiled conv launch of NS streams.
template <typename T, int NS>
struct Streams {
  const T* x[NS];
  typename AccOf<T>::type* y[NS];
};

// Conv2 of NS streams x sharing the weights (Conv2: NS = 1, Conv4: NS =
// 2), its staging and compute for the tile t into the register tile
// acc: the tile plan, staging and thread mapping of conv1_tile, in the
// Conv2 order: each output is ONE chain over K = (i, j, cin) from 0
// (conv_taps_mxu).  WHOLE: the tile's input halo of every stream over
// all Cin, each pixel at pixel_pitch, and every tap's weights (once) are
// staged in one go.  Otherwise each (tap, chunk of cc input channels)
// is staged in turn, every stream's shifted chunk and the chunk's
// weights together, the taps outermost and the chunks ascending, so the
// chain keeps its order across chunks.  A thread's register tile is
// kConvPix pixels of every stream x kConvCh channels: point j * kConvPix
// + k is pixel k of stream j, so each weight quad it loads feeds the
// pixels of every stream, and each stream's chain is the one-stream
// chain.  Channels run 4 at a time where a whole quad remains (one 8-
// or 16-byte load of a pixel's inputs, four of the quad's weights), then
// one at a time; the order is the same.  Weight channels past Cout are
// not staged: they feed only accumulators that are never stored.  KS = 3
// unrolls the 3 x 3 taps.  The standalone Conv2 and Conv4 and the fused
// block (style kMxu, NS = 1) fill their tiles here.
template <typename T, int NS, int KS, bool WHOLE>
__device__ __forceinline__ void conv2_tile(
    const T* const (&x)[NS], const T* __restrict__ w, const ConvShape& s,
    int Ho, int Wo, const TilePlan& pl, const ConvTile& t, int cg,
    const int (&pr)[kConvPix], const int (&pc)[kConvPix], uint8_t* smem,
    typename AccOf<T>::type (&acc)[NS * kConvPix][kConvCh]) {
  using A = typename AccOf<T>::type;
  constexpr int NP = NS * kConvPix;            // points a thread
  using Acc = A(&)[NP][kConvCh];
  constexpr int V = 16 / int(sizeof(T));
  const int TW = 1 << pl.twlog, bclog = pl.glog + 2;
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
                      return x[j] + xn +
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
                          return x[q] + xn +
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
}

// Conv2 of NS streams on shared-memory tiles, one tile a CTA
// (conv2_tile), each stream's outputs stored.
template <typename T, int NS, int KS, bool WHOLE>
__global__ void __launch_bounds__(kThreads)
conv2d_mxu_tiled_kernel(Streams<T, NS> io, const T* __restrict__ w,
                        ConvShape s, int Ho, int Wo, TilePlan pl) {
  extern __shared__ __align__(16) uint8_t smem[];
  const ConvTile t = conv_tile(blockIdx.x, pl);
  const TileThread tt = tile_thread(pl);
  typename AccOf<T>::type acc[NS * kConvPix][kConvCh];
  conv2_tile<T, NS, KS, WHOLE>(io.x, w, s, Ho, Wo, pl, t, tt.cg, tt.pr,
                               tt.pc, smem, acc);
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    store_tile(io.y[j], s, Ho, Wo, t, tt.cg, tt.pr, tt.pc, acc, j * kConvPix);
  }
}

// VE elements of T as one load: a 16-byte vector where VE * sizeof(T)
// is 16, T itself where VE is 1 (the pools' scalar path).
template <typename T, int VE>
struct RawOf {
  using type = uint4;
};
template <typename T>
struct RawOf<T, 1> {
  using type = T;
};

template <typename T, int VE>
__device__ __forceinline__ typename RawOf<T, VE>::type load_raw(const T* p) {
  if constexpr (VE == 1) {
    return *p;
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

// The VE elements of a load, widened to V (bf16 to f32 by its 16-bit
// shift, as widen does, on the load's 32-bit words).
template <typename V, typename T, int VE>
__device__ __forceinline__ void unpack(typename RawOf<T, VE>::type r,
                                       V (&v)[VE]) {
  if constexpr (VE == 1) {
    v[0] = widen<V>(r);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
    union { uint4 q; T e[VE]; } a;
    a.q = r;
#pragma unroll
    for (int k = 0; k < VE; ++k) v[k] = widen<V>(a.e[k]);
  }
}

// VE reduced elements stored as O: 16-byte vectors where they fill
// whole 16-byte words (the pools' vector path), else one by one.
template <typename O, typename V, int VE>
__device__ __forceinline__ void store_out(O* p, const V (&v)[VE], int kh,
                                          int kw, int mode) {
  constexpr int kBytes = VE * int(sizeof(O));
  if constexpr (VE > 1 && kBytes % 16 == 0) {
    union { uint4 q[kBytes / 16]; O e[VE]; } b;
#pragma unroll
    for (int k = 0; k < VE; ++k) {
      b.e[k] = narrow<O>(window_end(v[k], kh, kw, mode));
    }
#pragma unroll
    for (int w = 0; w < kBytes / 16; ++w) {
      reinterpret_cast<uint4*>(p)[w] = b.q[w];
    }
  } else {
#pragma unroll
    for (int k = 0; k < VE; ++k) {
      p[k] = narrow<O>(window_end(v[k], kh, kw, mode));
    }
  }
}

// pool_window: outputs a thread covers along a row (at most), and the
// window taps whose loads it issues before it reduces them.
constexpr int kPoolOuts = 2;
constexpr int kPoolTaps = 4;

// The cut of both pool kernels, made by the wrappers
// (kernels/pool2d/vpu_window.py::pool_plan) and checked by pool_launch: a
// thread owns ve channels (16 bytes of input, or 1 on the scalar path)
// of outs outputs of one output row, ow = q, q + lanes, ..; cv = C / ve
// threads cover a pixel's channels, lanes * cv an output row, and the
// CTAs of kThreads threads the N * Ho rows in order.
struct WindowPlan {
  int ve, outs, lanes, cv;
};

// V: the reduce type (f32 or int32); O: the stored type; VE: the
// elements a thread owns (16 / sizeof(T), or 1 on the scalar path).
// Thread g of the grid takes row g / (lanes * cv), then its lane and
// channel vector: three 32-bit divisions a thread, none an output.  The
// taps are loaded kPoolTaps at a time (all taps of a 2x2 window at
// once) for each of the thread's outputs, then taken in i-major order
// from (0, 0) through window_step, each element on its own: the
// reduction order of window_reduce, and of the im2col member's stacked
// taps.  The body of pool2d_kernel and pool2d_im2col_kernel.
template <typename T, typename V, typename O, int MODE, int VE>
__device__ __forceinline__ void pool_window(const T* __restrict__ x,
                                            O* __restrict__ y, int N, int H,
                                            int W, int C, int KH, int KW,
                                            int SH, int SW, int Ho, int Wo,
                                            WindowPlan wp) {
  using Raw = typename RawOf<T, VE>::type;
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  const unsigned per_row = unsigned(wp.lanes) * unsigned(wp.cv);
  const unsigned row = g / per_row;
  if (row >= unsigned(N) * unsigned(Ho)) return;
  const unsigned rem = g - row * per_row;
  const int q = int(rem / unsigned(wp.cv));
  const int c0 = (int(rem) - q * wp.cv) * VE;
  const int n = int(row / unsigned(Ho)), oh = int(row) - n * Ho;
  const T* xr = x + (size_t(n) * H + size_t(oh) * SH) * W * C + c0;
  const int pitch = W * C, step = SW * C, taps = KH * KW;
  int ox[kPoolOuts];
  bool live[kPoolOuts];
#pragma unroll
  for (int k = 0; k < kPoolOuts; ++k) {
    const int ow = q + k * wp.lanes;
    live[k] = k < wp.outs && ow < Wo;
    ox[k] = ow * step;
  }
  V acc[kPoolOuts][VE];
#pragma unroll
  for (int k = 0; k < kPoolOuts; ++k) {
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[k][e] = V(0);
  }
  int i = 0, j = 0;        // the next tap to reduce
  for (int t0 = 0; t0 < taps; t0 += kPoolTaps) {
    Raw in[kPoolTaps][kPoolOuts];
    int li = i, lj = j;    // the next tap to load
#pragma unroll
    for (int u = 0; u < kPoolTaps; ++u) {
      const int off = li * pitch + lj * C;
#pragma unroll
      for (int k = 0; k < kPoolOuts; ++k) {
        if (live[k] && t0 + u < taps) {
          in[u][k] = load_raw<T, VE>(xr + ox[k] + off);
        }
      }
      if (++lj == KW) {
        lj = 0;
        ++li;
      }
    }
#pragma unroll
    for (int u = 0; u < kPoolTaps; ++u) {
#pragma unroll
      for (int k = 0; k < kPoolOuts; ++k) {
        if (live[k] && t0 + u < taps) {
          V v[VE];
          unpack<V, T, VE>(in[u][k], v);
#pragma unroll
          for (int e = 0; e < VE; ++e) {
            acc[k][e] = window_step(acc[k][e], v[e], i, j, MODE);
          }
        }
      }
      if (++j == KW) {
        j = 0;
        ++i;
      }
    }
  }
  O* yr = y + (size_t(row) * Wo + q) * C + c0;
#pragma unroll
  for (int k = 0; k < kPoolOuts; ++k) {
    if (live[k]) {
      store_out<O>(yr + size_t(k) * wp.lanes * C, acc[k], KH, KW, MODE);
    }
  }
}

// pool_vpu (pool2d_window) and pool_im2col (pool2d_im2col): one body,
// two kernels, so that each member keeps its own name in SASS and in
// the profiler.
template <typename T, typename V, typename O, int MODE, int VE>
__global__ void __launch_bounds__(kThreads)
pool2d_kernel(const T* __restrict__ x, O* __restrict__ y, int N, int H,
              int W, int C, int KH, int KW, int SH, int SW, int Ho, int Wo,
              WindowPlan wp) {
  pool_window<T, V, O, MODE, VE>(x, y, N, H, W, C, KH, KW, SH, SW, Ho, Wo,
                                 wp);
}
template <typename T, typename V, typename O, int MODE, int VE>
__global__ void __launch_bounds__(kThreads)
pool2d_im2col_kernel(const T* __restrict__ x, O* __restrict__ y, int N,
                     int H, int W, int C, int KH, int KW, int SH, int SW,
                     int Ho, int Wo, WindowPlan wp) {
  pool_window<T, V, O, MODE, VE>(x, y, N, H, W, C, KH, KW, SH, SW, Ho, Wo,
                                 wp);
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

// The walk of both activation kernels: y[k] = one(x[k]) for every k <
// numel.  Elements [head, head + nvec * VE) go as 16-byte vectors (VE =
// 16 / sizeof(T) elements; x + head is 16-byte aligned, as act_split
// works out head), in tiles of kThreads * kActVecs vectors: a CTA's
// threads load a tile's kActVecs vectors each (kThreads apart, so every
// load instruction is coalesced) before any is converted, and the CTAs
// walk the tiles a grid apart, each loading its next tile once the
// current one is stored.  A vector's results are stored as OW 16-byte
// vectors where y + head is 16-byte aligned too (vstore), else element
// by element.  ready() runs in every thread once the CTA's first tile
// is in flight (the LUT stages its table there); then the head (before
// x's first 16-byte boundary) and the tail (after the last whole
// vector) go element by element, in the same launch.
template <typename T, typename O, typename Ready, typename One>
__device__ __forceinline__ void act_walk(const T* __restrict__ x,
                                         O* __restrict__ y, long long numel,
                                         int head, bool vstore, Ready ready,
                                         One one) {
  constexpr int VE = 16 / int(sizeof(T));
  constexpr int OW = VE * int(sizeof(O)) / 16;    // 16-byte stores a vector
  constexpr int kTile = kThreads * kActVecs;
  const long long nvec = (numel - head) / VE;
  const long long tail0 = head + nvec * VE;
  const long long tiles = (nvec + kTile - 1) / kTile;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4 in[kActVecs];
  auto load = [&](long long tile) {
    const long long n = nvec - tile * kTile;
#pragma unroll
    for (int u = 0; u < kActVecs; ++u) {
      const int v = threadIdx.x + u * kThreads;
      if (v < n) in[u] = xv[tile * kTile + v];
    }
  };
  long long tile = blockIdx.x;
  if (tile < tiles) load(tile);
  ready();
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g < head) y[g] = one(x[g]);
  if (g < numel - tail0) y[tail0 + g] = one(x[tail0 + g]);
  for (; tile < tiles; tile += gridDim.x) {
    O* ye = y + head + tile * kTile * VE;
    const int n = int(min((long long)kTile, nvec - tile * kTile));
#pragma unroll
    for (int u = 0; u < kActVecs; ++u) {
      const int v = threadIdx.x + u * kThreads;
      if (v < n) {
        union { uint4 q; T e[VE]; } a;
        union { uint4 q[OW]; O e[VE]; } b;
        a.q = in[u];
#pragma unroll
        for (int k = 0; k < VE; ++k) b.e[k] = one(a.e[k]);
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
    if (tile + gridDim.x < tiles) load(tile + gridDim.x);
  }
}

// activate() of KIND on every element (act_walk).
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
activation_kernel(const T* __restrict__ x,
                  typename ActOut<T>::type* __restrict__ y, long long numel,
                  int head, bool vstore) {
  act_walk(x, y, numel, head, vstore, [] {},
           [](T v) { return act_one<T, KIND>(v); });
}

// The table entry of every element (act_walk): index rintf((x + r) * s)
// clamped to [0, 255], fmaxf first so NaN lands on entry 0.  The CTA
// stages the table in shared memory once its first tile is in flight
// and gathers from there.
template <typename T>
__global__ void __launch_bounds__(kThreads)
activation_lut_kernel(const T* __restrict__ x,
                      const float* __restrict__ table,
                      typename ActOut<T>::type* __restrict__ y,
                      long long numel, int head, bool vstore, float r,
                      float s) {
  using O = typename ActOut<T>::type;
  __shared__ float lut[kTableSize];
  auto stage = [&] {
    for (int k = threadIdx.x; k < kTableSize; k += kThreads) {
      lut[k] = __ldg(table + k);
    }
    __syncthreads();
  };
  auto one = [&](T v) -> O {
    float q = rintf(__fmul_rn(__fadd_rn(widen<float>(v), r), s));
    const int k = int(fminf(fmaxf(q, 0.0f), float(kTableSize - 1)));
    return narrow<O>(lut[k]);
  };
  act_walk(x, y, numel, head, vstore, stage, one);
}

// The pooled-space cut of the fused kernel, made by the wrapper
// (kernels/conv2d/inner.py::fused_plan, next to tile_plan): a CTA owns
// tp x tq pooled outputs of one image (tiles_p x tiles_q tiles an
// image) and the conv tile plan's channel block.  The conv rows and
// columns its windows read, (tp - 1) * SH + PH x (tq - 1) * SW + PW from
// (p0 * SH, q0 * SW), are computed a conv tile (th x TW) at a time:
// row_bands bands top to bottom, each in col_segs segments left to
// right (more than one only where th == 1), so every window takes its
// taps in i-major order across the bands.
struct PoolPlan {
  int PH, PW, SH, SW, Po, Qo, tp, tq, tiles_p, tiles_q, row_bands, col_segs;
};

// A band of conv values in shared memory: th x TW pixels x 4 << glog
// channels, 8192 values of 4 bytes whatever the plan.
constexpr int kBandValues = kThreads * kConvPix * kConvCh;

// The register tile of the fused kernel's conv values, in its style's
// order: the standalone Conv1's or Conv2's body.
template <typename T, int STYLE, int KS, bool WHOLE>
__device__ __forceinline__ void conv_tile_body(
    const T* __restrict__ x, const T* __restrict__ w, const ConvShape& s,
    int Ho, int Wo, const TilePlan& pl, const ConvTile& t,
    const TileThread& tt, uint8_t* smem,
    typename AccOf<T>::type (&acc)[kConvPix][kConvCh]) {
  if constexpr (STYLE == kVpu) {
    conv1_tile<T, KS, WHOLE>(x, w, s, Ho, Wo, pl, t, tt.cg, tt.pr, tt.pc,
                             smem, acc);
  } else {
    const T* const xs[1] = {x};
    conv2_tile<T, 1, KS, WHOLE>(xs, w, s, Ho, Wo, pl, t, tt.cg, tt.pr, tt.pc,
                                smem, acc);
  }
}

// A running reduce parked in its f32 output between bands: the raw 32
// bits of V.
__device__ __forceinline__ float park(float v) { return v; }
__device__ __forceinline__ float park(int32_t v) { return __int_as_float(v); }
__device__ __forceinline__ void unpark(float p, float& v) { v = p; }
__device__ __forceinline__ void unpark(float p, int32_t& v) {
  v = __float_as_int(p);
}

// One band of the fused kernel, after its conv: the register tile (V =
// float: the conv values, rescaled by sc where scaled; V = int32: the
// integer conv values) into shared memory, then each of the thread's
// pooled outputs (tp x tq of the CTA, lane-major as the conv pixels)
// takes the band's taps of its window with window_step in i-major
// order.  A window that ends in this band is finished (window_end,
// activate) and stored, 16 bytes along Cout where Cout allows; one that
// goes on is parked in its output and picked up by the next band that
// holds its taps.  br, bcol: the band's origin in the CTA's conv rows
// and columns.
template <typename V, typename A>
__device__ __forceinline__ void fused_band(
    const A (&acc)[kConvPix][kConvCh], bool scaled, const float (&sc)[kConvCh],
    float* __restrict__ y, const ConvShape& s, const TilePlan& pl,
    const PoolPlan& pp, const TileThread& tt, int n, int p0, int q0, int co,
    int br, int bcol, uint8_t* smem, int mode, int kind) {
  V* band = reinterpret_cast<V*>(smem);
  const int bclog = pl.glog + 2, TW = 1 << pl.twlog;
#pragma unroll
  for (int k = 0; k < kConvPix; ++k) {
    V v[kConvCh];
#pragma unroll
    for (int q = 0; q < kConvCh; ++q) {
      if constexpr (std::is_same_v<V, float>) {
        // int8 rung: the accumulator rescaled in register (cnn_block.py:71-75)
        v[q] = scaled ? __fmul_rn(float(acc[k][q]), sc[q]) : float(acc[k][q]);
      } else {
        v[q] = acc[k][q];
      }
    }
    store_quad(band + ((((tt.pr[k] << pl.twlog) + tt.pc[k]) << bclog) +
                       tt.cg * kConvCh), v);
  }
  __syncthreads();
  if (co >= s.Cout) return;
  const int lanes = kThreads >> pl.glog, npool = pp.tp * pp.tq;
  const bool quads = s.Cout % kConvCh == 0;    // then co + 3 < Cout
#pragma unroll 1
  for (int k = 0; k < kConvPix; ++k) {
    const int pidx = tt.lane + k * lanes;
    if (pidx >= npool) break;
    const int pi = pidx / pp.tq, qi = pidx - pi * pp.tq;
    const int po = p0 + pi, qo = q0 + qi;
    if (po >= pp.Po || qo >= pp.Qo) continue;
    // the window's origin in the band, and its taps the band holds
    const int wr = pi * pp.SH - br, wc = qi * pp.SW - bcol;
    const int i0 = max(0, -wr), i1 = min(pp.PH, pl.th - wr);
    const int j0 = max(0, -wc), j1 = min(pp.PW, TW - wc);
    if (i0 >= i1 || j0 >= j1) continue;
    float* yp = y + ((size_t(n) * pp.Po + po) * pp.Qo + qo) * s.Cout + co;
    V red[kConvCh];
#pragma unroll
    for (int q = 0; q < kConvCh; ++q) {
      red[q] = V(0);
      // a window whose first tap lies in an earlier band goes on
      if ((i0 > 0 || j0 > 0) && co + q < s.Cout) unpark(yp[q], red[q]);
    }
    for (int i = i0; i < i1; ++i) {
      const V* row = band + ((((wr + i) << pl.twlog) + wc) << bclog) +
                     tt.cg * kConvCh;
      for (int j = j0; j < j1; ++j) {
        V v[kConvCh];
        load_quad(row + (j << bclog), v);
#pragma unroll
        for (int q = 0; q < kConvCh; ++q) {
          red[q] = window_step(red[q], v[q], i, j, mode);
        }
      }
    }
    if (i1 == pp.PH && j1 == pp.PW) {
      float out[kConvCh];
#pragma unroll
      for (int q = 0; q < kConvCh; ++q) {
        out[q] = activate(float(window_end(red[q], pp.PH, pp.PW, mode)),
                          kind);
      }
      if (quads) {
        store_quad(yp, out);
      } else {
#pragma unroll
        for (int q = 0; q < kConvCh; ++q) {
          if (co + q < s.Cout) yp[q] = out[q];
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < kConvCh; ++q) {
        if (co + q < s.Cout) yp[q] = park(red[q]);
      }
    }
  }
}

// The fused conv -> pool -> activation block on the tiled convs' bodies:
// one CTA a pooled tile (PoolPlan), each band of its conv values filled
// by the standalone conv's staging and compute (conv_tile_body), then
// pooled and activated from shared memory (fused_band), the band's
// space reusing the staged inputs'.  Integers without a scale pool in
// int32 (floor average) and activate in f32; with one (the int8 rung)
// and on floats the pool runs in f32.
template <typename T, int STYLE, int KS, bool WHOLE>
__global__ void __launch_bounds__(kThreads, 2)
fused_cnn_tiled_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ scale,
                       float* __restrict__ y, ConvShape s, int Ho, int Wo,
                       TilePlan pl, PoolPlan pp, int mode, int kind) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  int tile = blockIdx.x;                       // the channel block fastest
  const int co0 = (tile % pl.cblocks) << (pl.glog + 2);
  tile /= pl.cblocks;
  const int q0 = (tile % pp.tiles_q) * pp.tq;
  tile /= pp.tiles_q;
  const int p0 = (tile % pp.tiles_p) * pp.tp, n = tile / pp.tiles_p;
  const TileThread tt = tile_thread(pl);
  const int co = co0 + tt.cg * kConvCh;
  float sc[kConvCh];
#pragma unroll
  for (int q = 0; q < kConvCh; ++q) {
    sc[q] = (scale != nullptr && co + q < s.Cout) ? scale[co + q] : 0.0f;
  }
  for (int rb = 0; rb < pp.row_bands; ++rb) {
    for (int cs = 0; cs < pp.col_segs; ++cs) {
      const int br = rb * pl.th, bcol = cs << pl.twlog;
      const ConvTile t{n, p0 * pp.SH + br, q0 * pp.SW + bcol, co0};
      if (t.h0 >= Ho || t.w0 >= Wo) continue;  // past the plane: no window
      if (rb + cs > 0) __syncthreads();        // the last band is pooled
      A acc[kConvPix][kConvCh];
      conv_tile_body<T, STYLE, KS, WHOLE>(x, w, s, Ho, Wo, pl, t, tt, smem,
                                          acc);
      __syncthreads();                         // the staged inputs are read
      if constexpr (std::is_same_v<A, float>) {
        fused_band<float>(acc, scale != nullptr, sc, y, s, pl, pp, tt, n, p0,
                          q0, co, br, bcol, smem, mode, kind);
      } else if (scale != nullptr) {
        fused_band<float>(acc, true, sc, y, s, pl, pp, tt, n, p0, q0, co, br,
                          bcol, smem, mode, kind);
      } else {
        fused_band<int32_t>(acc, false, sc, y, s, pl, pp, tt, n, p0, q0, co,
                            br, bcol, smem, mode, kind);
      }
    }
  }
}

// Conv3's packed operand of one input pair, p = a * 2^16 + b (the
// reference's packing; a multiplication: shifting a negative int is
// undefined in C++17).  A block of one or two tap pairs, its products
// summed packed with kBlockBias, gives m = (A + kPairBias) * 2^16 + (B +
// kPairBias) mod 2^32, A and B the two streams' sums over the block,
// each in [-32512, 32768] (a*w in [-16256, 16384] for int8): biased,
// both lie in [0, 65280], so m holds them exactly, with no carry
// between its halves.  m >> 16 is A + kPairBias; the B halves are
// recovered from the plain sum of the m at the end (take_block).
constexpr uint32_t kPairBias = 32512;
constexpr uint32_t kBlockBias = kPairBias * 65537u;   // both halves

__device__ __forceinline__ int32_t pack_pair(int32_t a, int32_t b) {
  return a * 65536 + b;
}

// A block's biased m into the running sums: sum_m of the m, sum_a of
// their high halves (A + kPairBias).  The b stream's sum of the B +
// kPairBias is then sum_m - sum_a * 2^16, modulo 2^32.
__device__ __forceinline__ void take_block(uint32_t m, uint32_t& sum_m,
                                           uint32_t& sum_a) {
  sum_m += m;
  sum_a += m >> 16;
}

// runs runs of len packed input pairs into shared memory: run k's pairs
// from xa + src(k) and xb + src(k) to dst(k) (int32, 16-byte aligned),
// 16 pairs from two 16-byte loads where both sources are aligned, one
// at a time elsewhere.  The caller syncs.
template <typename Dst, typename Src>
__device__ __forceinline__ void stage_packed(const int8_t* __restrict__ xa,
                                             const int8_t* __restrict__ xb,
                                             int runs, int len, Dst dst,
                                             Src src) {
  const int chunks = (len + 15) / 16;
  for (int e = threadIdx.x; e < runs * chunks; e += blockDim.x) {
    const int k = e / chunks, q = e - k * chunks;
    const size_t off = src(k) + size_t(q) * 16;
    int32_t* to = dst(k) + q * 16;
    const int n = min(16, len - q * 16);
    if (n == 16 && ((reinterpret_cast<uintptr_t>(xa + off) |
                     reinterpret_cast<uintptr_t>(xb + off)) & 15) == 0) {
      const uint4 a = *reinterpret_cast<const uint4*>(xa + off);
      const uint4 b = *reinterpret_cast<const uint4*>(xb + off);
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        int32_t p[4];
#pragma unroll
        for (int e8 = 0; e8 < 4; ++e8) {
          p[e8] = pack_pair(int32_t(aw[v] << (24 - 8 * e8)) >> 24,
                            int32_t(bw[v] << (24 - 8 * e8)) >> 24);
        }
        reinterpret_cast<int4*>(to)[v] = make_int4(p[0], p[1], p[2], p[3]);
      }
    } else {
      for (int i = 0; i < n; ++i) to[i] = pack_pair(xa[off + i], xb[off + i]);
    }
  }
}

// Conv3 on the tiled convs' cut (tile_plan(style="packed")): both
// streams' halos staged once, packed (stage_packed), each pixel at
// pixel_pitch as Conv2 stages it, and the weights widened to int32.
// Each thread keeps 8 pixels x 4 channels of the blocks' biased sums
// (sum_m, sum_a); per 4 channels, one 16-byte shared load of a pixel's
// 4 packed pairs and four of the quad's weights feed 128 tap pairs, ONE
// multiply-add each, summed two at a time (channels 0-1 and 2-3 of the
// quad, the channels past the last whole quad one at a time) and taken
// with take_block: a shift and two adds a block.  At the end the b
// stream's sums come out of sum_m and both shed the bias of their
// blocks.
// Integer sums wrap modulo 2^32 whatever their order, so both streams
// are the reference's bit for bit.  WHOLE: the packed halo over all Cin
// and every tap's weights in one go; otherwise each (tap, chunk of cc
// input channels) in turn.
template <int KS, bool WHOLE>
__global__ void __launch_bounds__(kThreads, 2)
conv2d_ip3_tiled_kernel(const int8_t* __restrict__ xa,
                        const int8_t* __restrict__ xb,
                        const int8_t* __restrict__ w,
                        int32_t* __restrict__ ya, int32_t* __restrict__ yb,
                        ConvShape s, int Ho, int Wo, TilePlan pl) {
  using Sums = uint32_t (&)[kConvPix][kConvCh];
  extern __shared__ __align__(16) uint8_t smem[];
  const ConvTile t = conv_tile(blockIdx.x, pl);
  const TileThread tt = tile_thread(pl);
  const int TW = 1 << pl.twlog, bclog = pl.glog + 2;
  const size_t xn = size_t(t.n) * s.H * s.W * s.Cin;
  int32_t* xs = reinterpret_cast<int32_t*>(smem);
  uint32_t sum_m[kConvPix][kConvCh];           // zeroed by conv_taps_mxu
  uint32_t sum_a[kConvPix][kConvCh];
#pragma unroll
  for (int k = 0; k < kConvPix; ++k) {
#pragma unroll
    for (int q = 0; q < kConvCh; ++q) sum_a[k][q] = 0;
  }
  int blocks = 0;                              // blocks an output took
  // n channels of one tap: pixel k's packed pairs at xt + xo[k], the
  // thread's weight quad at wt (rows 1 << bclog apart); both 16-byte
  // aligned at every fourth channel
  auto run = [&](int n, const int32_t* xt, const int (&xo)[kConvPix],
                 const int32_t* wt) {
    const int n4 = n & ~3;
    for (int c = 0; c < n4; c += 4) {
      int32_t wv[4][kConvCh];
#pragma unroll
      for (int u = 0; u < 4; ++u) load_quad(wt + ((c + u) << bclog), wv[u]);
#pragma unroll
      for (int k = 0; k < kConvPix; ++k) {
        int32_t xv[4];
        load_quad(xt + xo[k] + c, xv);
#pragma unroll
        for (int q = 0; q < kConvCh; ++q) {
#pragma unroll
          for (int u = 0; u < 4; u += 2) {
            take_block(uint32_t(xv[u]) * uint32_t(wv[u][q]) +
                           (uint32_t(xv[u + 1]) * uint32_t(wv[u + 1][q]) +
                            kBlockBias),
                       sum_m[k][q], sum_a[k][q]);
          }
        }
      }
    }
    for (int c = n4; c < n; ++c) {
      int32_t wv[kConvCh];
      load_quad(wt + (c << bclog), wv);
#pragma unroll
      for (int k = 0; k < kConvPix; ++k) {
#pragma unroll
        for (int q = 0; q < kConvCh; ++q) {
          take_block(uint32_t(xt[xo[k] + c]) * uint32_t(wv[q]) + kBlockBias,
                     sum_m[k][q], sum_a[k][q]);
        }
      }
    }
    blocks += n4 / 2 + n - n4;
  };
  int xo[kConvPix];
  if constexpr (WHOLE) {
    const int HW = TW + s.KW - 1, pp = pixel_pitch(s.Cin, 4);
    int32_t* ws = xs + (pl.th + s.KH - 1) * HW * pp;
    const int cols = min(HW, s.W - t.w0);
    stage_packed(xa, xb, min(pl.th + s.KH - 1, s.H - t.h0) * cols, s.Cin,
                 [&](int k) {
                   const int r = k / cols;
                   return xs + (r * HW + k - r * cols) * pp;
                 },
                 [&](int k) {
                   const int r = k / cols;
                   return xn + (size_t(t.h0 + r) * s.W + t.w0 + k - r * cols) *
                                   s.Cin;
                 });
    stage_weights(ws, s.KH * s.KW * s.Cin, bclog, t.co0, s.Cout,
                  [&](int r) { return w + size_t(r) * s.Cout; });
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kConvPix; ++k) {
      xo[k] = (tt.pr[k] * HW + tt.pc[k]) * pp;
    }
    conv_taps_mxu<uint32_t, kConvPix, kConvCh, KS>(
        s.KH, s.KW, [&](int i, int j, Sums) {
          run(s.Cin, xs + (i * HW + j) * pp, xo,
              ws + (((i * s.KW + j) * s.Cin) << bclog) + tt.cg * kConvCh);
        }, sum_m);
  } else {
    const int cs = pixel_pitch(pl.cc, 4);      // a pixel's staged pairs
    int32_t* ws = xs + (pl.th << pl.twlog) * cs;
#pragma unroll
    for (int k = 0; k < kConvPix; ++k) {
      xo[k] = ((tt.pr[k] << pl.twlog) + tt.pc[k]) * cs;
    }
    const int rows = min(pl.th, Ho - t.h0), cols = min(TW, Wo - t.w0);
    conv_taps_mxu<uint32_t, kConvPix, kConvCh, KS>(
        s.KH, s.KW, [&](int i, int j, Sums) {
          for (int c0 = 0; c0 < s.Cin; c0 += pl.cc) {
            const int len = min(pl.cc, s.Cin - c0);
            __syncthreads();                   // the last chunk is consumed
            stage_packed(xa, xb, rows * cols, len,
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
            __syncthreads();
            run(len, xs, xo, ws + tt.cg * kConvCh);
          }
        }, sum_m);
  }
  const uint32_t bias = uint32_t(blocks) * kPairBias;
  int32_t ra[kConvPix][kConvCh], rb[kConvPix][kConvCh];
#pragma unroll
  for (int k = 0; k < kConvPix; ++k) {
#pragma unroll
    for (int q = 0; q < kConvCh; ++q) {
      ra[k][q] = int32_t(sum_a[k][q] - bias);
      rb[k][q] = int32_t(sum_m[k][q] - (sum_a[k][q] << 16) - bias);
    }
  }
  store_tile(ya, s, Ho, Wo, t, tt.cg, tt.pr, tt.pc, ra);
  store_tile(yb, s, Ho, Wo, t, tt.cg, tt.pr, tt.pc, rb);
}

// A tile plan fits the conv and the CTA: 4 << glog channels, th x
// 2^twlog pixels (twlog <= max_twlog), kConvPix a lane, chunks of Cin.
inline bool plan_ok(int glog, int twlog, int max_twlog, int th, int cc,
                    int Cin, int whole) {
  return glog >= 0 && glog <= 3 && twlog >= 0 && twlog <= max_twlog &&
         th >= 1 && (th << twlog) == (kThreads >> glog) * kConvPix &&
         cc >= 1 && cc <= Cin && (!whole || cc == Cin);
}

// Launch a tiled kernel over ctas CTAs with bytes of dynamic shared
// memory (raising the kernel's limit where above 48 KB).
template <typename Kernel, typename... Args>
int launch_tiled(Kernel kernel, long long ctas, size_t bytes,
                 cudaStream_t st, Args... args) {
  if (ctas > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return int(err);
    }
  }
  kernel<<<unsigned(ctas), kThreads, bytes, st>>>(args...);
  return int(cudaGetLastError());
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
  if (!plan_ok(glog, twlog, 5, th, cc, Cin, whole) || !types ||
      (style != kVpu && style != kMxu)) {
    return int(cudaErrorInvalidValue);
  }
  ConvShape s{H, W, Cin, KH, KW, Cout};
  const int Ho = H - KH + 1, Wo = W - KW + 1, TW = 1 << twlog;
  const int bc = 4 << glog;
  TilePlan pl{glog, twlog, th, cc, (Wo + TW - 1) / TW, (Ho + th - 1) / th,
               (Cout + bc - 1) / bc};
  const long long ctas = (long long)N * pl.tiles_h * pl.tiles_w * pl.cblocks;
  const int sz = dtype == kF32 ? 4 : dtype == kI8 ? 1 : 2;
  const size_t bytes = tile_smem_bytes(style, ns, s, pl, sz, whole);
  cudaStream_t st = cudaStream_t(stream);
  auto run = [&](auto kernel, auto... args) {
    return launch_tiled(kernel, ctas, bytes, st, args..., s, Ho, Wo, pl);
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

// act_walk's split of a launch over numel elements of dtype: head, the
// elements before x's first 16-byte boundary, from x's address; vstore,
// whether y + head is 16-byte aligned too; the tiles of kThreads *
// kActVecs whole vectors; and the grid: kActCtasPerSm whole waves of the
// card's `sms` SMs, or one CTA a tile where the tensor has fewer tiles
// (at least one).  Refuses a dtype the activations do not take and an
// input or output not aligned to its element.
struct ActSplit {
  long long head, tiles, grid;
  bool vstore;
};

inline int act_split(int dtype, const void* x, const void* y,
                     long long numel, int sms, ActSplit& sp) {
  const int size = dtype == kF32 || dtype == kI32 ? 4 : dtype == kBF16 ? 2
                   : dtype == kI8 ? 1 : 0;
  const int osize = dtype == kBF16 ? 2 : 4;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  if (size == 0 || numel < 0 || sms < 1 || xa % size != 0 ||
      ya % osize != 0) {
    return int(cudaErrorInvalidValue);
  }
  sp.head = std::min(numel, (long long)((16 - xa % 16) % 16) / size);
  sp.vstore = (ya + sp.head * osize) % 16 == 0;
  const long long nvec = (numel - sp.head) / (16 / size);
  sp.tiles = (nvec + kThreads * kActVecs - 1) / (kThreads * kActVecs);
  sp.grid = std::max(1LL, std::min(sp.tiles, (long long)sms * kActCtasPerSm));
  return 0;
}

// Both pools on the cut of vpu_window.py::pool_plan: ve elements a
// thread (16 / sizeof(T) where C * sizeof(T) is a multiple of 16 and x
// and y are 16-byte aligned, else 1), outs outputs a thread lanes apart
// along a row, ctas CTAs; pool2d_im2col_kernel where im2col, else
// pool2d_kernel.  Refuses an unknown dtype or mode, a window larger
// than the input, a plan that does not cover the output exactly or a
// geometry past 32-bit index math.
int pool_launch(bool im2col, int dtype, int mode, const void* x, void* y,
                int N, int H, int W, int C, int KH, int KW, int SH, int SW,
                int ve, int outs, int lanes, long long ctas, void* stream) {
  const int size = dtype == kF32 || dtype == kI32 ? 4 : dtype == kBF16 ? 2
                   : dtype == kI8 ? 1 : 0;
  if (size == 0 || (mode != kMax && mode != kAvg) || N < 1 || C < 1 ||
      KH < 1 || KW < 1 || SH < 1 || SW < 1 || KH > H || KW > W ||
      (long long)H * W * C > 0x7fffffffLL) {
    return int(cudaErrorInvalidValue);
  }
  const int Ho = (H - KH) / SH + 1, Wo = (W - KW) / SW + 1;
  const bool vec = ve == 16 / size;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  if (!(ve == 1 || (vec && C % ve == 0 && aligned)) || outs < 1 ||
      outs > kPoolOuts || lanes < 1 || (long long)lanes * outs < Wo ||
      (long long)(lanes - 1) * outs >= Wo) {
    return int(cudaErrorInvalidValue);
  }
  const WindowPlan wp{ve, outs, lanes, C / ve};
  const long long threads = (long long)N * Ho * lanes * wp.cv;
  if (threads > 0x7fffffffLL - kThreads ||
      ctas != (threads + kThreads - 1) / kThreads) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = cudaStream_t(stream);
  auto run = [&](auto window, auto stacked, auto xp, auto yp) {
    (im2col ? stacked : window)<<<unsigned(ctas), kThreads, 0, st>>>(
        xp, yp, N, H, W, C, KH, KW, SH, SW, Ho, Wo, wp);
    return int(cudaGetLastError());
  };
  // T, V, O: input, reduce and stored types; each mode on both paths
#define CNN_POOL_VE(T, V, O, M, VE)                                         \
  run(pool2d_kernel<T, V, O, M, VE>, pool2d_im2col_kernel<T, V, O, M, VE>,  \
      (const T*)x, (O*)y)
#define CNN_POOL(T, V, O, M)                                                \
  return vec ? CNN_POOL_VE(T, V, O, M, 16 / int(sizeof(T)))                 \
             : CNN_POOL_VE(T, V, O, M, 1)
  if (dtype == kF32) {
    if (mode == kMax) CNN_POOL(float, float, float, kMax);
    CNN_POOL(float, float, float, kAvg);
  }
  if (dtype == kBF16) {
    if (mode == kMax) CNN_POOL(__nv_bfloat16, float, __nv_bfloat16, kMax);
    CNN_POOL(__nv_bfloat16, float, float, kAvg);
  }
  if (dtype == kI8) {
    if (mode == kMax) CNN_POOL(int8_t, int32_t, int8_t, kMax);
    CNN_POOL(int8_t, int32_t, int32_t, kAvg);
  }
  if (mode == kMax) CNN_POOL(int32_t, int32_t, int32_t, kMax);
  CNN_POOL(int32_t, int32_t, int32_t, kAvg);
#undef CNN_POOL
#undef CNN_POOL_VE
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

// pool_vpu (pool2d_window) on pool_launch's checks and cut.
int cnn_pool2d(int dtype, int mode, const void* x, void* y, int N, int H,
               int W, int C, int KH, int KW, int SH, int SW, int ve,
               int outs, int lanes, long long ctas, void* stream) {
  return pool_launch(false, dtype, mode, x, y, N, H, W, C, KH, KW, SH, SW,
                     ve, outs, lanes, ctas, stream);
}

// act_split as a query (no launch): out = head, vstore, tiles, grid.
int cnn_activation_plan(int dtype, const void* x, const void* y,
                        long long numel, int sms, long long* out) {
  ActSplit sp;
  const int err = act_split(dtype, x, y, numel, sms, sp);
  if (err == 0) {
    out[0] = sp.head;
    out[1] = sp.vstore;
    out[2] = sp.tiles;
    out[3] = sp.grid;
  }
  return err;
}

// activation_exact on act_split's split.
int cnn_activation(int dtype, int kind, const void* x, void* y,
                   long long numel, int sms, void* stream) {
  ActSplit sp;
  if (kind < kRelu || kind > kGelu || act_split(dtype, x, y, numel, sms,
                                                sp) != 0) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = cudaStream_t(stream);
  auto run = [&](auto kernel, auto xp, auto yp) {
    kernel<<<unsigned(sp.grid), kThreads, 0, st>>>(xp, yp, numel,
                                                   int(sp.head), sp.vstore);
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

// activation_lut on act_split's split.
int cnn_activation_lut(int dtype, const void* x, const float* table,
                       void* y, long long numel, float r, float s, int sms,
                       void* stream) {
  ActSplit sp;
  if (act_split(dtype, x, y, numel, sms, sp) != 0) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = cudaStream_t(stream);
  auto run = [&](auto kernel, auto xp, auto yp) {
    kernel<<<unsigned(sp.grid), kThreads, 0, st>>>(
        xp, table, yp, numel, int(sp.head), sp.vstore, r, s);
    return int(cudaGetLastError());
  };
#define CNN_LUT(T)                                                          \
  return run(activation_lut_kernel<T>, (const T*)x, (ActOut<T>::type*)y)
  if (dtype == kF32) CNN_LUT(float);
  if (dtype == kBF16) CNN_LUT(__nv_bfloat16);
  if (dtype == kI8) CNN_LUT(int8_t);
  CNN_LUT(int32_t);
#undef CNN_LUT
}

// pool_im2col (pool2d_im2col): the window pool's checks, cut and body
// under pool2d_im2col_kernel.
int cnn_pool2d_im2col(int dtype, int mode, const void* x, void* y, int N,
                      int H, int W, int C, int KH, int KW, int SH, int SW,
                      int ve, int outs, int lanes, long long ctas,
                      void* stream) {
  return pool_launch(true, dtype, mode, x, y, N, H, W, C, KH, KW, SH, SW,
                     ve, outs, lanes, ctas, stream);
}

// The fused block on the tile plan (glog, twlog, th, cc, whole) and the
// pooled tile (tp, tq) of kernels/conv2d/inner.py::fused_plan: conv of
// style kVpu (Conv1's body) or kMxu (Conv2's), on f32, bf16, int8 or
// int16; f32 out.  scale (one f32 a channel) or null.
int cnn_fused(int style, int dtype, const void* x, const void* w,
              const float* scale, float* y, int N, int H, int W, int Cin,
              int KH, int KW, int Cout, int PH, int PW, int SH, int SW,
              int mode, int kind, int glog, int twlog, int th, int cc,
              int whole, int tp, int tq, void* stream) {
  const int Ho = H - KH + 1, Wo = W - KW + 1, TW = 1 << twlog;
  const int bc = 4 << glog;
  if ((style != kVpu && style != kMxu) || mode < kMax || mode > kAvg ||
      kind < kRelu || kind > kGelu || PH < 1 || PW < 1 || SH < 1 ||
      SW < 1 || PH > Ho || PW > Wo ||
      !plan_ok(glog, twlog, 11, th, cc, Cin, whole) || tp < 1 || tq < 1 ||
      tp * tq > (kThreads >> glog) * kConvPix) {
    return int(cudaErrorInvalidValue);
  }
  ConvShape s{H, W, Cin, KH, KW, Cout};
  const int Po = (Ho - PH) / SH + 1, Qo = (Wo - PW) / SW + 1;
  const int rows = (tp - 1) * SH + PH, cols = (tq - 1) * SW + PW;
  PoolPlan pp{PH, PW, SH, SW, Po, Qo, tp, tq, (Po + tp - 1) / tp,
              (Qo + tq - 1) / tq, (rows + th - 1) / th, (cols + TW - 1) / TW};
  // column segments keep each window's taps i-major only one row a band
  if (pp.col_segs > 1 && th != 1) return int(cudaErrorInvalidValue);
  TilePlan pl{glog, twlog, th, cc, pp.tiles_q, pp.tiles_p,
              (Cout + bc - 1) / bc};
  const long long ctas =
      (long long)N * pp.tiles_p * pp.tiles_q * pl.cblocks;
  const int sz = dtype == kF32 ? 4 : dtype == kI8 ? 1 : 2;
  // the band of conv values reuses the staged inputs' space
  const size_t bytes = std::max(tile_smem_bytes(style, 1, s, pl, sz, whole),
                                size_t(kBandValues) * 4);
  cudaStream_t st = cudaStream_t(stream);
  auto run = [&](auto kernel, auto xp, auto wp) {
    return launch_tiled(kernel, ctas, bytes, st, xp, wp, scale, y, s, Ho, Wo,
                        pl, pp, mode, kind);
  };
  const bool k3 = KH == 3 && KW == 3;
#define CNN_FUSED(T, S)                                                     \
  {                                                                         \
    const T* xp = (const T*)x;                                              \
    const T* wp = (const T*)w;                                              \
    if (!whole) return run(fused_cnn_tiled_kernel<T, S, 0, false>, xp, wp); \
    if (k3) return run(fused_cnn_tiled_kernel<T, S, 3, true>, xp, wp);      \
    return run(fused_cnn_tiled_kernel<T, S, 0, true>, xp, wp);              \
  }
#define CNN_FUSED_STYLES(T)                                                 \
  {                                                                         \
    if (style == kVpu) CNN_FUSED(T, kVpu)                                   \
    CNN_FUSED(T, kMxu)                                                      \
  }
  if (dtype == kF32) CNN_FUSED_STYLES(float)
  if (dtype == kBF16) CNN_FUSED_STYLES(__nv_bfloat16)
  if (dtype == kI8) CNN_FUSED_STYLES(int8_t)
  if (dtype == kI16) CNN_FUSED_STYLES(int16_t)
#undef CNN_FUSED_STYLES
#undef CNN_FUSED
  return int(cudaErrorInvalidValue);
}

// ip: 3 (Conv3, int8, on the tile plan of tile_plan(style="packed")) or
// 4 (Conv4, on that of tile_plan(style="mxu", streams=2)); the plan is
// (glog, twlog, th, cc, whole).
int cnn_conv2d_dual(int ip, int dtype, const void* xa, const void* xb,
                    const void* w, void* ya, void* yb, int N, int H, int W,
                    int Cin, int KH, int KW, int Cout, int glog, int twlog,
                    int th, int cc, int whole, void* stream) {
  if (ip == 4) {
    const void* const x[2] = {xa, xb};
    void* const y[2] = {ya, yb};
    return conv_tiled(kMxu, 2, dtype, x, w, y, N, H, W, Cin, KH, KW, Cout,
                      glog, twlog, th, cc, whole, stream);
  }
  if (ip != 3 || dtype != kI8 || !plan_ok(glog, twlog, 5, th, cc, Cin, whole)) {
    return int(cudaErrorInvalidValue);
  }
  ConvShape s{H, W, Cin, KH, KW, Cout};
  const int Ho = H - KH + 1, Wo = W - KW + 1, TW = 1 << twlog;
  const int bc = 4 << glog;
  TilePlan pl{glog, twlog, th, cc, (Wo + TW - 1) / TW, (Ho + th - 1) / th,
              (Cout + bc - 1) / bc};
  const long long ctas = (long long)N * pl.tiles_h * pl.tiles_w * pl.cblocks;
  const size_t bytes = tile_smem_bytes(kPacked, 1, s, pl, 1, whole);
  cudaStream_t st = cudaStream_t(stream);
  auto run = [&](auto kernel) {
    return launch_tiled(kernel, ctas, bytes, st, (const int8_t*)xa,
                        (const int8_t*)xb, (const int8_t*)w, (int32_t*)ya,
                        (int32_t*)yb, s, Ho, Wo, pl);
  };
  if (!whole) return run(conv2d_ip3_tiled_kernel<0, false>);
  if (KH == 3 && KW == 3) return run(conv2d_ip3_tiled_kernel<3, true>);
  return run(conv2d_ip3_tiled_kernel<0, true>);
}

}  // extern "C"
