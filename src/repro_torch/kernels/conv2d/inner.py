"""Shared conv bodies — the single source of the per-tile convolution
math, in the two orders of the reference (``repro.kernels.conv2d.inner``).

On the card these are the ``__device__`` functions of
``csrc/cnn_device.cuh`` (``conv_taps_vpu`` / ``conv_part_vpu`` and
``conv_taps_mxu`` / ``conv_run``), which the standalone members
(``ip1_vpu``, ``ip2_mxu`` and Conv4's ``ip4_dual``) and the fused members
(``kernels/fused/cnn_block.py``) all call.  The functions below are their
plain PyTorch versions in the same order, which the CPU path runs and the
on-card checks compare against:

* vpu: for each tap (i, j), a partial that starts at 0 takes the shifted
  window's products with the tap over Cin in ascending order, then adds
  into the accumulator (the kernels' chain, with FMA there);
* mxu: one chain per output over K = (i, j, cin) in ascending order,
  starting from 0 (the im2col dot of the reference, taken in order);
  the plain versions run it in float64 for float operands (``conv_mxu``).

The two standalone members run the tiled kernels of ``csrc/cnn_kernels.cu``
(``conv2d_vpu_tiled_kernel`` / ``conv2d_mxu_tiled_kernel``) on the plan of
``tile_plan``; ``launch_conv_tiled`` checks their operands, allocates the
output and launches one of them.

The dual-stream members (``ip3_packed``, ``ip4_dual``) share
``launch_conv_dual``, one launch that writes both streams' outputs; Conv4
runs Conv2's tiled kernel with two streams on ``tile_plan(style="mxu",
streams=2)``: both streams' halos and the weights, once, in one tile;
Conv3 runs ``conv2d_ip3_tiled_kernel`` on ``tile_plan(style="packed")``:
the same cut, both streams' halos staged once as packed int32 pairs in
Conv2's layout, the weights widened to int32.

The fused members (``kernels/fused/cnn_block.py``) run
``fused_cnn_tiled_kernel`` on ``fused_plan``: the conv tile plan of their
style, cut in pooled space (``FusedPlan``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import cuda

STYLE_CODE = {"vpu": 0, "mxu": 1}
# tile_plan's styles: the two conv orders' staging, and Conv3's packed
# pairs (Conv2's layout, 4 bytes a pair and a weight)
PLAN_STYLES = ("vpu", "mxu", "packed")
THREADS = 256        # a CTA of the tiled kernels
PIXELS = 8           # output pixels a thread
QUAD = 4             # output channels a thread
MAX_QUADS = 8        # channel quads a CTA (32 channels)
MAX_TILE_W = 32      # output columns a tile
SMEM_BYTES = 96 * 1024   # shared memory a CTA may stage (two fit an SM)
# the fused kernel's band of conv values in shared memory: a tile's
# THREADS * PIXELS pixel-points x QUAD channels of 4 bytes, whatever the
# plan (32 KB), over the staged inputs' space
BAND_BYTES = THREADS * PIXELS * QUAD * 4
# the fused kernel's widest band: 2^MAX_BAND_LOG pixels in one row (glog 0)
MAX_BAND_LOG = (THREADS * PIXELS).bit_length() - 1
# operand dtypes the tiled kernels take: floats accumulate in f32 (bf16
# widened exactly), integers in int32
CUDA_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.int16)


class TilePlan(NamedTuple):
    """How a tiled conv kernel cuts one conv: CTAs of ``bc`` output
    channels and ``th`` x ``tw`` output pixels of one image; ``whole``:
    a tile's input halo, (th + KH - 1) x (tw + KW - 1) x Cin, and every
    tap's weights are staged in one go; else each (tap, chunk of ``cc``
    input channels) is staged in turn, the taps outermost, so each
    output's order carries across the chunks."""
    glog: int        # bc = QUAD << glog
    twlog: int       # tw = 1 << twlog
    th: int
    cc: int
    whole: bool

    @property
    def bc(self) -> int:
        return QUAD << self.glog

    @property
    def tw(self) -> int:
        return 1 << self.twlog


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pixel_pitch(n: int, vec: int) -> int:
    """Conv2's staged elements a pixel for ``n`` channels: whole 16-byte
    chunks of ``vec`` elements, an odd number of them, so neighbouring
    pixels lie in different shared-memory banks."""
    p = _round_up(n, vec)
    return p if (p // vec) % 2 else p + vec


def tile_smem_bytes(plan: TilePlan, kh: int, kw: int, cin: int, *,
                    itemsize: int, style: str = "vpu",
                    streams: int = 1) -> int:
    """The shared memory a CTA of ``plan`` stages, as the kernels'
    launcher (``tile_smem_bytes`` of ``csrc/cnn_kernels.cu``) computes it:
    ``whole``, the input halo then every tap's weights; else one chunk's
    shifted tile then its weights.  Conv1 (``vpu``) stages the halo's
    rows as they lie, Conv2 (``mxu``) each pixel at ``pixel_pitch``, a
    halo (or chunk) for each of its ``streams`` (Conv4: two) and the
    weights once; Conv3 (``packed``) Conv2's layout of 4-byte packed
    pairs, the weights widened to 4 bytes."""
    if style == "packed":
        style, itemsize = "mxu", 4
    vec, tw = 16 // itemsize, plan.tw
    weights = (kh * kw * cin if plan.whole else plan.cc) * plan.bc * itemsize
    if style == "mxu":
        pixels = ((plan.th + kh - 1) * (tw + kw - 1) if plan.whole
                  else plan.th * tw)
        return (streams * pixels
                * pixel_pitch(cin if plan.whole else plan.cc, vec)
                * itemsize + weights)
    if plan.whole:
        rp = _round_up((tw + kw - 1) * cin, vec)
        return _round_up((plan.th + kh - 1) * rp * itemsize, 16) + weights
    return plan.th * tw * _round_up(plan.cc, vec) * itemsize + weights


def _channel_log(cout: int, block_cout: int) -> int:
    """glog: a CTA's channel quads, 2^glog, cover min(block_cout, cout)
    rounded up to a power of two, at most MAX_QUADS."""
    quads = -(-min(block_cout, cout) // QUAD)
    return min((quads - 1).bit_length(), MAX_QUADS.bit_length() - 1)


def _staged(glog: int, twlog: int, kh: int, kw: int, cin: int, *,
            itemsize: int, smem_bytes: int, style: str,
            streams: int) -> TilePlan:
    """The tile plan of the cut (glog, twlog): the halos staged whole
    where ``tile_smem_bytes`` fits ``smem_bytes``, else in chunks of
    input channels sized to fit."""
    th = (THREADS >> glog) * PIXELS >> twlog
    plan = TilePlan(glog, twlog, th, cin, True)
    if tile_smem_bytes(plan, kh, kw, cin, itemsize=itemsize, style=style,
                       streams=streams) <= smem_bytes:
        return plan
    vec, pixels = 16 // itemsize, (th << twlog) * streams
    # Conv2's pixel pitch may add a chunk a pixel
    spare = smem_bytes - (pixels * vec * itemsize if style == "mxu" else 0)
    per_channel = (pixels + plan.bc) * itemsize
    cc = max(vec, spare // per_channel // vec * vec)
    return plan._replace(cc=min(cc, cin), whole=False)


def tile_plan(h: int, w: int, cin: int, kh: int, kw: int, cout: int, *,
              itemsize: int, block_cout: int = 128,
              smem_bytes: int = SMEM_BYTES, style: str = "vpu",
              streams: int = 1) -> TilePlan:
    """The tile plan of the ``style`` kernel (``vpu``: Conv1's, ``mxu``:
    Conv2's, and with ``streams=2`` Conv4's; ``packed``: Conv3's) for
    (h, w, cin) inputs and (kh, kw, cin, cout) weights of
    ``itemsize``-byte elements.  ``block_cout`` caps the channels a CTA
    covers (rounded up to a power-of-two number of quads); the result
    never depends on it.  The kernels share the cut; the halos are
    staged whole where ``tile_smem_bytes`` fits ``smem_bytes``, else in
    chunks of input channels sized to fit.  The kernels' launcher checks
    the plan and computes the same shared-memory size."""
    if style not in PLAN_STYLES:
        raise ValueError(f"unknown style {style!r}; have {PLAN_STYLES}")
    if streams not in ((1, 2) if style == "mxu" else (1,)):
        raise ValueError(f"the {style} kernel takes no {streams} streams")
    if style == "packed":          # Conv2's staging of 4-byte pairs
        style, itemsize = "mxu", 4
    wo = w - kw + 1
    twlog = min((wo - 1).bit_length(), MAX_TILE_W.bit_length() - 1)
    return _staged(_channel_log(cout, block_cout), twlog, kh, kw, cin,
                   itemsize=itemsize, smem_bytes=smem_bytes, style=style,
                   streams=streams)


class FusedPlan(NamedTuple):
    """How the fused kernel cuts a conv -> pool -> act block: CTAs of
    ``tp`` x ``tq`` pooled outputs of one image and the conv tile's
    ``bc`` channels.  The conv rows and columns their windows read,
    (tp - 1) * SH + PH by (tq - 1) * SW + PW, are computed a conv tile
    (``tile``: th x tw pixels, staged as the style's conv stages them) at
    a time, in ``row_bands`` bands top to bottom of ``col_segs`` segments
    left to right (more than one only where th == 1), so each window
    takes its taps in i-major order across the bands.  The bands' conv
    values pass through shared memory (``BAND_BYTES``, over the staged
    inputs' space)."""
    tile: TilePlan
    tp: int
    tq: int
    row_bands: int
    col_segs: int


def fused_smem_bytes(plan: FusedPlan, kh: int, kw: int, cin: int, *,
                     itemsize: int, style: str) -> int:
    """The shared memory of a fused CTA, as ``cnn_fused`` computes it:
    the style's staged tile or the band of conv values, the larger."""
    return max(tile_smem_bytes(plan.tile, kh, kw, cin, itemsize=itemsize,
                               style=style), BAND_BYTES)


def fused_plan(h: int, w: int, cin: int, kh: int, kw: int, cout: int,
               ph: int, pw: int, sh: int, sw: int, *, itemsize: int,
               block_cout: int = 128, smem_bytes: int = SMEM_BYTES,
               style: str = "vpu") -> FusedPlan:
    """The fused kernel's plan for (h, w, cin) inputs, (kh, kw, cin,
    cout) weights and a (ph, pw) / (sh, sw) pool: the conv tile plan of
    ``style`` (``tile_plan``'s cut, its columns widened to hold a whole
    window row, at most 2^MAX_BAND_LOG), and as many pooled rows and
    columns a CTA as one tile's conv rows and columns hold, else one
    (the window is then walked in bands).  The result never depends on
    ``block_cout``; ``cnn_fused`` checks the plan."""
    if style not in STYLE_CODE:
        raise ValueError(f"unknown style {style!r}; have {tuple(STYLE_CODE)}")
    ho, wo = h - kh + 1, w - kw + 1
    po, qo = (ho - ph) // sh + 1, (wo - pw) // sw + 1
    glog = _channel_log(cout, block_cout)
    twlog = min((wo - 1).bit_length(), MAX_TILE_W.bit_length() - 1)
    need = (pw - 1).bit_length()           # 2^need >= pw
    if need > twlog:
        glog = min(glog, max(0, MAX_BAND_LOG - need))
        twlog = min(need, MAX_BAND_LOG - glog)
    tile = _staged(glog, twlog, kh, kw, cin, itemsize=itemsize,
                   smem_bytes=smem_bytes, style=style, streams=1)
    tp = min((tile.th - ph) // sh + 1, po) if ph <= tile.th else 1
    tq = min((tile.tw - pw) // sw + 1, qo) if pw <= tile.tw else 1
    rows, cols = (tp - 1) * sh + ph, (tq - 1) * sw + pw
    return FusedPlan(tile, tp, tq, -(-rows // tile.th), -(-cols // tile.tw))


def accumulate_vpu(x, w, *, ho: int, wo: int, acc_dtype):
    """Conv1-style: ``x`` (N, H, W, Cin) already in ``acc_dtype``,
    ``w`` (kh, kw, Cin, Cout).  Returns (N, Ho, Wo, Cout).  Every tap's
    partial takes the channels in ascending order from 0, then the taps'
    partials add into the accumulator in (i, j) order: the kernels'
    chain, all taps at once over a strided view of the windows."""
    kh, kw, cin, cout = w.shape
    n = x.shape[0]
    sn, sh, sw, sc = x.stride()
    windows = x.as_strided((n, ho, wo, kh, kw, cin), (sn, sh, sw, sh, sw, sc))
    taps = w.to(acc_dtype)
    part = torch.zeros((n, ho, wo, kh, kw, cout), dtype=acc_dtype,
                       device=x.device)
    for c in range(cin):
        part = part + windows[..., c, None] * taps[:, :, c]
    acc = torch.zeros((n, ho, wo, cout), dtype=acc_dtype, device=x.device)
    for i in range(kh):
        for j in range(kw):
            acc = acc + part[:, :, :, i, j]
    return acc


def im2col(x, kh: int, kw: int, *, ho: int, wo: int):
    """(N, H, W, Cin) -> (N, Ho, Wo, KH*KW*Cin) patches, K = (i, j, cin)."""
    return torch.cat([x[:, i:i + ho, j:j + wo, :] for i in range(kh)
                      for j in range(kw)], dim=-1)


def accumulate_mxu(x, w, *, ho: int, wo: int, acc_dtype):
    """Conv2-style: ``x`` (N, H, W, Cin), ``w`` (kh, kw, Cin, Cout).
    Returns (N, Ho, Wo, Cout) in ``acc_dtype``.  One chain per output over
    K = (i, j, cin) in ascending order, starting from 0: the kernels'
    chain (with FMA there), every output at once over a strided view of
    the windows."""
    kh, kw, cin, cout = w.shape
    xa = x.to(acc_dtype)
    n = xa.shape[0]
    sn, sh, sw, sc = xa.stride()
    windows = xa.as_strided((n, ho, wo, kh, kw, cin), (sn, sh, sw, sh, sw, sc))
    taps = w.to(acc_dtype)
    acc = torch.zeros((n, ho, wo, cout), dtype=acc_dtype, device=x.device)
    for i in range(kh):
        for j in range(kw):
            for c in range(cin):
                acc = acc + windows[:, :, :, i, j, c, None] * taps[i, j, c]
    return acc


def conv_mxu(x, w):
    """The Conv2 function as the plain versions compute it (Conv2, Conv4,
    ``fused_mxu``): ``accumulate_mxu``'s chain over the whole valid plane,
    in int32 (wrapping, so exact in any order) for integer operands, and
    for float operands in float64, rounded once to f32.  The kernels take
    the chain in f32; an f32 chain as long as K moves more requantized
    codes of the lowered plans away from the reference's than the
    code-flip rule of ``tests/test_torch_ladder.py`` allows, the f64
    chain does not."""
    ho, wo = x.shape[1] - w.shape[0] + 1, x.shape[2] - w.shape[1] + 1
    if x.is_floating_point():
        return accumulate_mxu(x, w, ho=ho, wo=wo,
                              acc_dtype=torch.float64).to(torch.float32)
    return accumulate_mxu(x, w, ho=ho, wo=wo, acc_dtype=torch.int32)


def check_conv_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d takes NHWC x and HWIO w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[-1] != w.shape[2]:
        raise ValueError(f"input channels {x.shape[-1]} != weight "
                         f"channels {w.shape[2]}")
    if w.shape[0] > x.shape[1] or w.shape[1] > x.shape[2]:
        raise ValueError(f"kernel {tuple(w.shape[:2])} exceeds the input "
                         f"plane {tuple(x.shape[1:3])}")


def check_dual_operands(xa: torch.Tensor, xb: torch.Tensor,
                        w: torch.Tensor) -> None:
    check_conv_operands(xa, w)
    if xa.shape != xb.shape or xa.dtype != xb.dtype:
        raise ValueError(f"the two streams must match: {tuple(xa.shape)} "
                         f"{xa.dtype} vs {tuple(xb.shape)} {xb.dtype}")


def check_block(name: str, value: int) -> None:
    if int(value) < 1:
        raise ValueError(f"{name} must be >= 1, got {value}")


def kernel_operands(x: torch.Tensor, w: torch.Tensor):
    """``x`` and ``w`` in one dtype of ``CUDA_DTYPES``, for a kernel that
    takes one operand type.  Float activations under weights of another
    dtype (a CNN block after the first of a bf16 or int16 frontend: f32
    activations, bf16 or int16 weights) run both in f32, which holds
    every value of every ``CUDA_DTYPES`` member: the plain versions cast
    both to their f32 accumulator, so the result is the same.  Integer
    activations under weights of another dtype raise ``TypeError``."""
    cuda.require(x, "x", CUDA_DTYPES)
    cuda.require(w, "w", CUDA_DTYPES)
    if w.dtype == x.dtype:
        return x, w
    if x.is_floating_point():
        return x.float(), w.float()
    raise TypeError(f"integer x {x.dtype} takes weights of its own dtype "
                    f"on the card, got {w.dtype}")


def conv_output(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Allocate a standalone member's output for CUDA operands of one
    dtype: float operands give f32, integer operands int32."""
    n, h, w_, _ = x.shape
    kh, kw, _, cout = w.shape
    out_dtype = torch.float32 if x.is_floating_point() else torch.int32
    return torch.empty((n, h - kh + 1, w_ - kw + 1, cout), dtype=out_dtype,
                       device=x.device)


def launch_conv_tiled(counter: str, entry: str, style: str, x: torch.Tensor,
                      w: torch.Tensor, block_cout: int) -> torch.Tensor:
    """Launch the tiled kernel of ``style`` (C entry point ``entry``)
    once for CUDA operands (``kernel_operands``), on the plan of
    ``tile_plan``."""
    x, w = kernel_operands(x, w)
    y = conv_output(x, w)
    if y.numel() == 0:
        return y
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    plan = tile_plan(h, w_, cin, kh, kw, cout, itemsize=x.element_size(),
                     block_cout=int(block_cout), style=style)
    cuda.launch(counter, entry, x.device, cuda.DTYPE_CODE[x.dtype],
                x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, w_, cin, kh,
                kw, cout, plan.glog, plan.twlog, plan.th, plan.cc,
                int(plan.whole))
    return y


def launch_conv_dual(counter: str, ip: int, xa: torch.Tensor,
                     xb: torch.Tensor, w: torch.Tensor, block_cout: int,
                     dtypes) -> tuple:
    """Launch ``conv2d_ip3_tiled_kernel`` (``ip=3``, on
    ``tile_plan(style="packed")``) or Conv2's tiled kernel with two
    streams (``ip=4``, on ``tile_plan(style="mxu", streams=2)``) of
    ``csrc/cnn_kernels.cu`` once for CUDA operands of one dtype among
    ``dtypes``: integers give int32, floats f32."""
    for t, what in ((xa, "xa"), (xb, "xb"), (w, "w")):
        cuda.require(t, what, dtypes)
    if xb.device != xa.device or w.device != xa.device or \
            w.dtype != xa.dtype:
        raise ValueError(f"xa, xb and w must share one device and dtype, "
                         f"got {xa.device}/{xa.dtype}, {xb.device}, "
                         f"{w.device}/{w.dtype}")
    n, h, w_, cin = xa.shape
    kh, kw, _, cout = w.shape
    out_dtype = torch.float32 if xa.is_floating_point() else torch.int32
    ya, yb = (torch.empty((n, h - kh + 1, w_ - kw + 1, cout),
                          dtype=out_dtype, device=xa.device)
              for _ in range(2))
    if ya.numel() == 0:
        return ya, yb
    style = dict(style="packed") if ip == 3 else dict(style="mxu", streams=2)
    plan = tile_plan(h, w_, cin, kh, kw, cout, itemsize=xa.element_size(),
                     block_cout=int(block_cout), **style)
    cuda.launch(counter, "cnn_conv2d_dual", xa.device, ip,
                cuda.DTYPE_CODE[xa.dtype], xa.data_ptr(), xb.data_ptr(),
                w.data_ptr(), ya.data_ptr(), yb.data_ptr(), n, h, w_, cin,
                kh, kw, cout, plan.glog, plan.twlog, plan.th, plan.cc,
                int(plan.whole))
    return ya, yb
