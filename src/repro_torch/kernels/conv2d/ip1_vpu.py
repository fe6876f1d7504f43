"""Conv1 — logic-only convolution (paper: 0 DSP, high LUT/CLB usage).

Replaces ``repro/kernels/conv2d/ip1_vpu.py::conv2d_ip1``.  On the card
the kernel (``conv2d_vpu_tiled_kernel`` in ``csrc/cnn_kernels.cu``)
issues no tensor-core instruction: every multiply-accumulate is a
CUDA-core FMA (f32) or int32 multiply-add (int8), in the Conv1 order of
``inner.accumulate_vpu`` (per tap, a partial over Cin in ascending
order, then added into the accumulator).  A CTA of 256 threads owns a
tile of output pixels of one image and a block of output channels,
stages the tile's input halo and the weights in shared memory
(``tile_plan``), and each thread keeps 8 pixels x 4 channels in
registers.  This is the member the selector picks when the matrix unit
is spoken for (``budget.mxu_available=False``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.resources import Footprint, cost_cycles, vpu_op_cycles
from repro_torch.kernels import cuda
from repro_torch.kernels.conv2d.inner import (accumulate_vpu, check_block,
                                              check_conv_operands,
                                              conv_output)

THREADS = 256        # a CTA
PIXELS = 8           # output pixels a thread
QUAD = 4             # output channels a thread
MAX_QUADS = 8        # channel quads a CTA (32 channels)
MAX_TILE_W = 32      # output columns a tile
SMEM_BYTES = 96 * 1024   # shared memory a CTA may stage (two fit an SM)


class TilePlan(NamedTuple):
    """How ``conv2d_vpu_tiled_kernel`` cuts one conv: CTAs of ``bc``
    output channels and ``th`` x ``tw`` output pixels of one image;
    ``whole``: a tile's input halo, (th + KH - 1) x (tw + KW - 1) x Cin,
    and every tap's weights are staged in one go; else each (tap, chunk
    of ``cc`` input channels) is staged in turn, the tap's partial
    carrying across the chunks."""
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


def tile_plan(h: int, w: int, cin: int, kh: int, kw: int, cout: int, *,
              itemsize: int, block_cout: int = 128,
              smem_bytes: int = SMEM_BYTES) -> TilePlan:
    """The kernel's tile plan for an (h, w, cin) input and (kh, kw, cin,
    cout) weights of ``itemsize``-byte elements.  ``block_cout`` caps
    the channels a CTA covers (rounded up to a power-of-two number of
    quads); the result never depends on it.  The kernel's launcher
    checks the plan and computes the same shared-memory size."""
    ho, wo = h - kh + 1, w - kw + 1
    quads = -(-min(block_cout, cout) // QUAD)
    glog = min((quads - 1).bit_length(), MAX_QUADS.bit_length() - 1)
    twlog = min((wo - 1).bit_length(), MAX_TILE_W.bit_length() - 1)
    th = (THREADS >> glog) * PIXELS >> twlog
    bc, tw, vec = QUAD << glog, 1 << twlog, 16 // itemsize
    rp = _round_up((tw + kw - 1) * cin, vec)
    whole = (_round_up((th + kh - 1) * rp * itemsize, 16)
             + kh * kw * cin * bc * itemsize)
    if whole <= smem_bytes:
        return TilePlan(glog, twlog, th, cin, True)
    per_channel = (th * tw + bc) * itemsize
    cc = max(vec, smem_bytes // per_channel // vec * vec)
    return TilePlan(glog, twlog, th, min(cc, cin), False)


def conv2d_ip1_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's order."""
    acc = torch.float32 if x.is_floating_point() else torch.int32
    return accumulate_vpu(x.to(acc), w, ho=x.shape[1] - w.shape[0] + 1,
                          wo=x.shape[2] - w.shape[1] + 1, acc_dtype=acc)


def conv2d_ip1(x: torch.Tensor, w: torch.Tensor, *,
               block_cout: int = 128) -> torch.Tensor:
    """Valid stride-1 conv, NHWC x HWIO -> (N, Ho, Wo, Cout) in f32 (float
    operands) or int32 (int8 operands).  CUDA tensors launch the kernel
    once; CPU tensors run ``conv2d_ip1_plain``."""
    check_conv_operands(x, w)
    check_block("block_cout", block_cout)
    if not x.is_cuda:
        return conv2d_ip1_plain(x, w)
    y = conv_output(x, w)
    if y.numel() == 0:
        return y
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    plan = tile_plan(h, w_, cin, kh, kw, cout, itemsize=x.element_size(),
                     block_cout=int(block_cout))
    cuda.launch("conv2d_ip1", "cnn_conv1", x.device,
                cuda.DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                y.data_ptr(), n, h, w_, cin, kh, kw, cout, plan.glog,
                plan.twlog, plan.th, plan.cc, int(plan.whole))
    return y


def footprint(n, h, w, cin, kh, kw, cout, *, itemsize=1,
              block_cout: int = 128) -> Footprint:
    ho, wo = h - kh + 1, w - kw + 1
    bc = min(block_cout, cout)
    vmem = (h * w * cin * itemsize            # x plane
            + kh * kw * cin * bc * itemsize   # weight tile
            + ho * wo * bc * 4)               # int32/f32 accumulator
    hbm = (n * h * w * cin * itemsize
           + kh * kw * cin * cout * itemsize
           + n * ho * wo * cout * 4)
    vpu = n * ho * wo * cout * kh * kw * cin * 2   # mul+add per tap
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=0,
                     vpu_ops=vpu,
                     est_cycles=cost_cycles(vpu_op_cycles(vpu), hbm),
                     outputs_per_pass=1, max_operand_bits=32)
