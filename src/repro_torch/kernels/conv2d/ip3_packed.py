"""Conv3 — operand-packed dual convolution (paper: 1 DSP, two convs per
pass, operands limited to 8 bits).

Replaces ``repro/kernels/conv2d/ip3_packed.py::conv2d_ip3``.  The
paper's trick: two 8-bit products share one wide multiplier.  The
reference packs per tap

    p   = a * 2^16 + b           # a, b int8-valued, p int32
    m   = p * w                  # ONE multiply, |m| < 2^31
    bw  = ((m + 2^15) mod 2^16) - 2^15    # signed low half == b*w
    aw  = (m - bw) / 2^16                 # exact: the borrow-corrected high

and sums the two products in two int32 lanes, because int32 lanes
cannot accumulate packed.  The kernel (``conv2d_ip3_tiled_kernel`` in
``csrc/cnn_kernels.cu``, on ``inner.tile_plan(style="packed")``: the
tiled convs' cut, both streams' halos staged once as packed int32 pairs
in Conv2's layout, the weights widened to int32) keeps the packing and
the one multiply per tap pair, and sums two products packed before it
splits them: over two pairs each stream's sum lies in [-32512, 32768],
so with a bias of 32512 both halves fit 16 bits and the split is exact,
at half the unpack operations per pair.  Measured beside it on the
H100, a per-pair unpack and a 64-bit packed accumulation
(``a * 2^23 + b``, one ``mad.wide.s32`` a pair) were slower.  Integer
sums wrap modulo 2^32 whatever their order, so both streams are the
reference's bit for bit.  It issues no MMA instruction: this is a
logic-only member (``mxu_available=False``).  ``conv2d_ip3_plain``
runs the reference's per-pair arithmetic in PyTorch.

Operand ceiling: 8 bits, as in the paper (``|b*w|`` must fit 15 bits).
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import Footprint, cost_cycles, vpu_op_cycles
from repro_torch.kernels.conv2d.inner import (check_block,
                                              check_dual_operands, im2col,
                                              launch_conv_dual)


def _unpack(m: torch.Tensor):
    """Recover (a*w, b*w) from int32 m = (a * 2^16 + b) * w, exactly."""
    low = ((m + (1 << 15)) & 0xFFFF) - (1 << 15)   # signed low 16 bits
    high = torch.div(m - low, 1 << 16, rounding_mode="floor")  # exact
    return high, low


# operand dtypes the CUDA kernel takes
CUDA_DTYPES = (torch.int8,)


def _check_int8(xa, xb, w) -> None:
    if xa.dtype != torch.int8 or xb.dtype != torch.int8 or \
            w.dtype != torch.int8:
        raise TypeError("Conv3 is limited to 8-bit operands (paper Table "
                        f"I); got {xa.dtype}, {xb.dtype}, {w.dtype}")


def conv2d_ip3_plain(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor):
    """The kernel's function in plain PyTorch: the packed multiply per
    tap pair over the im2col patches, unpacked, each stream summed over
    K (integer sums: any order gives the same wrapped int32)."""
    kh, kw, cin, cout = w.shape
    ho, wo = xa.shape[1] - kh + 1, xa.shape[2] - kw + 1
    packed = xa.to(torch.int32) * (1 << 16) + xb.to(torch.int32)
    patches = im2col(packed, kh, kw, ho=ho, wo=wo)        # (N, Ho, Wo, K)
    wmat = w.reshape(kh * kw * cin, cout).to(torch.int32)
    aw, bw = _unpack(patches[..., :, None] * wmat)        # one mul / pair
    return aw.sum(dim=-2, dtype=torch.int32), bw.sum(dim=-2,
                                                     dtype=torch.int32)


def conv2d_ip3(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor, *,
               block_cout: int = 128):
    """Two valid stride-1 int8 convs sharing ``w`` -> two (N, Ho, Wo,
    Cout) int32 tensors.  CUDA tensors launch the kernel once; CPU
    tensors run ``conv2d_ip3_plain``."""
    _check_int8(xa, xb, w)
    check_dual_operands(xa, xb, w)
    check_block("block_cout", block_cout)
    if not xa.is_cuda:
        return conv2d_ip3_plain(xa, xb, w)
    return launch_conv_dual("conv2d_ip3", 3, xa, xb, w, block_cout,
                            CUDA_DTYPES)


def footprint(n, h, w, cin, kh, kw, cout, *, itemsize=1,
              block_cout: int = 128) -> Footprint:
    ho, wo = h - kh + 1, w - kw + 1
    bc = min(block_cout, cout)
    vmem = (2 * h * w * cin * itemsize
            + h * w * cin * 4                 # packed plane
            + kh * kw * cin * bc * itemsize
            + 2 * ho * wo * bc * 4)
    hbm = (2 * n * h * w * cin * itemsize
           + kh * kw * cin * cout * itemsize
           + 2 * n * ho * wo * cout * 4)
    taps = n * ho * wo * cout * kh * kw * cin
    # ONE multiply per tap-pair, ~5 cheap ops for unpack+acc.
    vpu = taps * 6
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=0,
                     vpu_ops=vpu,
                     est_cycles=cost_cycles(vpu_op_cycles(vpu), hbm),
                     outputs_per_pass=2, max_operand_bits=8)
