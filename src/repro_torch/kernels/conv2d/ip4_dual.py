"""Conv4 — dual parallel convolution (paper: 2 DSPs, two convs per pass,
full precision).

Replaces ``repro/kernels/conv2d/ip4_dual.py::conv2d_ip4``.  The
reference stacks the two streams' im2col and takes one batched dot
against one weight tile, fetched once for both.  The kernel is Conv2's
tiled kernel with two streams (``conv2d_mxu_tiled_kernel<T, 2, ...>`` in
``csrc/cnn_kernels.cu``) on ``inner.tile_plan(style="mxu", streams=2)``:
a CTA stages its pixel tile's input halo for both streams and the weight
tile once in shared memory, and each thread keeps 8 pixels of each
stream x 4 channels, so every weight quad it loads feeds both streams'
accumulators, in Conv2's (i, j, cin) order: each stream equals a
``conv2d_ip2`` launch bitwise.  Full operand width: int8/int16
accumulate in int32 (wrapping, as the reference's accumulator does),
bfloat16/float32 in f32 (bf16 widened exactly on load).  CUDA cores,
as Conv2 (ROADMAP, "f32 on tensor cores").
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import Footprint, cost_cycles, mxu_pass_cycles
from repro_torch.kernels.conv2d.inner import (check_block,
                                              check_dual_operands, conv_mxu,
                                              launch_conv_dual)

# operand dtypes the CUDA kernel takes
CUDA_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.int16)


def conv2d_ip4_plain(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor):
    """The kernel's function in plain PyTorch: each stream through the
    Conv2 order (``inner.conv_mxu``)."""
    return tuple(conv_mxu(x, w) for x in (xa, xb))


def conv2d_ip4(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor, *,
               block_cout: int = 128):
    """Two valid stride-1 convs sharing ``w`` -> two (N, Ho, Wo, Cout)
    tensors, int32 for integer operands and f32 for float ones.  CUDA
    tensors launch the kernel once; CPU tensors run
    ``conv2d_ip4_plain``."""
    check_dual_operands(xa, xb, w)
    check_block("block_cout", block_cout)
    if not xa.is_cuda:
        return conv2d_ip4_plain(xa, xb, w)
    return launch_conv_dual("conv2d_ip4", 4, xa, xb, w, block_cout,
                            CUDA_DTYPES)


def footprint(n, h, w, cin, kh, kw, cout, *, itemsize=1,
              block_cout: int = 128) -> Footprint:
    ho, wo = h - kh + 1, w - kw + 1
    bc = min(block_cout, cout)
    k = kh * kw * cin
    vmem = (2 * h * w * cin * itemsize
            + 2 * ho * wo * k * itemsize
            + k * bc * itemsize
            + 2 * ho * wo * bc * 4)
    hbm = (2 * n * h * w * cin * itemsize
           + kh * kw * cin * cout * itemsize   # weights fetched ONCE
           + 2 * n * ho * wo * cout * 4)
    passes = 2 * n * ((cout + bc - 1) // bc)
    cyc = 2 * n * mxu_pass_cycles(ho * wo, k, cout)
    vpu = 2 * n * ho * wo * k
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=passes,
                     vpu_ops=vpu,
                     est_cycles=cost_cycles(cyc, hbm),
                     outputs_per_pass=2, max_operand_bits=32)
