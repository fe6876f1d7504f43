"""Conv2 — single-matrix-unit convolution (paper: 1 DSP, low logic).

Replaces ``repro/kernels/conv2d/ip2_mxu.py::conv2d_ip2``.  The reference
builds the im2col tile and takes ONE dot over K = KH*KW*Cin; the kernel
(``conv2d_mxu_tiled_kernel`` in ``csrc/cnn_kernels.cu``) keeps that order
(``inner.accumulate_mxu``: one chain per output over (i, j, cin) from
0).  It shares Conv1's tiling (``inner.tile_plan(style="mxu")``): a CTA
of 256 threads owns a tile of output pixels of one image and a block of
output channels, stages the tile's input halo and the weights in shared
memory, and each thread keeps 8 pixels x 4 channels in registers, reading
a pixel's next 4 input channels as one 16-byte load.  It runs on CUDA
cores (FP32 FMA / int32 multiply-add): Hopper's tensor cores have no
IEEE-f32 mode and TF32 misses the reference tolerance; a 3xTF32 route
would move Conv2, Conv4 and ``fused_cnn_mxu`` together (ROADMAP queue 2).
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import Footprint, cost_cycles, mxu_pass_cycles
from repro_torch.kernels.conv2d.inner import (  # noqa: F401 (re-exported)
                                              CUDA_DTYPES, check_block,
                                              check_conv_operands, conv_mxu,
                                              launch_conv_tiled)


def conv2d_ip2_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's order
    (``inner.conv_mxu``)."""
    return conv_mxu(x, w)


def conv2d_ip2(x: torch.Tensor, w: torch.Tensor, *,
               block_cout: int = 128) -> torch.Tensor:
    """Valid stride-1 conv in the im2col order; see ``conv2d_ip1``."""
    check_conv_operands(x, w)
    check_block("block_cout", block_cout)
    if not x.is_cuda:
        return conv2d_ip2_plain(x, w)
    return launch_conv_tiled("conv2d_ip2", "cnn_conv2d", "mxu", x, w,
                             block_cout)


def footprint(n, h, w, cin, kh, kw, cout, *, itemsize=1,
              block_cout: int = 128) -> Footprint:
    ho, wo = h - kh + 1, w - kw + 1
    bc = min(block_cout, cout)
    k = kh * kw * cin
    vmem = (h * w * cin * itemsize
            + ho * wo * k * itemsize          # im2col patches
            + k * bc * itemsize
            + ho * wo * bc * 4)
    hbm = (n * h * w * cin * itemsize
           + kh * kw * cin * cout * itemsize
           + n * ho * wo * cout * 4)
    passes = n * ((cout + bc - 1) // bc)
    cyc = n * mxu_pass_cycles(ho * wo, k, cout)
    vpu = n * ho * wo * k                     # im2col data movement ops
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=passes,
                     vpu_ops=vpu,
                     est_cycles=cost_cycles(cyc, hbm),
                     outputs_per_pass=1, max_operand_bits=32)
