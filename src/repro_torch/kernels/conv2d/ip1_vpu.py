"""Conv1 — logic-only convolution (paper: 0 DSP, high LUT/CLB usage).

Replaces ``repro/kernels/conv2d/ip1_vpu.py::conv2d_ip1``.  On the card
the kernel (``conv2d_vpu_tiled_kernel`` in ``csrc/cnn_kernels.cu``)
issues no tensor-core instruction: every multiply-accumulate is a
CUDA-core FMA (f32, bf16 widened exactly) or int32 multiply-add (int8,
int16), in the Conv1 order of
``inner.accumulate_vpu`` (per tap, a partial over Cin in ascending
order, then added into the accumulator).  A CTA of 256 threads owns a
tile of output pixels of one image and a block of output channels,
stages the tile's input halo and the weights in shared memory
(``inner.tile_plan``, re-exported here), and each thread keeps 8 pixels
x 4 channels in registers.  This is the member the selector picks when
the matrix unit is spoken for (``budget.mxu_available=False``).
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import Footprint, cost_cycles, vpu_op_cycles
from repro_torch.kernels.conv2d.inner import (  # noqa: F401 (re-exported)
    CUDA_DTYPES, MAX_QUADS, MAX_TILE_W, PIXELS, QUAD, SMEM_BYTES, THREADS,
    TilePlan, accumulate_vpu, check_block, check_conv_operands,
    launch_conv_tiled, tile_plan)


def conv2d_ip1_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's order."""
    acc = torch.float32 if x.is_floating_point() else torch.int32
    return accumulate_vpu(x.to(acc), w, ho=x.shape[1] - w.shape[0] + 1,
                          wo=x.shape[2] - w.shape[1] + 1, acc_dtype=acc)


def conv2d_ip1(x: torch.Tensor, w: torch.Tensor, *,
               block_cout: int = 128) -> torch.Tensor:
    """Valid stride-1 conv, NHWC x HWIO -> (N, Ho, Wo, Cout) in f32 (float
    operands) or int32 (integer operands).  CUDA tensors
    (``CUDA_DTYPES``) launch the kernel once; CPU tensors run
    ``conv2d_ip1_plain``."""
    check_conv_operands(x, w)
    check_block("block_cout", block_cout)
    if not x.is_cuda:
        return conv2d_ip1_plain(x, w)
    return launch_conv_tiled("conv2d_ip1", "cnn_conv1", "vpu", x, w,
                             block_cout)


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
