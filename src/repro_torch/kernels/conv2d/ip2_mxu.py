"""Conv2 — single-matrix-unit convolution (paper: 1 DSP, low logic).

Replaces ``repro/kernels/conv2d/ip2_mxu.py::conv2d_ip2``.  The reference
builds the im2col tile and takes ONE dot over K = KH*KW*Cin; the kernel
(``conv2d_kernel<T>`` in ``csrc/cnn_kernels.cu``) keeps that order
(``inner.accumulate_mxu``), one thread per output.  It runs on CUDA
cores (FP32 FMA / int32 multiply-add): Hopper's tensor cores have no
IEEE-f32 mode and TF32 misses the reference tolerance; the tensor-core
version is later work (ROADMAP queue 2).
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import Footprint, cost_cycles, mxu_pass_cycles
from repro_torch.kernels import cuda
from repro_torch.kernels.conv2d.inner import (accumulate_mxu, check_block,
                                              check_conv_operands,
                                              conv_output)


def conv2d_ip2_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's order."""
    acc = torch.float32 if x.is_floating_point() else torch.int32
    return accumulate_mxu(x, w, ho=x.shape[1] - w.shape[0] + 1,
                          wo=x.shape[2] - w.shape[1] + 1, acc_dtype=acc)


def conv2d_ip2(x: torch.Tensor, w: torch.Tensor, *,
               block_cout: int = 128) -> torch.Tensor:
    """Valid stride-1 conv in the im2col order; see ``conv2d_ip1``."""
    check_conv_operands(x, w)
    check_block("block_cout", block_cout)
    if not x.is_cuda:
        return conv2d_ip2_plain(x, w)
    y = conv_output(x, w)
    if y.numel() == 0:
        return y
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    cuda.launch("conv2d_ip2", "cnn_conv2d", x.device,
                cuda.DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                y.data_ptr(), n, h, w_, cin, kh, kw, cout,
                min(int(block_cout), cout))
    return y


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
