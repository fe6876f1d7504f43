"""Tiled matmul kernels — the matmul end of the IP library.

Replaces ``repro/kernels/matmul/mxu.py::{mm_mxu, mm_vpu}``.

``mm_mxu`` is the Conv2 analogue for the LM hot path: the reference
takes one MXU pass per (bm, bn, bk) tile into an f32/int32 VMEM
accumulator, K innermost.  The kernel (``mm_mxu_kernel`` in
``csrc/mm_kernels.cu``) stages 128x128 tiles of a and b in shared memory
and keeps an 8x8 register tile of accumulators per thread: FP32 FMA for
f32/bf16 (f32 accumulator), int32 multiply-add for int8 (int32
accumulator).

``mm_vpu`` is the Conv1 analogue: no dot, no tile — one thread per
output multiplies and sums along K on CUDA cores and issues no MMA
instruction (the logic-only contract of ``mxu_available=False``).

Where the reference pads its operands to block multiples and crops, the
kernels check bounds; each output is one sequential multiply-add chain
over K in both, so results never depend on ``bm/bn/bk`` (validated, not
shaping the launch) and the two members agree bitwise.  The plain
versions are the family oracle (``ref.matmul_ref``).
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import (Footprint, cost_cycles,
                                        mxu_pass_cycles, vpu_op_cycles)
from repro_torch.kernels import cuda
from repro_torch.kernels.conv2d.inner import check_block
from repro_torch.kernels.matmul.ref import matmul_ref

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
STYLE_CODE = {"vpu": 0, "mxu": 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _acc_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    if not a.is_floating_point() and not b.is_floating_point():
        return torch.int32
    return torch.float32


def _check(a: torch.Tensor, b: torch.Tensor, **blocks) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul takes (M, K) x (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    for name, value in blocks.items():
        check_block(name, value)


def _launch(counter: str, style: str, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """Launch ``cnn_matmul`` (``csrc/mm_kernels.cu``) once for CUDA
    operands of one dtype: int8 gives int32, f32/bf16 give f32."""
    cuda.require(a, "a", KERNEL_DTYPES)
    cuda.require(b, "b", (a.dtype,))
    if b.device != a.device:
        raise ValueError(f"a and b lie on {a.device} and {b.device}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=_acc_dtype(a, b), device=a.device)
    if out.numel() == 0:
        return out
    cuda.launch(counter, "cnn_matmul", a.device, STYLE_CODE[style],
                cuda.DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(),
                out.data_ptr(), m, n, k)
    return out


def mm_mxu_plain(a: torch.Tensor, b: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the family oracle)."""
    out = matmul_ref(a, b)
    return out if out_dtype is None else out.to(out_dtype)


def mm_mxu(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256,
           bn: int = 256, bk: int = 512, out_dtype=None) -> torch.Tensor:
    """a (M, K) @ b (K, N) with an int32 (int8 operands) or f32
    accumulator, cast to ``out_dtype`` when given.  CUDA tensors launch
    the kernel; CPU tensors run ``mm_mxu_plain``."""
    _check(a, b, bm=bm, bn=bn, bk=bk)
    if not a.is_cuda:
        return mm_mxu_plain(a, b, out_dtype)
    out = _launch("mm_mxu", "mxu", a, b)
    return out if out_dtype is None else out.to(out_dtype)


def mm_vpu_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the family oracle)."""
    return matmul_ref(a, b)


def mm_vpu(a: torch.Tensor, b: torch.Tensor, *, bm: int = 64,
           bn: int = 128) -> torch.Tensor:
    """Dot-free a @ b: int32 for int8 operands, f32 otherwise.  CUDA
    tensors launch the kernel; CPU tensors run ``mm_vpu_plain``."""
    _check(a, b, bm=bm, bn=bn)
    if not a.is_cuda:
        return mm_vpu_plain(a, b)
    return _launch("mm_vpu", "vpu", a, b)


def footprint_mxu(m, k, n, *, itemsize=2, bm=256, bn=256,
                  bk=512) -> Footprint:
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    vmem = bm * bk * itemsize + bk * bn * itemsize + 2 * bm * bn * 4
    hbm = (m * k + k * n) * itemsize + m * n * 4
    cyc = mxu_pass_cycles(m, k, n) * (1 if itemsize > 1 else 0.5)
    passes = _cdiv(m, bm) * _cdiv(n, bn) * _cdiv(k, bk)
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=passes,
                     vpu_ops=0, est_cycles=cost_cycles(cyc, hbm),
                     outputs_per_pass=1, max_operand_bits=32)


def footprint_vpu(m, k, n, *, itemsize=2, bm=64, bn=128) -> Footprint:
    bm, bn = min(bm, m), min(bn, n)
    vmem = bm * k * itemsize + k * bn * itemsize + bm * bn * 4
    hbm = (m * k + k * n) * itemsize + m * n * 4
    vpu = 2 * m * k * n
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=0,
                     vpu_ops=vpu,
                     est_cycles=cost_cycles(vpu_op_cycles(vpu), hbm),
                     outputs_per_pass=1, max_operand_bits=32)
