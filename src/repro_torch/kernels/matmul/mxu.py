"""Tiled matmul kernels — the matmul end of the IP library.

Replaces ``repro/kernels/matmul/mxu.py::{mm_mxu, mm_vpu}``.

``mm_mxu`` is the Conv2 analogue for the LM hot path: the reference
takes one MXU pass per (bm, bn, bk) tile into an f32/int32 VMEM
accumulator, K innermost.  On int8 and bf16 operands it runs on Hopper's
tensor cores (``mm_tc_mxu_*_kernel`` in ``csrc/mm_tc_kernels.cu``):
``wgmma`` into an int32 (exact, wrapping) or f32 accumulator, fed by a
ring of shared-memory stages that a producer warpgroup fills while two
consumer warpgroups compute.  At the FFN, (512, 2048) x (2048, 8192),
device memory bounds int8 (b and the int32 output) and the bf16
tensor-core peak bounds bf16; a CTA owns 128 x 256 outputs, so the FFN
is 128 CTAs on 132 SMs and reads b from device memory about once.  The
8-bit ``wgmma`` takes b only K-major, so the producer stages int8 b's
tiles in shared memory as they lie and transposes them there into the
layout ``wgmma`` reads; bf16 b goes in as it lies and ``wgmma``
transposes it.  On f32 operands it
stays on CUDA cores (``mm_mxu_f32_kernel`` in ``csrc/mm_kernels.cu``):
a 128 x 256 CTA tile fed by a 3-stage cp.async ring of (128, 32) a and
(32, 256) b tiles, and an 8 x 16 register tile a thread read with
16-byte shared loads, so FP32 FMAs take most issue slots; f32
``mm_dual_full`` runs the same body with two a streams.  Hopper has no
IEEE-f32 MMA, and TF32 misses the reference tolerance.

``mm_vpu`` is the Conv1 analogue: no dot — it multiplies and sums
along K on CUDA cores and issues no MMA instruction (the logic-only
contract of ``mxu_available=False``).  Its kernel (``mm_vpu_kernel`` in
``csrc/mm_kernels.cu``) stages (128, 64 bytes of K) and (64 bytes of K,
128) tiles of a and b through a cp.async ring in shared memory, as the
reference holds its blocks in VMEM, and keeps an 8x8 register tile a
thread.

Where the reference pads its operands to block multiples and crops, the
kernels zero-pad K and b's row stride to 16 bytes (``pad_tc_operands``,
a layout step; the tensor-core zeros add exact +0 terms, and the
CUDA-core kernels sum only the live depth) and mask the ragged edge.  Results never
depend on ``bm/bn/bk`` (validated, not shaping the launch); int8 results
are exact, so ``mm_mxu`` and ``mm_vpu`` agree bitwise on int8, and on f32
(one sequential multiply-add chain over K in both).  The plain versions
are the family oracle (``ref.matmul_ref``).
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import (Footprint, cost_cycles,
                                        mxu_pass_cycles, vpu_op_cycles)
from repro_torch.kernels import cuda
from repro_torch.kernels.conv2d.inner import check_block
from repro_torch.kernels.matmul.ref import matmul_ref

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
# operand dtypes of the tensor-core route (csrc/mm_tc_kernels.cu): 16 bytes
# of K per wgmma k-chunk pair, so K and b's row stride pad to 16 bytes
TC_DTYPES = (torch.bfloat16, torch.int8)
TC_ALIGN_BYTES = 16
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


def entry_point(style: str, a_dtype: torch.dtype,
                b_dtype: torch.dtype) -> str:
    """The C entry point a CUDA launch of ``style`` takes for these
    operand dtypes: ``mm_mxu`` on int8/bf16 -> ``mm_tc_matmul`` (tensor
    cores), every other case -> ``cnn_matmul`` (CUDA cores).  Raises
    ``TypeError`` for a dtype without a kernel or two operand dtypes."""
    cuda.require_dtype("a", a_dtype, KERNEL_DTYPES)
    cuda.require_dtype("b", b_dtype, (a_dtype,))
    if style == "mxu" and a_dtype in TC_DTYPES:
        return "mm_tc_matmul"
    return "cnn_matmul"


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if tuple(t.shape) == (rows, cols) and t.data_ptr() % TC_ALIGN_BYTES == 0:
        return t
    out = t.new_zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def pad_tc_operands(streams, b: torch.Tensor):
    """The operands as the tensor-core kernels and the cp.async-staged
    CUDA-core ones (``mm_mxu`` f32, ``mm_vpu``) take them: K (the streams' columns, b's rows) and b's columns rounded up
    to 16 bytes, each base 16-byte aligned; zero-padded copies where
    needed, the operands themselves where not.  The zeros add exact +0 terms, and the kernel
    writes only the true (M, N): a plain product of the padded operands
    cropped to (M, N) equals the unpadded one.  Returns (streams, b)."""
    align = TC_ALIGN_BYTES // b.element_size()
    k, n = b.shape
    kp, np_ = _cdiv(k, align) * align, _cdiv(n, align) * align
    return (tuple(_pad_to(a, a.shape[0], kp) for a in streams),
            _pad_to(b, kp, np_))


def _launch(counter: str, style: str, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """Launch ``entry_point``'s kernel once for CUDA operands of one
    dtype: int8 gives int32, f32/bf16 give f32."""
    entry = entry_point(style, a.dtype, b.dtype)
    cuda.require(a, "a")
    cuda.require(b, "b")
    if b.device != a.device:
        raise ValueError(f"a and b lie on {a.device} and {b.device}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=_acc_dtype(a, b), device=a.device)
    if out.numel() == 0:
        return out
    code = cuda.DTYPE_CODE[a.dtype]
    (a,), b = pad_tc_operands((a,), b)   # every route stages 16-byte rows
    if entry == "cnn_matmul":
        cuda.launch(counter, entry, a.device, STYLE_CODE[style], code,
                    a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                    a.shape[1], b.shape[1])
    else:
        cuda.launch(counter, entry, a.device, code, a.data_ptr(),
                    b.data_ptr(), out.data_ptr(), m, n, a.shape[1],
                    b.shape[1])
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
