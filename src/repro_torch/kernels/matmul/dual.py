"""Dual-stream matmul members — Conv3/Conv4 generalized to the LM hot
path.

Replaces ``repro/kernels/matmul/dual.py::_mm_dual`` (``mm_dual_shared``
and ``mm_dual_full``).  The reference loads ONE weight tile per grid
step and feeds it to both streams' dots, keeping two accumulators: the
weights cross device memory once for two outputs, the paper's
serial-coefficient-load economy.

``mm_dual_shared`` (Conv3 analogue): operands limited to 8 bits (a
``TypeError`` otherwise, before any launch).  ``mm_dual_full`` (Conv4
analogue): the same structure at any kernel dtype.  Outputs keep the
accumulator dtype, as the reference's do: int32 for integer operands,
f32 otherwise.

The kernel (``mm_dual_kernel<T>`` in ``csrc/mm_kernels.cu``) runs
``mm_mxu_kernel``'s staging with two A tiles against one shared B tile
per k-step, each output one sequential multiply-add chain over K in
``mm_mxu``'s order, so each stream equals an ``mm_mxu`` launch bitwise.
``bm/bn/bk`` are validated hints that do not shape the launch.  The
plain versions are the family oracle (``ref.matmul_dual_ref``).
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import Footprint, cost_cycles, mxu_pass_cycles
from repro_torch.kernels import cuda
from repro_torch.kernels.matmul.mxu import KERNEL_DTYPES, _acc_dtype, _cdiv
from repro_torch.kernels.matmul.mxu import _check as _check_single
from repro_torch.kernels.matmul.ref import matmul_dual_ref


def _check(a1, a2, b, **blocks) -> None:
    _check_single(a1, b, **blocks)
    if a2.shape != a1.shape:
        raise ValueError(f"the two streams differ in shape: "
                         f"{tuple(a1.shape)} and {tuple(a2.shape)}")


def _require_int8(a1, a2, b) -> None:
    for t in (a1, a2, b):
        if t.dtype != torch.int8:
            raise TypeError("mm_dual_shared is limited to 8-bit operands "
                            f"(paper Conv3 contract); got {t.dtype}")


def _launch(counter: str, a1, a2, b):
    """Launch ``cnn_matmul_dual`` once for CUDA operands of one dtype."""
    for name, t in (("a1", a1), ("a2", a2), ("b", b)):
        if t.dtype not in KERNEL_DTYPES or t.dtype != a1.dtype:
            raise TypeError(
                f"{name} dtype {t.dtype} has no CUDA dual matmul kernel (a1 "
                f"is {a1.dtype}; have {list(KERNEL_DTYPES)}, one dtype for "
                f"all three; ROADMAP queue 2, item 13)")
        cuda.require(t, name)
        if t.device != a1.device:
            raise ValueError(f"a1 and {name} lie on {a1.device} and "
                             f"{t.device}")
    m, k = a1.shape
    n = b.shape[1]
    acc = _acc_dtype(a1, b)
    y1 = torch.empty((m, n), dtype=acc, device=a1.device)
    y2 = torch.empty((m, n), dtype=acc, device=a1.device)
    if y1.numel() == 0:
        return y1, y2
    cuda.launch(counter, "cnn_matmul_dual", a1.device,
                cuda.DTYPE_CODE[a1.dtype], a1.data_ptr(), a2.data_ptr(),
                b.data_ptr(), y1.data_ptr(), y2.data_ptr(), m, n, k)
    return y1, y2


def mm_dual_shared_plain(a1: torch.Tensor, a2: torch.Tensor,
                         b: torch.Tensor):
    """``mm_dual_shared``'s function in plain PyTorch: int8 operands,
    the family oracle."""
    _require_int8(a1, a2, b)
    return matmul_dual_ref(a1, a2, b)


def mm_dual_full_plain(a1: torch.Tensor, a2: torch.Tensor, b: torch.Tensor):
    """``mm_dual_full``'s function in plain PyTorch (the family oracle)."""
    return matmul_dual_ref(a1, a2, b)


def mm_dual_shared(a1, a2, b, *, bm: int = 256, bn: int = 256,
                   bk: int = 512):
    """(a1 @ b, a2 @ b) on int8 operands -> two int32 (M, N).  CUDA
    tensors launch the kernel once; CPU tensors run the plain version."""
    _require_int8(a1, a2, b)
    _check(a1, a2, b, bm=bm, bn=bn, bk=bk)
    if not a1.is_cuda:
        return mm_dual_shared_plain(a1, a2, b)
    return _launch("mm_dual_shared", a1, a2, b)


def mm_dual_full(a1, a2, b, *, bm: int = 256, bn: int = 256,
                 bk: int = 512):
    """(a1 @ b, a2 @ b) -> two (M, N), int32 for int8 operands and f32
    for f32/bf16.  CUDA tensors launch the kernel once; CPU tensors run
    the plain version."""
    _check(a1, a2, b, bm=bm, bn=bn, bk=bk)
    if not a1.is_cuda:
        return mm_dual_full_plain(a1, a2, b)
    return _launch("mm_dual_full", a1, a2, b)


def footprint_dual(m, k, n, *, itemsize=1, bm=256, bn=256, bk=512,
                   int8: bool = True) -> Footprint:
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    vmem = 2 * bm * bk * itemsize + bk * bn * itemsize + 4 * bm * bn * 4
    hbm = 2 * m * k * itemsize + k * n * itemsize + 2 * m * n * 4
    # int8 MXU runs 2x: two streams cost one bf16-equivalent pass set.
    scale = 1.0 if int8 else 2.0
    cyc = scale * mxu_pass_cycles(m, k, n)
    passes = int(scale * _cdiv(m, bm) * _cdiv(n, bn) * _cdiv(k, bk))
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm,
                     mxu_passes=max(passes, 1), vpu_ops=0,
                     est_cycles=cost_cycles(cyc, hbm), outputs_per_pass=2,
                     max_operand_bits=8 if int8 else 32)


def footprint_shared(m, k, n, **kw) -> Footprint:
    """``mm_dual_shared``'s footprint: the int8 variant."""
    return footprint_dual(m, k, n, int8=True, **kw)


def footprint_full(m, k, n, itemsize=2, **kw) -> Footprint:
    """``mm_dual_full``'s footprint: full precision, bf16 by default."""
    return footprint_dual(m, k, n, int8=False, itemsize=itemsize, **kw)
