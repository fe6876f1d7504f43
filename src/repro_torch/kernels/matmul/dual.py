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

On int8 and bf16 operands both members run on the tensor cores
(``mm_tc_dual_*_kernel`` in ``csrc/mm_tc_kernels.cu``), ``mm_mxu``'s tile
body with NS=2: per k-step the producer warpgroup stages 64 rows of each
stream and ONE b tile, and each consumer warpgroup issues ``wgmma`` for
one stream against that b tile.  At the LM sweep's FFN, 2 x (4096, 2048)
x (2048, 8192), the tensor-core peak of the operand type bounds them.
A b tile feeds 64 rows of each stream where ``mm_mxu``'s feeds 128 rows
of one (the accumulator registers cap the rows a tile can feed), so the
kernel moves the bytes of two ``mm_mxu`` launches in one launch.  Each
output sees ``mm_mxu``'s instruction, k-chunk
order and accumulator, so each stream equals an ``mm_mxu`` launch
bitwise.  On f32 they run ``mm_dual_f32_kernel`` (``csrc/mm_kernels.cu``,
CUDA cores): ``mm_mxu``'s f32 body (``mxu_f32_tiles``) with two streams,
its 3-stage cp.async ring of 32-k steps staging both streams' a tiles
and ONE b tile, a 4 x 16 register tile a stream; each output is
``mm_mxu``'s FMA chain, so each stream equals an ``mm_mxu`` launch
bitwise.  Every route takes its operands as ``pad_tc_operands`` lays
them out (``launch_operands``).  ``bm/bn/bk`` are validated hints that
do not shape the launch.
The plain versions are the family oracle (``ref.matmul_dual_ref``).
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import Footprint, cost_cycles, mxu_pass_cycles
from repro_torch.kernels import cuda
from repro_torch.kernels.matmul.mxu import (KERNEL_DTYPES, TC_DTYPES,
                                            _acc_dtype, _cdiv,
                                            pad_tc_operands)
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


def entry_point(a1_dtype: torch.dtype, a2_dtype: torch.dtype,
                b_dtype: torch.dtype) -> str:
    """The C entry point a CUDA launch takes for these operand dtypes:
    int8/bf16 -> ``mm_tc_matmul_dual`` (tensor cores), f32 ->
    ``cnn_matmul_dual`` (CUDA cores).  Raises ``TypeError`` for a dtype
    without a kernel or operands of more than one dtype."""
    for name, dtype in (("a1", a1_dtype), ("a2", a2_dtype), ("b", b_dtype)):
        if dtype not in KERNEL_DTYPES or dtype != a1_dtype:
            raise TypeError(
                f"{name} dtype {dtype} has no CUDA dual matmul kernel (a1 "
                f"is {a1_dtype}; have {list(KERNEL_DTYPES)}, one dtype for "
                f"all three; ROADMAP queue 2, item 13)")
    return ("mm_tc_matmul_dual" if a1_dtype in TC_DTYPES
            else "cnn_matmul_dual")


def launch_operands(a1, a2, b):
    """What one launch for operands of one dtype hands the kernel: the C
    entry point (``entry_point``), the operands as ``pad_tc_operands``
    lays them out (K and b's row stride padded to 16 bytes, aligned
    bases), and the dims after (M, N): the padded K and b's row stride
    on the tensor cores, the live K and both row strides on CUDA cores
    (which sum only the live depth)."""
    entry = entry_point(a1.dtype, a2.dtype, b.dtype)
    k = a1.shape[1]
    (a1, a2), b = pad_tc_operands((a1, a2), b)
    dims = ((a1.shape[1], b.shape[1]) if entry == "mm_tc_matmul_dual"
            else (k, a1.shape[1], b.shape[1]))
    return entry, (a1, a2, b), dims


def _launch(counter: str, a1, a2, b):
    """Launch ``entry_point``'s kernel once for CUDA operands of one
    dtype."""
    entry_point(a1.dtype, a2.dtype, b.dtype)
    for name, t in (("a1", a1), ("a2", a2), ("b", b)):
        cuda.require(t, name)
        if t.device != a1.device:
            raise ValueError(f"a1 and {name} lie on {a1.device} and "
                             f"{t.device}")
    m = a1.shape[0]
    n = b.shape[1]
    acc = _acc_dtype(a1, b)
    y1 = torch.empty((m, n), dtype=acc, device=a1.device)
    y2 = torch.empty((m, n), dtype=acc, device=a1.device)
    if y1.numel() == 0:
        return y1, y2
    entry, (a1, a2, b), dims = launch_operands(a1, a2, b)
    cuda.launch(counter, entry, a1.device, cuda.DTYPE_CODE[a1.dtype],
                a1.data_ptr(), a2.data_ptr(), b.data_ptr(), y1.data_ptr(),
                y2.data_ptr(), m, n, *dims)
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
