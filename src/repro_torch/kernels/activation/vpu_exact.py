"""Act1 — exact elementwise activation (full-precision IP).

Replaces ``repro/kernels/activation/vpu_exact.py::activation_exact``.
The kernel (``activation_kernel`` in ``csrc/cnn_kernels.cu``) runs the
walk it shares with the LUT activation (``act_walk``): 16-byte vectors,
several in flight a thread, over a grid of whole waves of the card's
SMs that walks the tensor, stored as 16-byte vectors where the output
meets a 16-byte boundary at the same element as the input (always, for
an aligned input); the elements before the input's first 16-byte
boundary and after its last whole vector run one a thread in the same
launch.  ``walk_plan`` mirrors the launcher's split (``act_split``).
Each element goes through the shared ``__device__`` ``activate`` in f32
(``expf``/``tanhf``, no fast-math intrinsics) — the same function the
fused members apply — and a bf16 result is rounded once, to nearest
even.  The ``block_rows`` hint is validated as in the reference and
priced by the footprint; it does not shape the grid.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.resources import Footprint, cost_cycles, vpu_op_cycles
from repro_torch.kernels import cuda
from repro_torch.kernels.activation.ref import (_FNS, KINDS,
                                                activation_out_dtype)
from repro_torch.kernels.conv2d.inner import check_block

# Approximate scalar-op cost per element (mul/add/cmp units).
OP_COST = {"relu": 1, "relu6": 2, "sigmoid": 10, "tanh": 12, "gelu": 15}

# input dtypes the CUDA kernel takes
CUDA_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.int32)
# act_walk's CTA (kThreads), the vectors a thread loads at once
# (kActVecs) and the CTAs an SM the grid holds at most (kActCtasPerSm)
THREADS = 256
VECS = 2
CTAS_PER_SM = 16


class WalkPlan(NamedTuple):
    """``act_split``'s split of an activation launch: ``head`` elements
    one a thread before the input's first 16-byte boundary, then the
    whole 16-byte vectors in ``tiles`` tiles of ``THREADS * VECS``,
    walked by ``grid`` CTAs a grid apart (stored as vectors where
    ``vstore``), then the tail one a thread."""
    head: int
    vstore: bool
    tiles: int
    grid: int


def walk_plan(numel: int, *, itemsize: int, out_itemsize: int,
              x_addr: int, y_addr: int, sms: int) -> WalkPlan:
    """The split ``cnn_activation`` and ``cnn_activation_lut`` launch for
    ``numel`` elements of ``itemsize`` bytes at ``x_addr`` into
    ``out_itemsize``-byte outputs at ``y_addr`` on a card of ``sms``
    SMs (the query ``cnn_activation_plan`` returns the C rule's)."""
    if x_addr % itemsize or y_addr % out_itemsize:
        raise ValueError("the activations take inputs and outputs aligned "
                         "to their element")
    head = min(numel, (16 - x_addr % 16) % 16 // itemsize)
    tiles = -(-((numel - head) // (16 // itemsize)) // (THREADS * VECS))
    return WalkPlan(head, (y_addr + head * out_itemsize) % 16 == 0, tiles,
                    max(1, min(tiles, sms * CTAS_PER_SM)))


def activation_exact_plain(x: torch.Tensor, *,
                           kind: str = "relu") -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    y = _FNS[kind](x.to(torch.float32))
    return y.to(activation_out_dtype(x.dtype))


def activation_exact(x: torch.Tensor, *, kind: str = "relu",
                     block_rows: int = 256) -> torch.Tensor:
    """relu/relu6/sigmoid/tanh/gelu in f32; float input keeps its dtype,
    integer input gives f32.  CUDA tensors (``CUDA_DTYPES``) launch the
    kernel once; CPU tensors run the plain version."""
    if kind not in KINDS:
        raise ValueError(f"unknown activation {kind!r}; have {KINDS}")
    check_block("block_rows", block_rows)
    if not x.is_cuda:
        return activation_exact_plain(x, kind=kind)
    cuda.require(x, "x", CUDA_DTYPES)
    y = torch.empty(x.shape, dtype=activation_out_dtype(x.dtype),
                    device=x.device)
    if y.numel() == 0:
        return y
    cuda.launch("activation_exact", "cnn_activation", x.device,
                cuda.DTYPE_CODE[x.dtype], KINDS.index(kind), x.data_ptr(),
                y.data_ptr(), x.numel(), cuda.sm_count(x.device))
    return y


def footprint(n_elems, *, itemsize=4, kind="relu",
              block_rows: int = 256, lanes: int = 128) -> Footprint:
    block = min(block_rows * lanes, n_elems)
    vmem = block * itemsize + block * 4            # in tile + f32 out tile
    hbm = n_elems * (itemsize + itemsize)          # stream in + out
    vpu = n_elems * OP_COST.get(kind, 8)
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=0,
                     vpu_ops=vpu,
                     est_cycles=cost_cycles(vpu_op_cycles(vpu), hbm),
                     outputs_per_pass=1, max_operand_bits=32)
