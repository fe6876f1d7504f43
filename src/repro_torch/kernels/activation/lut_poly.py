"""Act2 — low-precision LUT activation (the paper's fixed-point IP).

Replaces ``repro/kernels/activation/lut_poly.py::activation_lut``.  The
input is rounded onto a 256-level grid over the activation's saturation
range ``[-r, r]`` and the nonlinearity becomes one table lookup; only
saturating kinds are supported.  The kernel
(``activation_lut_kernel`` in ``csrc/cnn_kernels.cu``) is bound by
device memory: it runs ``activation_exact``'s walk (``act_walk``,
split as ``vpu_exact.walk_plan`` mirrors: 16-byte vectors, a grid of
whole waves of the card's SMs, head and tail in the same launch), and
each CTA copies the 1 KB table into shared memory once, while its first
tile's loads are in flight, then gathers every element's entry there.
It computes the index with the same f32 operations as the plain
version, ``(x + r) * s`` rounded half to even, so the two agree bitwise
on the card.

NaN lands on entry 0 and +-inf on the end entries, as in the reference:
the index is clamped below at 0 before the NaN check can see it.  The
table is built once per (kind, device) on the CPU from the ``ref.py``
oracle and copied to the device, so every device reads the same table.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.resources import Footprint, cost_cycles, vpu_op_cycles
from repro_torch.kernels import cuda
from repro_torch.kernels.activation.ref import (activation_out_dtype,
                                                activation_ref)
from repro_torch.kernels.conv2d.inner import check_block

TABLE_SIZE = 256

# Saturation range per supported kind: |x| > range -> the activation is
# (numerically) constant, so index clipping is exact there.
RANGES = {"relu6": 8.0, "sigmoid": 8.0, "tanh": 4.0}
SUPPORTED_KINDS = tuple(sorted(RANGES))
# input dtypes the CUDA kernel takes
CUDA_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.int32)

_TABLES: Dict[Tuple[str, str], torch.Tensor] = {}


def build_table(kind: str) -> torch.Tensor:
    """256-entry float32 table sampled from the ``ref.py`` oracle, on the
    CPU.  ``torch.linspace`` differs from ``jnp.linspace`` by up to an
    ulp at some grid points, so the table matches the reference's within
    1e-6, not bitwise."""
    r = RANGES[kind]
    xs = torch.linspace(-r, r, TABLE_SIZE, dtype=torch.float32)
    return activation_ref(xs, kind=kind)


def table_for(kind: str, device) -> torch.Tensor:
    """The cached table of ``kind`` on ``device``."""
    key = (kind, str(torch.device(device)))
    table = _TABLES.get(key)
    if table is None:
        table = build_table(kind).to(device)
        _TABLES[key] = table
    return table


def lut_scale(kind: str) -> float:
    """Grid steps per unit input, ``255 / (2 r)`` (exact in f32 for every
    supported range)."""
    return (TABLE_SIZE - 1) / (2.0 * RANGES[kind])


def activation_lut_plain(x: torch.Tensor, *,
                         kind: str = "tanh") -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    q = torch.round((x.to(torch.float32) + RANGES[kind]) * lut_scale(kind))
    q = torch.nan_to_num(torch.clamp(q, 0, TABLE_SIZE - 1), nan=0.0)
    table = table_for(kind, x.device)
    return table[q.to(torch.int64)].to(activation_out_dtype(x.dtype))


def activation_lut(x: torch.Tensor, *, kind: str = "tanh",
                   block_rows: int = 256) -> torch.Tensor:
    """Table activation; float input keeps its dtype, integer input gives
    f32.  CUDA tensors (``CUDA_DTYPES``; a bf16 entry is the f32 table's
    rounded to nearest even) launch the kernel; CPU tensors run the
    plain version.  ``block_rows`` is validated and priced by the
    footprint; it does not shape the grid."""
    if kind not in RANGES:
        raise ValueError(
            f"LUT activation supports saturating kinds {SUPPORTED_KINDS}; "
            f"{kind!r} is unbounded — use the exact IP")
    check_block("block_rows", block_rows)
    if not x.is_cuda:
        return activation_lut_plain(x, kind=kind)
    cuda.require(x, "x", CUDA_DTYPES)
    table = table_for(kind, x.device)
    y = torch.empty(x.shape, dtype=activation_out_dtype(x.dtype),
                    device=x.device)
    if y.numel() == 0:
        return y
    cuda.launch("activation_lut", "cnn_activation_lut", x.device,
                cuda.DTYPE_CODE[x.dtype], x.data_ptr(), table.data_ptr(),
                y.data_ptr(), x.numel(), RANGES[kind], lut_scale(kind),
                cuda.sm_count(x.device))
    return y


def footprint(n_elems, *, itemsize=4, kind="tanh",
              block_rows: int = 256, lanes: int = 128) -> Footprint:
    block = min(block_rows * lanes, n_elems)
    vmem = block * itemsize + block * 4 + TABLE_SIZE * 4
    # Deployment story: operands stream as 1-byte fixed-point codes
    # (quantize at the producer, dequantize at the consumer) plus the table.
    hbm = n_elems * 2 + TABLE_SIZE * 4
    vpu = n_elems * 4            # scale, clip, round, gather
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=0,
                     vpu_ops=vpu,
                     est_cycles=cost_cycles(vpu_op_cycles(vpu), hbm),
                     outputs_per_pass=1, max_operand_bits=8)
