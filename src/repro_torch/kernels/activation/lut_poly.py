"""Act2 — low-precision LUT activation (the paper's fixed-point IP).

The input is rounded onto a 256-level grid over the activation's
saturation range and the nonlinearity becomes one table lookup; only
saturating kinds are supported.  The planner prices this member on every
activation site of a saturating kind, so its footprint is ported now; at
the default budget (16-bit precision floor) it never wins.  Its kernel
(``repro/kernels/activation/lut_poly.py::activation_lut``) is ROADMAP
queue 2, item 8: on a CUDA tensor ``activation_lut`` raises
``NotImplementedError``, on the CPU it runs the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import Footprint, cost_cycles, vpu_op_cycles
from repro_torch.kernels.activation.ref import (activation_out_dtype,
                                                activation_ref)

TABLE_SIZE = 256

# Saturation range per supported kind: |x| > range -> the activation is
# (numerically) constant, so index clipping is exact there.
RANGES = {"relu6": 8.0, "sigmoid": 8.0, "tanh": 4.0}
SUPPORTED_KINDS = tuple(sorted(RANGES))


def build_table(kind: str, device=None) -> torch.Tensor:
    """256-entry float32 table sampled from the ``ref.py`` oracle."""
    r = RANGES[kind]
    xs = torch.linspace(-r, r, TABLE_SIZE, dtype=torch.float32,
                        device=device)
    return activation_ref(xs, kind=kind)


def activation_lut_plain(x: torch.Tensor, *, kind: str = "tanh"):
    r = RANGES[kind]
    scale = (TABLE_SIZE - 1) / (2.0 * r)
    q = torch.clamp(torch.round((x.to(torch.float32) + r) * scale), 0,
                    TABLE_SIZE - 1)            # round half to even
    table = build_table(kind, device=x.device)
    return table[q.to(torch.int64)].to(activation_out_dtype(x.dtype))


def activation_lut(x: torch.Tensor, *, kind: str = "tanh",
                   block_rows: int = 256) -> torch.Tensor:
    if kind not in RANGES:
        raise ValueError(
            f"LUT activation supports saturating kinds {SUPPORTED_KINDS}; "
            f"{kind!r} is unbounded — use the exact IP")
    if x.is_cuda:
        raise NotImplementedError(
            "activation.act_lut has no CUDA kernel yet (ROADMAP queue 2, "
            "item 8)")
    return activation_lut_plain(x, kind=kind)


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
