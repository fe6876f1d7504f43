"""Gradient compression for the cross-pod all-reduce
(``repro/optim/grad_compress.py``).

Two composable schemes, both with error feedback (the residual from
this step's quantization is added into the next step's gradient, so
compression error doesn't bias the trajectory — Seide et al. / EF-SGD):

  * int8 uniform quantization (4x over f32 on the wire)
  * top-k magnitude sparsification (k as a fraction)

``compress_grads`` is elementwise per leaf, in the reference's
operations (f32 scale, round half to even, the k-th largest magnitude
as the threshold); ``EFState`` holds the per-leaf residual.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map


class EFState(NamedTuple):
    residual: Any


def init_ef_state(grads) -> EFState:
    return EFState(tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads))


# ---------------------------------------------------------------------------
# int8 uniform quantization
# ---------------------------------------------------------------------------
def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


# ---------------------------------------------------------------------------
# top-k sparsification
# ---------------------------------------------------------------------------
def topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    k = max(int(x.numel() * frac), 1)
    flat = torch.abs(x.reshape(-1))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x) >= thresh).to(x.dtype)


# ---------------------------------------------------------------------------
# error-feedback wrapper
# ---------------------------------------------------------------------------
def compress_grads(grads, ef: EFState, *, scheme: str = "int8",
                   topk_frac: float = 0.1):
    """Returns (wire_grads, new_ef).  wire_grads is what crosses the pod
    link (int8 payloads or sparsified f32); callers all-reduce it and
    apply.  EF residual = (true - wire) accumulates locally."""

    def one(g, r):
        gf = g.to(torch.float32) + r
        if scheme == "int8":
            q, scale = quantize_int8(gf)
            wire = dequantize_int8(q, scale)
        elif scheme == "topk":
            wire = gf * topk_mask(gf, topk_frac)
        elif scheme == "int8_topk":
            m = topk_mask(gf, topk_frac)
            q, scale = quantize_int8(gf * m)
            wire = dequantize_int8(q, scale)
        else:
            raise ValueError(scheme)
        return wire.to(g.dtype), gf - wire

    out = tree_map(one, grads, ef.residual)
    return (tree_map(lambda t: t[0], out),
            EFState(tree_map(lambda t: t[1], out)))


def wire_bytes(grads, scheme: str = "int8", topk_frac: float = 0.1) -> int:
    """Bytes a scheme puts on the cross-pod link (for the roofline)."""
    total = 0
    for g in tree_leaves(grads):
        n = g.numel()
        if scheme == "int8":
            total += n  # 1 byte/elem + negligible scales
        elif scheme == "topk":
            total += int(n * topk_frac) * 8  # value+index
        elif scheme == "int8_topk":
            total += int(n * topk_frac) * 5
        else:
            total += n * 4
    return total
