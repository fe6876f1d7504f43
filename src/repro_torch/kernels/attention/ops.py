"""Public wrapper for the attention IP family (selector-aware).

Attention carries no ``ladder=``: the family is registered
``quantizable=False`` (no integer kernels), so the planner always holds
its sites at native width.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.resources import ResourceBudget
from repro_torch.kernels.attention.decode import flash_decode
from repro_torch.kernels.attention.flash import flash_attention
from repro_torch.kernels.attention.ref import attention_ref

_MEMBERS = ("attn_decode", "attn_flash", "attn_naive")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, ip: Optional[str] = None,
              budget: Optional[ResourceBudget] = None) -> torch.Tensor:
    """Attention through a selected IP: ``attn_flash`` (the flash
    kernel), ``attn_decode`` (single token; ``causal`` does not apply)
    or ``attn_naive`` (the plain oracle, on any device)."""
    if ip is None:
        from repro_torch.core.ip import SiteSpec
        from repro_torch.core.plan import plan_single
        spec = SiteSpec.make("attention", "attention", (q.shape, k.shape),
                             q.dtype)
        ip = plan_single(spec, budget).ip.name
    ip = ip.split(".")[-1]
    if ip == "attn_flash":
        return flash_attention(q, k, v, causal=causal)
    if ip == "attn_decode":
        return flash_decode(q, k, v)
    if ip == "attn_naive":
        return attention_ref(q, k, v, causal=causal)
    raise KeyError(f"{ip!r} is not an attention IP (have {list(_MEMBERS)})")
