"""Oracle for the attention IP family (``repro/kernels/attention/ref.py``).

Contract (GQA-general):
  q : (B, Hq, Sq, D)
  k : (B, Hkv, Skv, D)     Hq % Hkv == 0; group = Hq // Hkv
  v : (B, Hkv, Skv, D)
  out: (B, Hq, Sq, D), cast to ``q.dtype``
``causal=True`` masks j > i + (Skv - Sq)  (decode-aligned causal).

Scores are f32 and masked with ``-inf``, so a row that sees no key (a
causal call with Sq > Skv) is NaN, as in the reference.  This is also
the ``attn_naive`` member itself: it stays plain PyTorch on the card.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    qf = qf.reshape(b, hkv, group, sq, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)
    if causal:
        offs = skv - sq
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(skv, device=q.device)[None, :]
        scores = scores.masked_fill(~(kj <= qi + offs), float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode: q (B, Hq, 1, D) against a full KV cache."""
    return attention_ref(q, k, v, causal=False, scale=scale)
