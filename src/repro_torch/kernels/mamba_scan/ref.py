"""Oracle for the selective-scan kernel (``repro/kernels/mamba_scan/ref.py``).

Contract (the SSM core of a Mamba block, per batch element):
  x  : (B, T, Di)   post-conv activations
  dt : (B, T, Di)   softplus'd step sizes
  Bp : (B, T, Ds)   input projection
  Cp : (B, T, Ds)   output projection
  A  : (Di, Ds)     negative state matrix
  y  : (B, T, Di)   y_t = (h_t · Cp_t),  h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) Bp_t

Everything is f32; h starts at 0 and the final h (B, Di, Ds) is
returned beside y.  A Python loop over T, one step at a time, as the
reference's ``lax.scan``.
"""
from __future__ import annotations

import torch


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, bp: torch.Tensor,
                       cp: torch.Tensor, a: torch.Tensor):
    b, t, di = x.shape
    f32 = torch.float32
    x, dt, bp, cp, a = (v.to(f32) for v in (x, dt, bp, cp, a))
    h = torch.zeros((b, di, a.shape[1]), dtype=f32, device=x.device)
    ys = []
    for i in range(t):
        dt_t = dt[:, i]
        d_a = torch.exp(dt_t[..., None] * a[None])
        d_bx = (dt_t * x[:, i])[..., None] * bp[:, i, None, :]
        h = d_a * h + d_bx
        ys.append((h * cp[:, i, None, :]).sum(dim=-1))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((b, 0, di))
    return y, h
