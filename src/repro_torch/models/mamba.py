"""Mamba-1 selective SSM block (jamba's mamba sublayers;
``repro/models/mamba.py``).

The sequence forward runs its recurrence through the ssm_scan family's
member, ``kernels/mamba_scan/scan.py::selective_scan``: on the card one
launch of the hand-written kernel per layer, where the reference runs a
``lax.scan`` whose step is, token for token, the family oracle's.  The
D skip term and the ``silu(z)`` gate are applied outside, as in the
reference.  When a gradient is taken the scan runs through
``SelectiveScan``: the same forward kernel, and the backward kernel
where the reference's ``jax.grad`` differentiates its ``lax.scan``.
The decode step (one token, one elementwise update of the cached state)
stays plain PyTorch, as it is plain jnp in the reference.

Decode carries (conv_state, ssm_state) — O(1) in sequence length.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.mamba_scan.scan import selective_scan
from repro_torch.models.blocks import normal


def init_mamba(cfg: ModelConfig, gen: torch.Generator, shape_prefix=(),
               device="cpu"):
    mc = cfg.mamba
    D, di, ds, dtr = cfg.d_model, cfg.d_inner, mc.d_state, cfg.dt_rank
    pd = cfg.dtype("param")
    pre = tuple(shape_prefix)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32))
    return {
        "in_proj": normal(gen, pre + (D, 2 * di), D ** -0.5, pd, device),
        "conv_w": normal(gen, pre + (mc.d_conv, di), mc.d_conv ** -0.5, pd,
                         device),
        "conv_b": torch.zeros(pre + (di,), dtype=pd, device=device),
        "x_proj": normal(gen, pre + (di, dtr + 2 * ds), di ** -0.5, pd,
                         device),
        "dt_proj": normal(gen, pre + (dtr, di), dtr ** -0.5, pd, device),
        # softplus(-4.6) ~ 0.01
        "dt_bias": torch.full(pre + (di,), -4.6, dtype=pd, device=device),
        # its own storage: AdamW writes the update in place
        "A_log": a_log.expand(pre + (di, ds)).to(
            dtype=pd, device=device).contiguous(),
        "D": torch.ones(pre + (di,), dtype=pd, device=device),
        "out_proj": normal(gen, pre + (di, D), di ** -0.5, pd, device),
    }


def _xdb(cfg: ModelConfig, p, x1):
    """x1 (..., di) through ``x_proj``: (dt_rank + 2 d_state) columns (a
    model rank's part of them from its di rows)."""
    cd = cfg.dtype("compute")
    return torch.einsum("...i,ij->...j", x1.to(cd), p["x_proj"].to(cd))


def _ssm_inputs(cfg: ModelConfig, p, x1, xdb=None):
    """x1: (..., di) post-conv activations -> (dt, B, C) selective params
    (``xdb``: ``_xdb``'s sum over the model ranks, where split)."""
    mc = cfg.mamba
    ds, dtr = mc.d_state, cfg.dt_rank
    cd = cfg.dtype("compute")
    f32 = torch.float32
    xdb = _xdb(cfg, p, x1) if xdb is None else xdb
    dt, Bp, Cp = torch.split(xdb, [dtr, ds, ds], dim=-1)
    dt = F.softplus(
        torch.einsum("...r,ri->...i", dt, p["dt_proj"].to(cd)).to(f32)
        + p["dt_bias"].to(f32))
    return dt, Bp.to(f32), Cp.to(f32)


def _in_conv(cfg: ModelConfig, p, x):
    """In-projection and causal depthwise conv over time:
    (x1_raw, z, x1) with x1 = silu(conv(x1_raw))."""
    mc = cfg.mamba
    cd = cfg.dtype("compute")
    S = x.shape[1]
    xz = torch.einsum("bsd,de->bse", x.to(cd), p["in_proj"].to(cd))
    x1_raw, z = torch.chunk(xz, 2, dim=-1)
    xpad = F.pad(x1_raw, (0, 0, mc.d_conv - 1, 0))
    x1 = sum(xpad[:, i:i + S, :] * p["conv_w"][i].to(cd)
             for i in range(mc.d_conv)) + p["conv_b"].to(cd)
    return x1_raw, z, F.silu(x1)


def _operands(cfg: ModelConfig, p, x1, xdb=None):
    dt, Bp, Cp = _ssm_inputs(cfg, p, x1, xdb)
    A = -torch.exp(p["A_log"].to(torch.float32))            # (di, ds)
    return x1.to(torch.float32), dt, Bp, Cp, A


def scan_operands(cfg: ModelConfig, p, x):
    """The selective scan's operands ``(x1f, dt, Bp, Cp, A)`` of a layer
    with params ``p`` on input ``x`` (B, S, D): what ``_mamba_core``
    hands ``selective_scan``."""
    return _operands(cfg, p, _in_conv(cfg, p, x)[2])


def _mamba_out(cfg: ModelConfig, p, x1, z, xdb=None):
    """The scan and the gated out-projection: (out, h_final)."""
    cd = cfg.dtype("compute")
    x1f, dt, Bp, Cp, A = _operands(cfg, p, x1, xdb)
    ys, h_final = selective_scan(x1f, dt, Bp, Cp, A)
    y = ys + x1f * p["D"].to(torch.float32)
    y = y.to(cd) * F.silu(z)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"].to(cd))
    return out, h_final


def _mamba_core(cfg: ModelConfig, p, x):
    """(out, x1_raw, h_final).  ``p`` a ``tensor_parallel.Split``: each
    model rank its ``d_inner`` channels — ``x_proj``'s product summed
    over the ranks, the scan on the rank's (B, S, di/tp, ds) operands,
    ``out_proj`` row-parallel and the outputs summed; x1_raw and
    h_final ``Split``s of the ranks' channels."""
    if isinstance(p, tp.Split):
        return _split_mamba_core(cfg, p, x)
    x1_raw, z, x1 = _in_conv(cfg, p, x)
    out, h_final = _mamba_out(cfg, p, x1, z)
    return out, x1_raw, h_final


def _split_mamba_core(cfg: ModelConfig, p, x):
    g = p.group

    def first(m, q, xm):
        x1_raw, z, x1 = _in_conv(cfg, q, xm)
        return _xdb(cfg, q, x1), x1, z, x1_raw

    ins = tp.run(g, p.parts, first, x)
    xdb = tp.reduce(g, [o[0] for o in ins])
    outs = tp.run(g, p.parts, lambda m, q, xdb_m, x1, z: _mamba_out(
        cfg, q, x1, z, xdb_m), xdb, [o[1] for o in ins], [o[2] for o in ins])
    return (tp.reduce(g, [o[0] for o in outs]),
            tp.Split(g, [o[3] for o in ins]),
            tp.Split(g, [o[1] for o in outs]))


def mamba_forward(cfg: ModelConfig, p, x) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    return _mamba_core(cfg, p, x)[0]


def mamba_forward_with_cache(cfg: ModelConfig, p, x):
    """Forward + decode cache (conv tail of raw in-proj acts, final h)."""
    mc = cfg.mamba
    out, x1_raw, h_final = _mamba_core(cfg, p, x)
    tail = tp.smap(lambda t: t[:, x.shape[1] - (mc.d_conv - 1):, :], x1_raw)
    return out, {"conv": tail, "ssm": h_final}


# ---------------------------------------------------------------------------
# Decode (single token)
# ---------------------------------------------------------------------------
def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=None, device="cpu"):
    mc = cfg.mamba
    dt = dtype or cfg.dtype("compute")
    return {"conv": torch.zeros((batch, mc.d_conv - 1, cfg.d_inner),
                                dtype=dt, device=device),
            "ssm": torch.zeros((batch, cfg.d_inner, mc.d_state),
                               dtype=torch.float32, device=device)}


def _step_in(cfg: ModelConfig, p, x, conv):
    """(x1, z, new conv window) of one token."""
    mc = cfg.mamba
    cd = cfg.dtype("compute")
    xz = torch.einsum("bsd,de->bse", x.to(cd), p["in_proj"].to(cd))
    x1, z = torch.chunk(xz[:, 0], 2, dim=-1)                 # (B, di)
    window = torch.cat([conv, x1[:, None, :]], dim=1)
    x1 = sum(window[:, i, :] * p["conv_w"][i].to(cd)
             for i in range(mc.d_conv)) + p["conv_b"].to(cd)
    return F.silu(x1), z, window[:, 1:, :]


def mamba_step(cfg: ModelConfig, p, x, cache) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, D); cache {'conv': (B, d_conv-1, di), 'ssm': (B, di, ds)}.
    ``p`` a ``tensor_parallel.Split``: the cache's leaves ``Split``s of
    the ranks' channels, each rank steps its own."""
    if isinstance(p, tp.Split):
        g = p.group

        def first(m, q, xm, conv):
            x1, z, new_conv = _step_in(cfg, q, xm, conv)
            return _xdb(cfg, q, x1), x1, z, new_conv

        ins = tp.run(g, p.parts, first, x, cache["conv"].parts)
        xdb = tp.reduce(g, [o[0] for o in ins])
        outs = tp.run(g, p.parts, lambda m, q, xdb_m, x1, z, h: _step_out(
            cfg, q, x1, z, h, xdb_m), xdb, [o[1] for o in ins],
            [o[2] for o in ins], cache["ssm"].parts)
        return tp.reduce(g, [o[0] for o in outs]), {
            "conv": tp.Split(g, [o[3] for o in ins]),
            "ssm": tp.Split(g, [o[1] for o in outs])}
    x1, z, new_conv = _step_in(cfg, p, x, cache["conv"])
    out, h = _step_out(cfg, p, x1, z, cache["ssm"])
    return out, {"conv": new_conv, "ssm": h}


def _step_out(cfg: ModelConfig, p, x1, z, ssm, xdb=None):
    cd = cfg.dtype("compute")
    f32 = torch.float32
    dt, Bp, Cp = _ssm_inputs(cfg, p, x1, xdb)
    A = -torch.exp(p["A_log"].to(f32))
    dA = torch.exp(dt[..., None] * A[None])
    dBx = (dt * x1.to(f32))[..., None] * Bp[:, None, :]
    h = dA * ssm + dBx
    y = (h * Cp[:, None, :]).sum(dim=-1) + x1.to(f32) * p["D"].to(f32)
    y = y.to(cd) * F.silu(z)
    out = torch.einsum("bi,id->bd", y, p["out_proj"].to(cd))[:, None, :]
    return out, h
