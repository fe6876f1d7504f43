"""RWKV-6 "Finch" block (``repro/models/rwkv.py``): time-mix with
data-dependent decay + channel-mix.

The per-channel, per-token decay w_t = exp(-exp(w0 + lora(x_t))) is the
reference's; the token-shift interpolation uses static learned mix
vectors, as there.

State per head is (head_size x head_size); decode is O(1) in sequence
length.  The recurrence runs as a loop over time in f32, the
reference's ``lax.scan`` step for step (a chunked WKV kernel is ROADMAP
queue 2 work, not part of the reference).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.blocks import normal


def _heads(cfg: ModelConfig):
    hs = cfg.rwkv.head_size
    assert cfg.d_model % hs == 0
    return cfg.d_model // hs, hs


def init_rwkv_tm(cfg: ModelConfig, gen: torch.Generator, shape_prefix=(),
                 device="cpu"):
    D = cfg.d_model
    H, hs = _heads(cfg)
    r = cfg.rwkv.lora_rank_decay
    pd = cfg.dtype("param")
    pre = tuple(shape_prefix)
    s = D ** -0.5

    def mk(shape, sc=s):
        return normal(gen, pre + shape, sc, pd, device)

    def full(value):
        return torch.full(pre + (D,), value, dtype=pd, device=device)

    return {
        "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
        "mix_w": full(0.5), "mix_g": full(0.5),
        "w_r": mk((D, D)), "w_k": mk((D, D)), "w_v": mk((D, D)),
        "w_g": mk((D, D)), "w_o": mk((D, D)),
        "w0": full(-2.0),
        "w_lora_a": mk((D, r), 0.01), "w_lora_b": mk((r, D), 0.01),
        "u": mk((H, hs), 1.0),
    }


def init_rwkv_cm(cfg: ModelConfig, gen: torch.Generator, shape_prefix=(),
                 device="cpu"):
    D, F_ = cfg.d_model, cfg.d_ff
    pd = cfg.dtype("param")
    pre = tuple(shape_prefix)
    s = D ** -0.5
    return {
        "mix_k": torch.full(pre + (D,), 0.5, dtype=pd, device=device),
        "mix_r": torch.full(pre + (D,), 0.5, dtype=pd, device=device),
        "w_k": normal(gen, pre + (D, F_), s, pd, device),
        "w_v": normal(gen, pre + (F_, D), F_ ** -0.5, pd, device),
        "w_r": normal(gen, pre + (D, D), s, pd, device),
    }


def _shift(x, prev):
    """Token shift: x_{t-1} with ``prev`` (B, D) as the t=0 predecessor."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mixer(p, x, xs):
    def mix(m):
        w = p[m].to(x.dtype)
        return x * w + xs * (1 - w)
    return mix


def _lora(p, xw):
    """tanh(xw @ w_lora_a): the decay LoRA's first product (the
    stream's, replicated over the model ranks)."""
    return torch.tanh(torch.einsum("bsd,dr->bsr", xw,
                                   p["w_lora_a"].to(xw.dtype)))


def _decay_of(p, lw):
    """The (0, 1) decay of the channels ``p`` holds, from the LoRA's
    first product ``lw``."""
    lw = torch.einsum("bsr,rd->bsd", lw, p["w_lora_b"].to(lw.dtype))
    return torch.exp(-torch.exp(p["w0"].to(torch.float32)
                                + lw.to(torch.float32)))


def _decay(cfg: ModelConfig, p, xw):
    return _decay_of(p, _lora(p, xw))


def rwkv_time_mix(cfg: ModelConfig, p, x, prev_x, state):
    """x: (B,S,D); prev_x: (B,D); state: (B,H,hs,hs) f32.

    Returns (out, last_x, new_state); ``state`` is not written.  ``p`` a
    ``tensor_parallel.Split``: the token shift, the five mixes and the
    decay LoRA's first product run once on the stream's device and
    reach the model ranks that own heads (``tensor_parallel.
    rwkv_heads``) as replicated arguments; each owner runs its heads
    (their columns of every product and of the decay, their rows of
    ``u`` and ``w_o``, the recurrence from their heads of ``state``, the
    group norm and the gate), and the owners' outputs are summed in rank
    order.  The new state is then a ``Split`` of the owners' heads
    (``whole_state`` gathers it)."""
    if isinstance(p, tp.Split):
        return _split_time_mix(cfg, p, x, prev_x, state)
    xr, xk, xv, xw, xg = _mixes(p, x, prev_x)
    out, state = _heads_mix(cfg, p, xr, xk, xv, xg,
                            _lora(p, xw.to(cfg.dtype("compute"))), state)
    return out, x[:, -1, :], state


def _mixes(p, x, prev_x):
    mix = _mixer(p, x, _shift(x, prev_x))
    return (mix("mix_r"), mix("mix_k"), mix("mix_v"), mix("mix_w"),
            mix("mix_g"))


def _heads_mix(cfg: ModelConfig, p, xr, xk, xv, xg, lw, state):
    """The time-mix of the heads ``p`` holds (all of them, or a model
    rank's: the count is read from ``u``) after the token shift:
    (out, those heads' new state)."""
    H, hs = p["u"].shape[0], cfg.rwkv.head_size
    cd = cfg.dtype("compute")
    f32 = torch.float32
    B, S, _ = xr.shape

    def proj(t, w):
        return torch.einsum("bsd,de->bse", t.to(cd),
                            p[w].to(cd)).reshape(B, S, H, hs)

    r, k, v = proj(xr, "w_r"), proj(xk, "w_k"), proj(xv, "w_v")
    g = torch.einsum("bsd,de->bse", xg.to(cd), p["w_g"].to(cd))
    w = _decay_of(p, lw).reshape(B, S, H, hs)              # (0,1) decay
    u = p["u"].to(f32)[None, :, :, None]                   # (1,H,hs,1)
    # (S, B, H, hs[, 1]) views a step at a time; each step is the
    # reference's: y = r . (u * kv + s), s = w * s + kv (four launches)
    r = r.to(f32).transpose(0, 1)[..., None, :]            # (S,B,H,1,hs)
    k = k.to(f32).transpose(0, 1)[..., None]               # (S,B,H,hs,1)
    v = v.to(f32).transpose(0, 1)[..., None, :]            # (S,B,H,1,hs)
    w = w.to(f32).transpose(0, 1)[..., None]               # (S,B,H,hs,1)
    ys = []
    for t in range(S):
        kv = k[t] * v[t]                                   # (B,H,hs,hs)
        ys.append(torch.matmul(r[t], torch.addcmul(state, u, kv)))
        state = torch.addcmul(kv, w[t], state)
    y = torch.cat(ys, dim=-2).transpose(1, 2)              # (B,S,H,hs)
    # per-head group norm (population variance, as jnp.var)
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 1e-5)
    y = y.reshape(B, S, H * hs).to(cd) * F.silu(g)
    return torch.einsum("bsd,de->bse", y, p["w_o"].to(cd)), state


def _split_time_mix(cfg: ModelConfig, p, x, prev_x, state):
    g = p.group
    xr, xk, xv, xw, xg = _mixes(p.parts[0], x, prev_x)
    lw = _lora(p.parts[0], xw.to(cfg.dtype("compute")))
    owners = tp.head_owners(cfg, g.tp)
    sub = tp.ModelGroup(tuple(g.ranks[m] for m in owners),
                        tuple(g.devices[m] for m in owners))
    # each owner reads its heads of the state from its own replica
    states = []
    for m, dev in zip(owners, sub.devices):
        a, b = tp.rwkv_heads(cfg, g.tp, m)
        states.append(state[:, a:b].to(dev))
    outs = tp.run(sub, [_ranks_own(p.parts[m], "rwkv_tm") for m in owners],
                  lambda m, q, *a: _heads_mix(cfg, q, *a),
                  xr, xk, xv, xg, lw, states)
    return (tp.reduce(sub, [o[0] for o in outs]), x[:, -1, :],
            tp.Split(sub, [o[1] for o in outs]))


def _ranks_own(part, kind: str):
    """A model rank's leaves of an RWKV sublayer, without the stream's
    (``tensor_parallel.RWKV_STREAM``)."""
    return {k: v for k, v in part.items()
            if k not in tp.RWKV_STREAM[kind]}


def whole_state(state):
    """The time-mix's new state whole on the stream's device: a
    ``Split`` of the owners' heads concatenated in head order (an
    all-gather there), any other value as it is."""
    if not isinstance(state, tp.Split):
        return state
    g = state.group
    with collectives.on_rank(g.ranks[0]):
        out = torch.cat([s.to(g.devices[0]) for s in state.parts], dim=1)
    collectives.record("all-gather", out.numel() * out.element_size(),
                       g.tp, g.ranks[0])
    return out


def rwkv_channel_mix(cfg: ModelConfig, p, x, prev_x):
    """``p`` a ``tensor_parallel.Split``: ``w_k`` by columns and ``w_v``
    by rows on each model rank, the ranks' products summed in rank
    order; the mixes and the replicated ``w_r`` gate run once on the
    stream's device."""
    cd = cfg.dtype("compute")
    stream = p.parts[0] if isinstance(p, tp.Split) else p
    mix = _mixer(stream, x, _shift(x, prev_x))
    xk, xr = mix("mix_k"), mix("mix_r")
    if isinstance(p, tp.Split):
        kv = tp.reduce(p.group, [o[0] for o in tp.run(
            p.group, [_ranks_own(q, "rwkv_cm") for q in p.parts],
            lambda m, q, xm: _key_value(cd, q, xm), xk)])
    else:
        kv = _key_value(cd, p, xk)
    r = torch.sigmoid(torch.einsum("bsd,de->bse", xr.to(cd),
                                   stream["w_r"].to(cd)))
    return r * kv, x[:, -1, :]


def _key_value(cd, p, xk):
    k = torch.square(F.relu(
        torch.einsum("bsd,df->bsf", xk.to(cd), p["w_k"].to(cd))))
    return torch.einsum("bsf,fd->bsd", k, p["w_v"].to(cd))


def init_rwkv_state(cfg: ModelConfig, batch: int, device="cpu"):
    H, hs = _heads(cfg)
    D = cfg.d_model
    cd = cfg.dtype("compute")
    return {"tm_x": torch.zeros((batch, D), dtype=cd, device=device),
            "cm_x": torch.zeros((batch, D), dtype=cd, device=device),
            "state": torch.zeros((batch, H, hs, hs), dtype=torch.float32,
                                 device=device)}
