"""Decoder-only stack (``repro/models/transformer.py``) covering dense /
MoE / hybrid (mamba) / ssm (rwkv) serving, with token or
precomputed-embedding (``embed_inputs``) inputs.

Layers are grouped into a repeating *period* P (1 for homogeneous
stacks; 8 for jamba's 1-attn:7-mamba; lcm with moe_every for MoE
alternation) and params carry a leading group axis of n_layers/P, as
the reference's trees do.  The groups run in a Python loop over one
``unbind`` of the stacked params (its backward stacks the groups'
gradients once): the reference's ``lax.scan`` changes no result.
Under ``cfg.remat`` a group is rematerialized when a gradient is
taken, as the reference's ``jax.checkpoint`` (``remat_group``); remat
changes no result either.

  forward       — hidden states (+ per-layer caches)
  loss_fn       — softmax cross entropy + 0.01 * MoE aux (training)
  prefill       — forward returning per-layer caches + last-pos logits
  decode_step   — one token through cached layers
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.blocks import (apply_ffn, apply_norm, embed_tokens,
                                       init_embed, init_ffn, init_norm,
                                       lm_logits, softmax_xent)
from repro_torch.models.frontends import resolve_device
from repro_torch.models.moe import apply_moe, init_moe


# ---------------------------------------------------------------------------
# Layer layout
# ---------------------------------------------------------------------------
def block_period(cfg: ModelConfig) -> int:
    p = cfg.attn_every if cfg.attn_every > 1 else 1
    if cfg.moe:
        p = math.lcm(p, cfg.moe.moe_every)
    return p


def period_pattern(cfg: ModelConfig):
    """[(kind, use_moe)] for one period of the stack."""
    p = block_period(cfg)
    kinds = cfg.attn_layout[:p]
    out = []
    for i, kind in enumerate(kinds):
        use_moe = (bool(cfg.moe) and (i % cfg.moe.moe_every == 0)
                   and kind != "rwkv")
        out.append((kind, use_moe))
    return out


def moe_num_groups(n_tokens: int) -> int:
    if n_tokens >= 16_384:
        return n_tokens // 1_024
    if n_tokens >= 16 and n_tokens % 16 == 0:
        return 16
    return 1


def _n_groups(cfg: ModelConfig) -> int:
    period = len(period_pattern(cfg))
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is no "
                         f"multiple of the block period {period}")
    return cfg.n_layers // period


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts of one structure (a
    ``tensor_parallel.Split`` part by part, each on its model rank; a
    model rank's None, a leaf it holds none of, stays None)."""
    if trees[0] is None:
        return None
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], tp.Split):
        g = trees[0].group
        parts = []
        for m, rank in enumerate(g.ranks):
            with collectives.on_rank(rank):
                parts.append(tree_map(fn, *(t.parts[m] for t in trees)))
        return trees[0].like(parts)
    return fn(*trees)


def _stack(trees):
    return tree_map(lambda *ts: torch.stack(ts), *trees)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_sub(cfg: ModelConfig, gen, kind: str, use_moe: bool, prefix,
              device):
    p: Dict[str, Any] = {"ln1": init_norm(cfg, prefix, device)}
    if kind == "attn":
        p["attn"] = attn_mod.init_attn(cfg, gen, prefix, device)
    elif kind == "mamba":
        p["mamba"] = mamba_mod.init_mamba(cfg, gen, prefix, device)
    else:  # rwkv
        p["rwkv_tm"] = rwkv_mod.init_rwkv_tm(cfg, gen, prefix, device)
    p["ln2"] = init_norm(cfg, prefix, device)
    if kind == "rwkv":
        p["rwkv_cm"] = rwkv_mod.init_rwkv_cm(cfg, gen, prefix, device)
    elif use_moe:
        p["moe"] = init_moe(cfg, gen, prefix, device)
    else:
        p["ffn"] = init_ffn(cfg, gen, prefix, device=device)
    return p


def make_generator(generator, dev: torch.device):
    """``generator`` itself, or a ``torch.Generator`` on ``dev`` seeded
    with it; ``None`` on the ``meta`` device (nothing is drawn)."""
    if isinstance(generator, torch.Generator) or dev.type == "meta":
        return generator if isinstance(generator, torch.Generator) else None
    return torch.Generator(device=dev).manual_seed(int(generator))


def init_params(cfg: ModelConfig, generator=0, *, device=None) -> Dict[str, Any]:
    """Random params in the reference's tree, drawn tensor by tensor from
    ``generator`` (a ``torch.Generator`` or a seed for one on ``device``;
    ``None`` = ``cuda``; ``"meta"``: shapes and dtypes only).  The
    numbers differ from the reference's ``jax.random``: carry a
    reference tree across with ``params_from_numpy``."""
    dev = resolve_device(device)
    gen = make_generator(generator, dev)
    n_groups = _n_groups(cfg)
    params = init_embed(cfg, gen, dev)
    params["blocks"] = {
        f"sub{i}": _init_sub(cfg, gen, kind, use_moe, (n_groups,), dev)
        for i, (kind, use_moe) in enumerate(period_pattern(cfg))}
    params["final_norm"] = init_norm(cfg, (), dev)
    return params


def init_params_abstract(cfg: ModelConfig) -> Dict[str, Any]:
    """The params tree as ``meta`` tensors (the reference's
    ``eval_shape``): no memory, any size."""
    return init_params(cfg, device="meta")


def _leaf_from_numpy(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def params_from_numpy(tree, device=None):
    """The reference's params tree (nested dicts with numpy or
    array-like leaves, e.g. ``repro``'s ``init_params``) as this
    package's, key for key, on ``device`` (``None`` = ``cuda``)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a, dev), tree)


def train_state_from_numpy(state, device=None):
    """The reference's ``TrainState`` (params, ``OptState(mu, nu,
    step)``; numpy or array-like leaves) as this package's
    ``api.TrainState``: params and moments on ``device`` (``None`` =
    ``cuda``), the step a 0-d int32 CPU tensor."""
    from repro_torch.models.api import TrainState
    from repro_torch.optim.adamw import OptState
    params, opt = state
    mu, nu, step = opt
    return TrainState(params_from_numpy(params, device),
                      OptState(params_from_numpy(mu, device),
                               params_from_numpy(nu, device),
                               torch.tensor(int(np.asarray(step)),
                                            dtype=torch.int32)))


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------
def _dots_saveable(ctx, op, *args, **kwargs):
    """The selective policy of ``remat="block_dots"`` (the reference's
    ``dots_with_no_batch_dims_saveable``): keep the outputs of products
    without batch dimensions (``mm``, ``addmm``, and ``bmm`` over one
    batch, as ``einsum`` lowers a projection), recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_group(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, rematerialized in the backward under ``cfg.remat``
    when a gradient is being taken: ``"block"`` keeps nothing of the
    group (``torch.utils.checkpoint``, non-reentrant), ``"block_dots"``
    keeps the outputs ``_dots_saveable`` names; ``"none"`` (or no grad
    mode) runs it plainly."""
    if cfg.remat not in ("block", "block_dots") or \
            not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils import checkpoint as ckpt
    if cfg.remat == "block":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    return ckpt.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: ckpt.create_selective_checkpoint_contexts(
            _dots_saveable))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _sinusoidal(cfg: ModelConfig, positions):
    D = cfg.d_model
    inv = 1.0 / (10_000 ** (torch.arange(
        0, D, 2, dtype=torch.float32, device=positions.device) / D))
    ang = positions.to(torch.float32)[..., None] * inv
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe.to(cfg.dtype("compute"))


def _embed_inputs(cfg: ModelConfig, params, batch):
    if cfg.embed_inputs:
        x = batch["embeds"].to(cfg.dtype("compute"))
        B, S = x.shape[:2]
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_tokens(cfg, params, tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoidal(cfg, positions)
    return x, positions


def _apply_sub(cfg: ModelConfig, p, x, positions, kind: str, use_moe: bool,
               collect_cache: bool, causal: bool = True,
               moe_groups: Optional[int] = None):
    """One sub-block. Returns (x, aux, cache).  ``moe_groups``: the MoE
    capacity groups of these tokens (default ``moe_num_groups`` of their
    count)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(cfg, p["ln1"], x)
    cache = {}
    if kind == "attn":
        out, (k, v) = attn_mod.attn_block(cfg, p["attn"], h, positions,
                                          causal=causal)
        if collect_cache:
            cd = cfg.dtype("compute")
            cache = {"k": tp.smap(lambda t: t.to(cd), k),
                     "v": tp.smap(lambda t: t.to(cd), v)}
    elif kind == "mamba":
        if collect_cache:
            out, cache = mamba_mod.mamba_forward_with_cache(cfg, p["mamba"],
                                                            h)
        else:
            out = mamba_mod.mamba_forward(cfg, p["mamba"], h)
    else:  # rwkv: from a zero state; the cache holds the normed last x
        st = rwkv_mod.init_rwkv_state(cfg, x.shape[0], x.device)
        out, _, state = rwkv_mod.rwkv_time_mix(cfg, p["rwkv_tm"], h,
                                               st["tm_x"], st["state"])
        if collect_cache:
            cache = {"state": rwkv_mod.whole_state(state),
                     "tm_x": h[:, -1, :]}
    x = x + out.to(x.dtype)
    h2 = apply_norm(cfg, p["ln2"], x)
    if kind == "rwkv":
        out2, _ = rwkv_mod.rwkv_channel_mix(
            cfg, p["rwkv_cm"], h2,
            torch.zeros((x.shape[0], cfg.d_model), dtype=h2.dtype,
                        device=x.device))
        if collect_cache:   # keys in the reference's tree (sorted) order
            cache = {"cm_x": h2[:, -1, :], **cache}
    elif use_moe:
        n_tokens = x.shape[0] * x.shape[1]
        out2, aux = apply_moe(cfg, p["moe"], h2, num_groups=(
            moe_num_groups(n_tokens) if moe_groups is None else moe_groups))
    else:
        out2 = apply_ffn(cfg, p["ffn"], h2)
    x = x + out2.to(x.dtype)
    return x, aux, cache


def _group(tree, g: int):
    return tree_map(lambda t: t[g], tree)


def _unbind_groups(blocks, n: int):
    """The stacked params as ``n`` per-group trees (views; a
    ``tensor_parallel.Deferred`` leaf as its groups, not yet gathered:
    ``tensor_parallel.gather_group`` gathers a group where it runs)."""
    if isinstance(blocks, dict):
        per = {k: _unbind_groups(v, n) for k, v in blocks.items()}
        return [{k: per[k][g] for k in blocks} for g in range(n)]
    if isinstance(blocks, tp.Split):
        # on each model rank (the backward's stack of the groups'
        # gradients is that rank's work)
        keys = sorted(blocks.parts[0])
        lazy = {k for k in keys if any(isinstance(p[k], tp.Deferred)
                                       for p in blocks.parts)}
        eager = [k for k in keys if k not in lazy]
        per = tp.run(blocks.group, [{k: p[k] for k in eager}
                                    for p in blocks.parts],
                     lambda m, part: tuple(t for k in eager for t in (
                         (None,) * n if part[k] is None
                         else part[k].unbind(0)))) if eager else \
            [()] * blocks.group.tp
        return [tp.Split(blocks.group, [dict(
            {k: views[i * n + g] for i, k in enumerate(eager)},
            **{k: None if p[k] is None else p[k][g] for k in lazy})
            for views, p in zip(per, blocks.parts)]) for g in range(n)]
    return blocks.unbind(0)


def stream_rank(params):
    """Where the stream's work runs: the first model rank of the
    params' ``ModelGroup`` (``on_rank``), or no change unsplit."""
    group = tp.group_of(params)
    return (contextlib.nullcontext() if group is None
            else collectives.on_rank(group.ranks[0]))


def forward(cfg: ModelConfig, params, batch, *, collect_cache: bool = False,
            causal: bool = True, moe_groups: Optional[int] = None):
    """Returns (hidden (B,S,D), aux_loss, caches | None).  ``moe_groups``
    overrides the MoE capacity groups of the batch's tokens: a data
    rank of a mesh runs its rows with its share of the whole batch's
    groups (``distributed/shard_train.py``)."""
    period = period_pattern(cfg)
    x, positions = _embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def group_body(gp, x, aux):
        gp = tp.gather_group(gp)
        caches = {}
        with stream_rank(gp):
            for i, (kind, use_moe) in enumerate(period):
                x, a, cache = _apply_sub(cfg, gp[f"sub{i}"], x, positions,
                                         kind, use_moe, collect_cache,
                                         causal, moe_groups)
                aux = aux + a
                caches[f"sub{i}"] = cache
        return x, aux, caches

    cache_list = []
    for gp in _unbind_groups(params["blocks"], _n_groups(cfg)):
        if collect_cache:
            x, aux, caches = group_body(gp, x, aux)
            cache_list.append(caches)
        else:
            x, aux = remat_group(
                cfg, lambda gp, x, aux: group_body(gp, x, aux)[:2], gp, x,
                aux)
    x = apply_norm(cfg, params["final_norm"], x)
    return x, aux, (_stack(cache_list) if collect_cache else None)


def apply_groups(cfg: ModelConfig, blocks, x, positions):
    """``blocks`` (params with a leading group axis of any length) applied
    group by group to hidden states ``x``: ``forward``'s stack between
    the embedding and the final norm, as one pipeline stage runs it.
    Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    leaf = blocks
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    for gp in _unbind_groups(blocks, leaf.shape[0]):
        for i, (kind, use_moe) in enumerate(period_pattern(cfg)):
            x, a, _ = _apply_sub(cfg, gp[f"sub{i}"], x, positions, kind,
                                 use_moe, False)
            aux = aux + a
    return x, aux


def loss_fn(cfg: ModelConfig, params, batch, *,
            moe_groups: Optional[int] = None):
    x, aux, _ = forward(cfg, params, batch, moe_groups=moe_groups)
    logits = lm_logits(cfg, params, x)
    loss = softmax_xent(logits, batch["labels"])
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------
def prefill(cfg: ModelConfig, params, batch, *, pad_to: Optional[int] = None,
            moe_groups: Optional[int] = None):
    """Run the prompt; return (last_logits, caches, next_pos).

    ``pad_to``: allocate attention KV caches at this length (>= S) so
    decode can append in place.  ``moe_groups`` as ``forward``'s.
    """
    x, _, caches = forward(cfg, params, batch, collect_cache=True,
                           moe_groups=moe_groups)
    logits = tp.gathered(lm_logits(cfg, params, x[:, -1:, :]))[:, 0]
    S = (batch["embeds"] if cfg.embed_inputs else batch["tokens"]).shape[1]
    if pad_to and pad_to > S:
        pad = pad_to - S

        def pad_kv(c):
            out = dict(c)
            for key in ("k", "v"):
                if key in c:   # (G, B, S, Hkv, Dh)
                    out[key] = tp.smap(lambda t: torch.nn.functional.pad(
                        t, (0, 0, 0, 0, 0, pad)), c[key])
            return out

        caches = {name: pad_kv(c) for name, c in caches.items()}
    return logits, caches, S


def decode_step(cfg: ModelConfig, params, caches, tokens, pos, *,
                moe_groups: Optional[int] = None):
    """One token step. tokens: (B, 1) (or embeds (B, 1, D) for an
    ``embed_inputs`` config); pos: scalar or (B,) positions.

    caches: leading group axis (as produced by prefill or
    ``init_decode_caches``).  Returns (logits (B, V), new_caches); the
    caches passed in are not written.  ``moe_groups``: the MoE capacity
    groups of these rows (default ``moe_num_groups(B)``; a data rank
    runs its share of the whole batch's)."""
    period = period_pattern(cfg)
    B = tokens.shape[0]
    if cfg.embed_inputs and tokens.dim() == 3:
        x = tokens.to(cfg.dtype("compute"))
    else:
        x = embed_tokens(cfg, params, tokens)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoidal(cfg, attn_mod.positions_b1(pos, B, x.device))
    outs = []
    for g in range(_n_groups(cfg)):
        gp = tp.gather_group(_group(params["blocks"], g))
        gc = _group(caches, g)
        new_cache = {}
        for i, (kind, use_moe) in enumerate(period):
            p = gp[f"sub{i}"]
            c = gc[f"sub{i}"]
            h = apply_norm(cfg, p["ln1"], x)
            if kind == "attn":
                out, ck, cv = attn_mod.decode_attn(cfg, p["attn"], h,
                                                   c["k"], c["v"], pos)
                nc = {"k": ck, "v": cv}
            elif kind == "mamba":
                out, nc = mamba_mod.mamba_step(cfg, p["mamba"], h, c)
            else:  # rwkv
                out, _, state = rwkv_mod.rwkv_time_mix(
                    cfg, p["rwkv_tm"], h, c["tm_x"], c["state"])
                nc = {"state": rwkv_mod.whole_state(state),
                      "tm_x": h[:, -1, :]}
            x = x + out.to(x.dtype)
            h2 = apply_norm(cfg, p["ln2"], x)
            if kind == "rwkv":
                out2, _ = rwkv_mod.rwkv_channel_mix(cfg, p["rwkv_cm"], h2,
                                                    c["cm_x"])
                nc = {"cm_x": h2[:, -1, :], **nc}
            elif use_moe:
                # dead serving slots take part and compete for capacity,
                # as in the reference
                out2, _ = apply_moe(cfg, p["moe"], h2, num_groups=(
                    moe_num_groups(B) if moe_groups is None
                    else moe_groups))
            else:
                out2 = apply_ffn(cfg, p["ffn"], h2)
            x = x + out2.to(x.dtype)
            new_cache[f"sub{i}"] = nc
        outs.append(new_cache)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = tp.gathered(lm_logits(cfg, params, x))[:, 0]
    return logits, _stack(outs)


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                       device=None):
    """Zero caches with leading group axis on ``device`` (``None`` =
    ``cuda``)."""
    dev = resolve_device(device)
    n_groups = _n_groups(cfg)
    cd = cfg.dtype("compute")
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim

    def one(kind):
        if kind == "attn":
            shape = (n_groups, batch, max_len, Hkv, Dh)
            return {"k": torch.zeros(shape, dtype=cd, device=dev),
                    "v": torch.zeros(shape, dtype=cd, device=dev)}
        if kind == "mamba":
            mc = cfg.mamba
            return {"conv": torch.zeros((n_groups, batch, mc.d_conv - 1,
                                         cfg.d_inner), dtype=cd, device=dev),
                    "ssm": torch.zeros((n_groups, batch, cfg.d_inner,
                                        mc.d_state), dtype=torch.float32,
                                       device=dev)}
        H, hs = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
        return {"cm_x": torch.zeros((n_groups, batch, cfg.d_model),
                                    dtype=cd, device=dev),
                "state": torch.zeros((n_groups, batch, H, hs, hs),
                                     dtype=torch.float32, device=dev),
                "tm_x": torch.zeros((n_groups, batch, cfg.d_model),
                                    dtype=cd, device=dev)}

    return {f"sub{i}": one(kind)
            for i, (kind, _) in enumerate(period_pattern(cfg))}
