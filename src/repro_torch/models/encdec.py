"""Encoder-decoder stack (``repro/models/encdec.py``; seamless-m4t's
backbone).

Encoder: non-causal attention blocks over precomputed frame embeddings
(the modality frontend is a stub, as in the reference).  Decoder: causal
self-attention + cross-attention to the encoder output + FFN.
Cross-attention K/V are computed once at prefill and frozen.  Layer
params carry a leading layer axis, as the reference's trees do, and the
layers run in a Python loop, each rematerialized under ``cfg.remat``
when a gradient is taken (``transformer.remat_group``), as the
reference's ``jax.checkpoint`` bodies.

Serving steps: ``prefill`` (encode, then a teacher-forced decoder pass
collecting caches) and ``decode_step`` (one decoder token).  Training:
``loss_fn`` (cross entropy; the aux loss is zero).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import attention as attn_mod
from repro_torch.models.blocks import (apply_ffn, apply_norm, embed_tokens,
                                       init_embed, init_ffn, init_norm,
                                       lm_logits, softmax_xent)
from repro_torch.models.frontends import resolve_device
from repro_torch.models.transformer import (_group, _sinusoidal, _stack,
                                            _unbind_groups, make_generator,
                                            remat_group, stream_rank)


def _init_enc_block(cfg, gen, prefix, device):
    return {"ln1": init_norm(cfg, prefix, device),
            "attn": attn_mod.init_attn(cfg, gen, prefix, device),
            "ln2": init_norm(cfg, prefix, device),
            "ffn": init_ffn(cfg, gen, prefix, device=device)}


def _init_dec_block(cfg, gen, prefix, device):
    return {"ln1": init_norm(cfg, prefix, device),
            "self_attn": attn_mod.init_attn(cfg, gen, prefix, device),
            "ln_x": init_norm(cfg, prefix, device),
            "cross_attn": attn_mod.init_attn(cfg, gen, prefix, device),
            "ln2": init_norm(cfg, prefix, device),
            "ffn": init_ffn(cfg, gen, prefix, device=device)}


def init_params(cfg: ModelConfig, generator=0, *,
                device=None) -> Dict[str, Any]:
    """Random params in the reference's tree (see
    ``transformer.init_params``; carry a reference tree across with
    ``transformer.params_from_numpy``)."""
    dev = resolve_device(device)
    gen = make_generator(generator, dev)
    params = init_embed(cfg, gen, dev)
    params["enc_blocks"] = _init_enc_block(cfg, gen, (cfg.enc_layers,), dev)
    params["dec_blocks"] = _init_dec_block(cfg, gen, (cfg.n_layers,), dev)
    params["enc_norm"] = init_norm(cfg, (), dev)
    params["final_norm"] = init_norm(cfg, (), dev)
    return params


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device).expand(B, S)


def encode(cfg: ModelConfig, params, embeds):
    """embeds: (B, S_enc, D) precomputed frame embeddings (stub frontend)."""
    B, S, _ = embeds.shape
    x = embeds.to(cfg.dtype("compute"))
    positions = _positions(B, S, x.device)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoidal(cfg, positions)

    def body(p, x):
        p = tp.gather_group(p)
        with stream_rank(p):
            h = apply_norm(cfg, p["ln1"], x)
            out, _ = attn_mod.attn_block(cfg, p["attn"], h, positions,
                                         causal=False)
            x = x + out.to(x.dtype)
            h2 = apply_norm(cfg, p["ln2"], x)
            return x + apply_ffn(cfg, p["ffn"], h2).to(x.dtype)

    for p in _unbind_groups(params["enc_blocks"], cfg.enc_layers):
        x = remat_group(cfg, body, p, x)
    return apply_norm(cfg, params["enc_norm"], x)


def _cross_attn(cfg: ModelConfig, p, x, enc_out):
    """Full (non-cached) cross-attention: q from x, k/v from enc_out.
    ``p`` a ``tensor_parallel.Split``: each model rank its query heads'
    q and its kv heads' k/v (``x`` and ``enc_out`` replicated), its rows
    of ``wo``, the ranks' outputs summed in rank order; k/v come back as
    ``Split``s of the ranks' kv heads."""
    if isinstance(p, tp.Split):
        outs = tp.run(p.group, p.parts, lambda m, q, xm, em: _cross_attn(
            cfg, q, xm, em), x, enc_out)
        return (tp.reduce(p.group, [o[0] for o in outs]),
                tp.Split(p.group, [o[1] for o in outs]),
                tp.Split(p.group, [o[2] for o in outs]))
    cd = cfg.dtype("compute")
    B, S, _ = x.shape
    Se = enc_out.shape[1]
    Dh = cfg.head_dim
    Hq, Hkv = p["wq"].shape[-1] // Dh, p["wk"].shape[-1] // Dh
    q = torch.einsum("bsd,dh->bsh", x.to(cd),
                     p["wq"].to(cd)).reshape(B, S, Hq, Dh)
    k = torch.einsum("bsd,dh->bsh", enc_out.to(cd),
                     p["wk"].to(cd)).reshape(B, Se, Hkv, Dh)
    v = torch.einsum("bsd,dh->bsh", enc_out.to(cd),
                     p["wv"].to(cd)).reshape(B, Se, Hkv, Dh)
    o = attn_mod.full_attention(cfg, q, k, v, causal=False)
    return attn_mod._merge_heads(cfg, p, o), k, v


def decode_full(cfg: ModelConfig, params, enc_out, tokens,
                collect_cache: bool = False):
    """Teacher-forced decoder pass. tokens: (B, S_dec)."""
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(B, S, x.device)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoidal(cfg, positions)

    def body(p, x):
        p = tp.gather_group(p)
        with stream_rank(p):
            h = apply_norm(cfg, p["ln1"], x)
            out, (k, v) = attn_mod.attn_block(cfg, p["self_attn"], h,
                                              positions, causal=True)
            x = x + out.to(x.dtype)
            hx = apply_norm(cfg, p["ln_x"], x)
            out, ck, cv = _cross_attn(cfg, p["cross_attn"], hx, enc_out)
            x = x + out.to(x.dtype)
            h2 = apply_norm(cfg, p["ln2"], x)
            x = x + apply_ffn(cfg, p["ffn"], h2).to(x.dtype)
            return x, {"k": k, "v": v, "xk": ck, "xv": cv}

    caches = []
    for p in _unbind_groups(params["dec_blocks"], cfg.n_layers):
        if collect_cache:
            x, cache = body(p, x)
            caches.append(cache)
        else:
            x = remat_group(cfg, lambda p, x: body(p, x)[0], p, x)
    x = apply_norm(cfg, params["final_norm"], x)
    return x, (_stack(caches) if collect_cache else None)


def loss_fn(cfg: ModelConfig, params, batch):
    enc_out = encode(cfg, params, batch["embeds"])
    x, _ = decode_full(cfg, params, enc_out, batch["tokens"])
    logits = lm_logits(cfg, params, x)
    loss = softmax_xent(logits, batch["labels"])
    return loss, {"xent": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=loss.device)}


def init_params_abstract(cfg: ModelConfig) -> Dict[str, Any]:
    """The params tree as ``meta`` tensors."""
    return init_params(cfg, device="meta")


def prefill(cfg: ModelConfig, params, batch, *, pad_to=None):
    """batch: {"embeds": (B, S_enc, D), "tokens": (B, S_dec)}.  Returns
    (last_logits, caches, next_pos); ``pad_to`` pads the self-attention
    k/v (not the frozen cross-attention xk/xv) to that length."""
    enc_out = encode(cfg, params, batch["embeds"])
    x, caches = decode_full(cfg, params, enc_out, batch["tokens"],
                            collect_cache=True)
    logits = tp.gathered(lm_logits(cfg, params, x[:, -1:, :]))[:, 0]
    S = batch["tokens"].shape[1]
    if pad_to and pad_to > S:
        pad = pad_to - S
        for key in ("k", "v"):   # (L, B, S, Hkv, Dh)
            caches[key] = tp.smap(lambda t: torch.nn.functional.pad(
                t, (0, 0, 0, 0, 0, pad)), caches[key])
    return logits, caches, S


def decode_step(cfg: ModelConfig, params, caches, tokens, pos):
    """One decoder token. caches: {'k','v' (L,B,S,Hkv,Dh), 'xk','xv'};
    the caches passed in are not written."""
    B = tokens.shape[0]
    x = embed_tokens(cfg, params, tokens)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoidal(cfg, attn_mod.positions_b1(pos, B, x.device))
    outs = []
    for g in range(cfg.n_layers):
        p = tp.gather_group(_group(params["dec_blocks"], g))
        c = _group(caches, g)
        h = apply_norm(cfg, p["ln1"], x)
        out, ck, cv = attn_mod.decode_attn(cfg, p["self_attn"], h,
                                           c["k"], c["v"], pos)
        x = x + out.to(x.dtype)
        hx = apply_norm(cfg, p["ln_x"], x)
        x = x + _cached_cross_attn(cfg, p["cross_attn"], hx, c["xk"],
                                   c["xv"]).to(x.dtype)
        h2 = apply_norm(cfg, p["ln2"], x)
        x = x + apply_ffn(cfg, p["ffn"], h2).to(x.dtype)
        outs.append({"k": ck, "v": cv, "xk": c["xk"], "xv": c["xv"]})
    x = apply_norm(cfg, params["final_norm"], x)
    logits = tp.gathered(lm_logits(cfg, params, x))[:, 0]
    return logits, _stack(outs)


def _cached_cross_attn(cfg: ModelConfig, p, x, k, v):
    """One query token against the frozen cross-attention cache, the
    softmax in f32.  ``p`` a ``tensor_parallel.Split``: each model rank
    its query heads against its kv heads' block of the cache (a
    ``Split``, or a whole cache: each rank reads its kv heads), its rows
    of ``wo``, the ranks' outputs summed; or, over a cache split by
    sequence (a ``SeqSplit``), every query head against each rank's
    block where it lies, the softmax partials merged
    (``attention.merge_partials``), ``p`` split or whole."""
    if isinstance(k, tp.SeqSplit):
        return _seq_split_cross_attn(cfg, p, x, k, v)
    if isinstance(p, tp.Split):
        g = p.group
        if not isinstance(k, tp.Split):
            heads = [tp.kv_heads(cfg, g.tp, m) for m in range(g.tp)]
            k = [k[:, :, a:b].to(d) for (a, b), d in zip(heads, g.devices)]
            v = [v[:, :, a:b].to(d) for (a, b), d in zip(heads, g.devices)]
        else:
            k, v = k.parts, v.parts
        return tp.reduce(g, [o[0] for o in tp.run(
            g, p.parts, lambda m, q, xm, km, vm: _cached_cross_attn(
                cfg, q, xm, km, vm), x, k, v)])
    q = _cross_q(cfg, p, x)
    w = torch.softmax(torch.einsum("bhgd,bkhd->bhgk", _scaled(
        cfg, q, k.shape[2]), k.to(torch.float32)), dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w, v.to(torch.float32))
    o = o.reshape(x.shape[0], 1, -1, cfg.head_dim).to(x.dtype)
    return attn_mod._merge_heads(cfg, p, o)


def _cross_q(cfg: ModelConfig, p, x):
    """(B, Hq, Dh): the query heads ``p`` holds of one token."""
    cd = cfg.dtype("compute")
    return torch.einsum("bsd,dh->bsh", x.to(cd), p["wq"].to(cd)).reshape(
        x.shape[0], -1, cfg.head_dim)


def _scaled(cfg: ModelConfig, q, n_kv: int):
    """q (B, Hq, Dh) in f32, scaled, grouped (B, Hkv, Hq / Hkv, Dh)."""
    Dh = cfg.head_dim
    return (q.to(torch.float32) * Dh ** -0.5).reshape(q.shape[0], n_kv,
                                                       -1, Dh)


def _seq_split_cross_attn(cfg: ModelConfig, p, x, k, v):
    """Cross-attention over a frozen cache split by sequence: each model
    rank computes its query heads' q and q is gathered to every model
    rank (``p`` a ``Split``), or the stream's rank computes all of it
    (``p`` whole); each holder of a block gets q from the rank of its
    model coordinate (``tensor_parallel.spread``) and takes the (max,
    sum, out) partials of every query head over its block (every
    position valid, nothing written), which ``attention.merge_partials``
    merges in block order."""
    c = k.group
    if isinstance(p, tp.Split):
        g = p.group
        q = collectives.all_gather([o[0] for o in tp.run(
            g, p.parts, lambda m, q_p, xm: _cross_q(cfg, q_p, xm), x)], 1,
            g.ranks)
        src = g.ranks
    else:
        q, src = [_cross_q(cfg, p, x)], (collectives.current_rank(),)

    def block(m, _, km, vm, qm):
        s = torch.einsum("bhgd,bkhd->bhgk", _scaled(cfg, qm, km.shape[2]),
                         km.to(torch.float32))
        return attn_mod.softmax_partials(cfg, s, vm, torch.float32)

    return attn_mod.merge_partials(cfg, p, x, tp.run(
        c, None, block, list(k.parts), list(v.parts), tp.spread(q, src, c)),
        c.ranks)


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                       device=None):
    """Zero caches with a leading layer axis on ``device`` (``None`` =
    ``cuda``); the cross-attention caches take ``max_len`` frames, as
    the reference's."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cd = cfg.dtype("compute")
    return {key: torch.zeros(shape, dtype=cd, device=dev)
            for key in ("k", "v", "xk", "xv")}
