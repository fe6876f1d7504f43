"""GQA attention of the LM stack (``repro/models/attention.py``) + KV cache.

Plain PyTorch, as the reference computes it in plain jnp outside any
Pallas kernel (the attention IP family's kernels serve the budget
sweep's sites, not this model).  Two full-sequence forms under the
reference's dispatch rule, and the cached decode step:

  * ``naive``   — materialized scores; only for smoke-scale S.
  * ``chunked`` — online softmax over kv chunks, a q chunk at a time:
                  peak memory O(bq*bk) per head.
  * decode      — single-token attention over the whole cache with
                  position masking, in max/sum-mergeable softmax form.

``attn_score_dtype`` is the dtype score chunks are materialized in
(softmax statistics stay f32) and ``causal_skip`` skips kv chunks wholly
above the causal diagonal, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.blocks import apply_rope, normal, rope_freqs

NEG_INF = -1e30


def init_attn(cfg: ModelConfig, gen: torch.Generator, shape_prefix=(),
              device="cpu"):
    pd = cfg.dtype("param")
    D, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pre = tuple(shape_prefix)
    s = D ** -0.5
    return {
        "wq": normal(gen, pre + (D, Hq * Dh), s, pd, device),
        "wk": normal(gen, pre + (D, Hkv * Dh), s, pd, device),
        "wv": normal(gen, pre + (D, Hkv * Dh), s, pd, device),
        "wo": normal(gen, pre + (Hq * Dh, D), (Hq * Dh) ** -0.5, pd, device),
    }


def _qkv(cfg: ModelConfig, p, x, positions):
    """q, k, v of the heads ``p`` holds (all of them, or a model rank's:
    the head counts are read from ``wq``/``wk``)."""
    cd = cfg.dtype("compute")
    B, S, _ = x.shape
    Dh = cfg.head_dim
    Hq, Hkv = p["wq"].shape[-1] // Dh, p["wk"].shape[-1] // Dh
    x = x.to(cd)
    q = torch.einsum("bsd,dh->bsh", x, p["wq"].to(cd)).reshape(B, S, Hq, Dh)
    k = torch.einsum("bsd,dh->bsh", x, p["wk"].to(cd)).reshape(B, S, Hkv, Dh)
    v = torch.einsum("bsd,dh->bsh", x, p["wv"].to(cd)).reshape(B, S, Hkv, Dh)
    if cfg.rope_style != "none":
        cos, sin = rope_freqs(cfg, positions)
        q = apply_rope(cfg, q, cos, sin)
        k = apply_rope(cfg, k, cos, sin)
    return q, k, v


def _merge_heads(cfg: ModelConfig, p, o):
    B, S = o.shape[:2]
    cd = cfg.dtype("compute")
    o = o.reshape(B, S, o.shape[2] * o.shape[3])
    return torch.einsum("bsh,hd->bsd", o.to(cd), p["wo"].to(cd))


def _scalar(value: float, dtype, device) -> torch.Tensor:
    """A 0-d tensor of ``dtype``: the reference's ``jnp.asarray(v, sd)``,
    rounded to ``dtype`` before it multiplies."""
    return torch.tensor(value, dtype=dtype, device=device)


def _dot_f32(eq: str, a, b):
    """``einsum(..., preferred_element_type=f32)``: products of bf16 or
    f32 operands are exact in f32, so widening first gives the same
    sums."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


# ---------------------------------------------------------------------------
# Full-sequence attention (train / prefill)
# ---------------------------------------------------------------------------
def _naive_attn(cfg, q, k, v, causal: bool):
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    sd = cfg.dtype("attn_score")
    qf = (q.to(sd).reshape(B, Sq, Hkv, g, Dh)
          * _scalar(Dh ** -0.5, sd, q.device))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(sd))
    if causal:
        Skv = k.shape[1]
        dev = q.device
        mask = (torch.arange(Skv, device=dev)[None, :]
                <= torch.arange(Sq, device=dev)[:, None] + (Skv - Sq))
        s = torch.where(mask[None, None, None], s, _scalar(NEG_INF, sd, dev))
    w = torch.softmax(s.to(torch.float32), dim=-1).to(sd)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.to(sd))
    return o.reshape(B, Sq, Hq, Dh).to(q.dtype)


def _chunked_attn(cfg, q, k, v, causal: bool, bq: int, bk: int):
    """Online-softmax flash form, a q chunk at a time over kv chunks.

    All (bq, bk)-sized tensors live in ``attn_score_dtype``; only the
    O(bq)-sized statistics are f32.  ``causal_skip`` passes chunks wholly
    above the diagonal through unchanged (exact)."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    offs = Skv - Sq
    nq, nk = Sq // bq, Skv // bk
    assert Sq % bq == 0 and Skv % bk == 0, (Sq, bq, Skv, bk)
    sd = cfg.dtype("attn_score")
    f32 = torch.float32
    dev = q.device
    scale = _scalar(Dh ** -0.5, sd, dev)
    neg = _scalar(NEG_INF, sd, dev)
    skip = causal and cfg.causal_skip
    outs = []
    for i in range(nq):
        qi0 = i * bq
        qf = q[:, qi0:qi0 + bq].to(sd).reshape(B, bq, Hkv, g, Dh) * scale
        m = torch.full((B, Hkv, g, bq), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((B, Hkv, g, bq), dtype=f32, device=dev)
        acc = torch.zeros((B, Hkv, g, bq, Dh), dtype=f32, device=dev)
        for j in range(nk):
            kj0 = j * bk
            if skip and kj0 > qi0 + bq - 1 + offs:
                continue
            kc = k[:, kj0:kj0 + bk]
            vc = v[:, kj0:kj0 + bk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc.to(sd))
            if causal:
                qpos = qi0 + torch.arange(bq, device=dev)[:, None]
                kpos = kj0 + torch.arange(bk, device=dev)[None, :]
                s = torch.where((kpos <= qpos + offs)[None, None, None], s,
                                neg)
            m_new = torch.maximum(m, s.amax(dim=-1).to(f32))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(s - m_new[..., None].to(sd))
            l = l * alpha + pexp.sum(dim=-1, dtype=f32)
            acc = acc * alpha[..., None] + _dot_f32(
                "bhgqk,bkhd->bhgqd", pexp, vc.to(sd))
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, bq, Hq, Dh)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def full_attention(cfg: ModelConfig, q, k, v, *, causal: bool = True,
                   bq: int = 512, bk: int = 1024):
    """Dispatch naive vs chunked on working-set size (the selector rule)."""
    Sq = q.shape[1]
    Skv = k.shape[1]
    if Sq * Skv <= 4096 * 4096 // 8 or Sq % min(bq, Sq) or Skv % min(bk, Skv):
        return _naive_attn(cfg, q, k, v, causal)
    if not cfg.scan_layers:
        # the reference's unrolled graphs take fewer, larger chunks; the
        # result is chunking-invariant up to f32 rounding
        bq = min(Sq, max(512, Sq // 8))
        bk = min(Skv, max(1024, Skv // 4))
    return _chunked_attn(cfg, q, k, v, causal, min(bq, Sq), min(bk, Skv))


# ---------------------------------------------------------------------------
# Cached attention (decode)
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype=None, device="cpu"):
    dt = dtype or cfg.dtype("compute")
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def positions_b1(pos, B: int, device="cpu"):
    """Normalize a scalar or (B,) position arg to (B, 1) int64."""
    p = torch.as_tensor(pos, device=device).to(torch.int64)
    if p.dim() == 0:
        return p.expand(B, 1).clone()
    return p.reshape(B, 1)


def decode_attn(cfg: ModelConfig, p, x, cache_k, cache_v, pos):
    """One-token step. x: (B, 1, D); cache: (B, S, Hkv, Dh);
    pos: scalar or (B,) per-slot positions (continuous batching).
    Returns (out, new cache_k, new cache_v); the caches passed in are
    not written.  ``p`` a ``tensor_parallel.Split``: each model rank
    its heads, on its kv heads' block of the caches (a ``Split``, or
    whole caches: each rank reads its kv heads, and the new rows go
    back whole), or on its sequence block of every kv head (a
    ``SeqSplit``: ``_seq_split_decode_attn``, whether or not ``p`` is
    split)."""
    if isinstance(cache_k, tp.SeqSplit):
        return _seq_split_decode_attn(cfg, p, x, cache_k, cache_v, pos)
    if isinstance(p, tp.Split):
        return _split_decode_attn(cfg, p, x, cache_k, cache_v, pos)
    B = x.shape[0]
    Dh = cfg.head_dim
    Hq, Hkv = p["wq"].shape[-1] // Dh, cache_k.shape[2]
    g = Hq // Hkv
    dev = x.device
    pos_b1 = positions_b1(pos, B, dev)
    q, k_new, v_new = _qkv(cfg, p, x, positions=pos_b1)
    rows = torch.arange(B, device=dev)
    ck = cache_k.index_put((rows, pos_b1[:, 0]),
                           k_new[:, 0].to(cache_k.dtype))
    cv = cache_v.index_put((rows, pos_b1[:, 0]),
                           v_new[:, 0].to(cache_v.dtype))
    S = ck.shape[1]
    sd = cfg.dtype("attn_score")
    qf = q.to(sd).reshape(B, Hkv, g, Dh) * _scalar(Dh ** -0.5, sd, dev)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, ck.to(sd))
    valid = (torch.arange(S, device=dev)[None, None, None, :]
             <= pos_b1[:, 0][:, None, None, None])
    s = torch.where(valid, s, _scalar(NEG_INF, sd, dev))
    w = torch.softmax(s.to(torch.float32), dim=-1).to(sd)
    o = _dot_f32("bhgk,bkhd->bhgd", w, cv.to(sd))
    o = o.reshape(B, 1, Hq, Dh).to(x.dtype)
    return _merge_heads(cfg, p, o), ck, cv


def _split_decode_attn(cfg: ModelConfig, p, x, cache_k, cache_v, pos):
    g = p.group
    whole = not isinstance(cache_k, tp.Split)

    def rank(m, q, xm, ck, cv):
        return decode_attn(cfg, q, xm, ck, cv, pos)

    if whole:
        heads = [tp.kv_heads(cfg, g.tp, m) for m in range(g.tp)]
        ks = [cache_k[:, :, a:b].to(d) for (a, b), d in zip(heads,
                                                             g.devices)]
        vs = [cache_v[:, :, a:b].to(d) for (a, b), d in zip(heads,
                                                             g.devices)]
    else:
        ks, vs = cache_k.parts, cache_v.parts
    outs = tp.run(g, p.parts, rank, x, ks, vs)
    out = tp.reduce(g, [o[0] for o in outs])
    if not whole:
        return (out, tp.Split(g, [o[1] for o in outs]),
                tp.Split(g, [o[2] for o in outs]))
    # the new rows back whole: each kv head from the first rank that has it
    B = x.shape[0]
    pos_b1 = positions_b1(pos, B, x.device)
    rows = torch.arange(B, device=x.device)
    new = []
    for c, i in ((cache_k, 1), (cache_v, 2)):
        got, upto = [], 0
        for m, (a, b) in enumerate(heads):
            if b > upto:
                at = outs[m][i][:, :, upto - a:b - a].to(x.device)
                got.append(at[rows, pos_b1[:, 0]])
                upto = b
        row = torch.cat(got, dim=1)
        collectives.record("all-gather", row.numel() * row.element_size(),
                           g.tp, g.ranks[0])
        new.append(c.index_put((rows, pos_b1[:, 0]), row.to(c.dtype)))
    return out, new[0], new[1]


def _seq_split_decode_attn(cfg: ModelConfig, p, x, cache_k, cache_v, pos):
    """Flash-decode over a cache split by sequence (``SeqSplit``, over
    the ranks that hold its blocks: a data rank's model ranks, or every
    (data, model) rank where the sequence is sharded over both axes).
    With ``p`` a ``Split`` each model rank computes its query heads' q
    and its kv heads' new rows, and the new rows (every kv head, from
    the first rank that has it) and q (every query head) are gathered
    to every model rank; with ``p`` whole (its heads do not divide the
    model degree) the stream's rank computes them.  Each holder of a
    block not among those gets them from the rank of its model
    coordinate (``tensor_parallel.spread``), writes the rows whose
    position falls in its block and computes, for every query head over
    its block under the position mask, the (max, sum, out) partials of
    the mergeable softmax, which ``merge_partials`` merges in block
    order.  The cache never moves, and every holder does the same work
    whatever the positions."""
    c = cache_k.group
    B, Dh = x.shape[0], cfg.head_dim
    pos_b1 = positions_b1(pos, B, x.device)

    def project(m, q_p, xm, pm):
        q, k, v = _qkv(cfg, q_p, xm, positions=pm)
        return q[:, 0], k[:, 0], v[:, 0]

    if isinstance(p, tp.Split):
        g = p.group
        proj = tp.run(g, p.parts, project, x, pos_b1)
        # each kv head from the first rank that has it (none from the rest)
        own, upto = [], 0
        for m in range(g.tp):
            a, b = tp.kv_heads(cfg, g.tp, m)
            own.append(slice(max(upto, a) - a, max(b, upto) - a))
            upto = max(upto, b)
        new_k, new_v = (collectives.all_gather(
            [o[i][:, sl] for o, sl in zip(proj, own)], 1, g.ranks)
            for i in (1, 2))
        q_all = collectives.all_gather([o[0] for o in proj], 1, g.ranks)
        src = g.ranks
    else:
        q_all, new_k, new_v = ([t] for t in project(0, p, x, pos_b1))
        src = (collectives.current_rank(),)
    q_all, new_k, new_v = (tp.spread(t, src, c)
                           for t in (q_all, new_k, new_v))

    def block(m, _, pm, ck, cv, q, nk, nv):
        n = ck.shape[1]
        dev = ck.device
        rows = torch.arange(B, device=dev)
        local = pm[:, 0] - m * n
        inside = ((local >= 0) & (local < n))[:, None, None]
        at = torch.clamp(local, 0, n - 1)
        ck = ck.index_put((rows, at), torch.where(
            inside, nk.to(ck.dtype), ck[rows, at]))
        cv = cv.index_put((rows, at), torch.where(
            inside, nv.to(cv.dtype), cv[rows, at]))
        Hkv = ck.shape[2]
        sd = cfg.dtype("attn_score")
        qf = (q.to(sd).reshape(B, Hkv, -1, Dh)
              * _scalar(Dh ** -0.5, sd, dev))
        s = torch.einsum("bhgd,bkhd->bhgk", qf, ck.to(sd))
        valid = (m * n + torch.arange(n, device=dev)[None, None, None, :]
                 <= pm[:, 0][:, None, None, None])
        s = torch.where(valid, s, _scalar(NEG_INF, sd, dev)).to(
            torch.float32)
        return (ck, cv) + softmax_partials(cfg, s, cv, sd)

    outs = tp.run(c, None, block, pos_b1, list(cache_k.parts),
                  list(cache_v.parts), q_all, new_k, new_v)
    return (merge_partials(cfg, p, x, outs, c.ranks),
            cache_k.like([r[0] for r in outs]),
            cache_v.like([r[1] for r in outs]))


def softmax_partials(cfg: ModelConfig, s, v, sd):
    """A block's (max, sum, out) partials of the mergeable softmax: ``s``
    the f32 scores (B, Hkv, g, n) of every query head over the block's
    ``n`` positions, ``v`` its values (B, n, Hkv, Dh), ``sd`` the dtype
    the weights meet ``v`` in.  (B, Hq), (B, Hq), (B, Hq, Dh)."""
    B = s.shape[0]
    mx = s.amax(dim=-1)
    w = torch.exp(s - mx[..., None])
    o = _dot_f32("bhgk,bkhd->bhgd", w.to(sd), v.to(sd))
    return (mx.reshape(B, -1), w.sum(dim=-1).reshape(B, -1),
            o.reshape(B, -1, cfg.head_dim))


def _merged(mx, l, o, dtype):
    """Stacked partials (n, B, H), (n, B, H), (n, B, H, Dh) of ``n``
    blocks merged in block order: (B, 1, H, Dh)."""
    top = mx[0]
    for r in range(1, mx.shape[0]):
        top = torch.maximum(top, mx[r])
    scale = torch.exp(mx - top)                   # (n, B, H)
    den, num = l[0] * scale[0], o[0] * scale[0][..., None]
    for r in range(1, mx.shape[0]):
        den = den + l[r] * scale[r]
        num = num + o[r] * scale[r][..., None]
    B, Dh = o.shape[1], o.shape[-1]
    return (num / den[..., None]).reshape(B, 1, -1, Dh).to(dtype)


def merge_partials(cfg: ModelConfig, p, x, outs, ranks):
    """The attention's output from the ``softmax_partials`` of each
    block (the last three entries of ``outs[b]``; ``ranks`` their
    holders), merged in block order.  With
    ``p`` a ``Split`` each model rank gets its query heads' partials of
    every block (an all-to-all) and merges them into its rows of ``wo``,
    and the ranks' products are summed; with ``p`` whole every block's
    partials go to the stream's rank (collective-permutes), which merges
    them and applies ``wo``."""
    if not isinstance(p, tp.Split):
        rank = collectives.current_rank()
        for r, held in zip(ranks, outs):
            if r != rank:
                collectives.record("collective-permute", sum(
                    t.numel() * t.element_size() for t in held[-3:]), 2,
                    rank)
        mx, l, o = (torch.stack([r[i].to(x.device) for r in outs])
                    for i in (-3, -2, -1))
        return _merge_heads(cfg, p, _merged(mx, l, o, x.dtype))
    g = p.group
    mx, l, o = (collectives.all_to_all([r[i] for r in outs], 1, g.ranks,
                                       g.devices) for i in (-3, -2, -1))

    def merge(m, q_p, mx, l, o):
        return _merge_heads(cfg, q_p, _merged(mx, l, o, x.dtype))

    merged = tp.run(g, p.parts, merge, mx, l, o)
    return tp.reduce(g, [r[0] for r in merged])


def attn_block(cfg: ModelConfig, p, x, positions, *, causal=True):
    """Full attention sub-block for train/prefill: returns (out, (k, v)).
    ``p`` a ``tensor_parallel.Split``: each model rank its heads,
    (k, v) ``Split``s of the ranks' kv heads."""
    if isinstance(p, tp.Split):
        outs = tp.run(p.group, p.parts, lambda m, q, xm: _attn_rank(
            cfg, q, xm, positions.to(xm.device), causal), x)
        return (tp.reduce(p.group, [o[0] for o in outs]),
                (tp.Split(p.group, [o[1] for o in outs]),
                 tp.Split(p.group, [o[2] for o in outs])))
    q, k, v = _qkv(cfg, p, x, positions)
    o = full_attention(cfg, q, k, v, causal=causal)
    return _merge_heads(cfg, p, o), (k, v)


def _attn_rank(cfg, p, x, positions, causal):
    out, (k, v) = attn_block(cfg, p, x, positions, causal=causal)
    return out, k, v
