"""Shared model blocks (``repro/models/blocks.py``): the LM blocks —
norms, MLPs, embeddings, RoPE — and the CNN block.

LM blocks are plain functions over params dicts laid out as the
reference's trees: ``init_*`` draws from a ``torch.Generator`` (N(0, 1)
times the reference's scale, in f32, then cast to the param dtype) and
``apply`` functions are pure.  Layer-stacked params carry a leading
group axis (see transformer.py).  ``softmax_xent`` is the training
loss.

CNN block — conv -> pool -> activation, planned as one NetworkPlan: the
three sites share ONE ResourceBudget partitioned across them (the paper's
full-layer scenario: a CNN layer whose implementation adapts to the
available resources while its math stays fixed).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ip import SiteSpec, dtype_name, is_integer_dtype
from repro_torch.distributed import collectives
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.activation.ref import KINDS
from repro_torch.kernels.pool2d.ref import (MODES, check_pool_geometry,
                                            pool2d_out_shape)


def _generator(seed_or_generator) -> torch.Generator:
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator().manual_seed(int(seed_or_generator))


def normal(gen: torch.Generator, shape, scale: float, dtype,
           device) -> torch.Tensor:
    """N(0, 1) * ``scale`` drawn in f32 on ``gen``'s device, cast to
    ``dtype`` on ``device`` (the reference's ``normal(k, shape) * scale``
    then ``astype``).  On the ``meta`` device nothing is drawn: an
    abstract tensor of the shape and dtype (``gen`` may be ``None``)."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    w = torch.randn(tuple(shape), generator=gen, device=gen.device) * scale
    return w.to(dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(cfg: ModelConfig, shape_prefix=(), device="cpu"):
    pd = cfg.dtype("param")
    if cfg.norm == "layernorm_nonparam":
        return {}  # OLMo: no learnable scale/bias
    shape = tuple(shape_prefix) + (cfg.d_model,)
    p = {"scale": torch.ones(shape, dtype=pd, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=pd, device=device)
    return p


def apply_norm(cfg: ModelConfig, p, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        return (y * p["scale"].to(torch.float32)).to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------
def init_ffn(cfg: ModelConfig, gen: torch.Generator, shape_prefix=(),
             d_in=None, d_ff=None, device="cpu"):
    pd = cfg.dtype("param")
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    pre = tuple(shape_prefix)
    scale = d ** -0.5
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "w_gate": normal(gen, pre + (d, f), scale, pd, device),
            "w_up": normal(gen, pre + (d, f), scale, pd, device),
            "w_down": normal(gen, pre + (f, d), f ** -0.5, pd, device),
        }
    return {
        "w_in": normal(gen, pre + (d, f), scale, pd, device),
        "w_down": normal(gen, pre + (f, d), f ** -0.5, pd, device),
    }


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_ffn(cfg: ModelConfig, p, x):
    """The FFN; ``p`` a ``tensor_parallel.Split``: column-parallel
    ``w_gate``/``w_up``/``w_in``, row-parallel ``w_down`` on each model
    rank, the ranks' outputs summed."""
    if isinstance(p, tp.Split):
        outs = tp.run(p.group, p.parts,
                      lambda m, q, xm: apply_ffn(cfg, q, xm), x)
        return tp.reduce(p.group, [o[0] for o in outs])
    cd = cfg.dtype("compute")
    x = x.to(cd)
    if cfg.activation in ("swiglu", "geglu"):
        g = torch.einsum("...d,df->...f", x, p["w_gate"].to(cd))
        u = torch.einsum("...d,df->...f", x, p["w_up"].to(cd))
        act = F.silu if cfg.activation == "swiglu" else gelu
        h = act(g) * u
    else:
        h = torch.einsum("...d,df->...f", x, p["w_in"].to(cd))
        h = gelu(h) if cfg.activation == "gelu" else torch.square(F.relu(h))
    return torch.einsum("...f,fd->...d", h, p["w_down"].to(cd))


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------
def init_embed(cfg: ModelConfig, gen: torch.Generator, device="cpu"):
    pd = cfg.dtype("param")
    s = cfg.d_model ** -0.5
    p = {"embed": normal(gen, (cfg.vocab_size, cfg.d_model), s, pd, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal(gen, (cfg.d_model, cfg.vocab_size), s, pd,
                              device)
    return p


def embed_tokens(cfg: ModelConfig, p, tokens):
    """Rows of ``p["embed"]``; split by rows over the model ranks, each
    rank looks up its vocabulary range, writes zeros elsewhere, and the
    ranks' rows are summed (one nonzero term: exact)."""
    e = p["embed"]
    if isinstance(e, tp.Split):
        return tp.reduce(e.group, [o[0] for o in tp.run(
            e.group, e.parts, lambda m, blk: _embed_rows(cfg, blk, tokens,
                                                         m))])
    return e[tokens.long()].to(cfg.dtype("compute"))


def _embed_rows(cfg: ModelConfig, blk, tokens, m: int):
    v = blk.shape[0]
    t = tokens.to(blk.device).long() - m * v
    inside = (t >= 0) & (t < v)
    rows = blk[t.clamp(0, v - 1)]
    return torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device)
                       ).to(cfg.dtype("compute"))


def lm_logits(cfg: ModelConfig, p, x):
    """The logits; with the head split over the model ranks (columns of
    ``lm_head`` or rows of the tied ``embed``), a
    ``tensor_parallel.VocabShards`` of each rank's columns
    (``tensor_parallel.gathered`` makes them whole)."""
    cd = cfg.dtype("compute")
    w = p["embed"] if cfg.tie_embeddings else p["lm_head"]
    if isinstance(w, tp.Split):
        outs = tp.run(w.group, w.parts, lambda m, blk, xm: torch.einsum(
            "...d,dv->...v", xm.to(cd), (blk.T if cfg.tie_embeddings
                                         else blk).to(cd)
        ).to(cfg.dtype("logit")), x)
        return tp.VocabShards(w.group, [o[0] for o in outs])
    w = (w.T if cfg.tie_embeddings else w).to(cd)
    return torch.einsum("...d,dv->...v", x.to(cd), w).to(cfg.dtype("logit"))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def softmax_xent(logits, labels, *, z_loss: float = 1e-4):
    """Token-mean cross entropy (f32 accumulation) + z-loss regularizer.
    ``logits`` a ``tensor_parallel.VocabShards``: vocabulary-parallel,
    the max, the sum of exponentials and the target's logit each
    reduced over the model ranks in rank order."""
    if isinstance(logits, tp.VocabShards):
        return _split_xent(logits, labels, z_loss)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def _split_xent(logits, labels, z_loss: float):
    g = logits.group
    f32 = torch.float32
    maxes = []
    for rank, part in zip(g.ranks, logits.parts):
        with collectives.on_rank(rank):
            maxes.append(part.detach().to(f32).amax(dim=-1))
    top = collectives.model_max(maxes, g.ranks)

    def local(m, _, part):
        lf = part.to(f32)
        v = lf.shape[-1]
        se = torch.exp(lf - top.to(lf.device)[..., None]).sum(dim=-1)
        t = labels.to(lf.device).long() - m * v
        inside = (t >= 0) & (t < v)
        ll = torch.gather(lf, -1, t.clamp(0, v - 1)[..., None])[..., 0]
        return se, torch.where(inside, ll, torch.zeros((), dtype=f32,
                                                       device=lf.device))

    outs = tp.run(g, None, local, list(logits.parts))
    lse = torch.log(tp.reduce(g, [o[0] for o in outs])) + top
    loss = torch.mean(lse - tp.reduce(g, [o[1] for o in outs]))
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(cfg: ModelConfig, positions):
    """positions: (...,) integer -> cos/sin (..., rot_dim/2)."""
    rot = cfg.head_dim if cfg.rope_style == "full" else cfg.head_dim // 2
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, rot, 2, dtype=torch.float32, device=positions.device) / rot))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(cfg: ModelConfig, x, cos, sin):
    """x: (B, S, H, Dh); cos/sin: (B, S, rot/2) or (S, rot/2)."""
    if cfg.rope_style == "none":
        return x
    rot = cfg.head_dim if cfg.rope_style == "full" else cfg.head_dim // 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    while cos.dim() < x1.dim():  # broadcast over head axis
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(
        xr.shape[:-1] + (rot,))
    return torch.cat([out, xp.to(out.dtype)], dim=-1) \
        if rot < cfg.head_dim else out


# ---------------------------------------------------------------------------
# CNN block
# ---------------------------------------------------------------------------


def init_cnn_block(generator, cin: int, cout: int, k: int = 3,
                   dtype=torch.float32, device=None):
    """``{"w": (k, k, cin, cout)}`` with N(0, 1/(k*k*cin)) entries, drawn
    on the CPU from ``generator`` (a ``torch.Generator`` or a seed) and
    moved to ``device``, so a seed gives the same weights on every
    device."""
    from repro_torch.models.frontends import resolve_device
    scale = (k * k * cin) ** -0.5
    w = torch.randn((k, k, cin, cout), generator=_generator(generator)) * scale
    return {"w": w.to(dtype=dtype, device=resolve_device(device))}


def _conv_dtype(x_dtype, w_dtype) -> str:
    both_int = is_integer_dtype(x_dtype) and is_integer_dtype(w_dtype)
    return "int32" if both_int else "float32"


def cnn_block_site_specs(x_shape, w_shape, *, x_dtype, w_dtype=None,
                         pool_window=(2, 2), pool_stride=None,
                         pool_mode: str = "max", activation: str = "relu",
                         site: str = "cnn_block", ladder=()):
    """Declarative op sites of one conv -> pool -> act block, with the
    intermediate shapes and dtypes from shape arithmetic (the family
    oracles' rules): conv (n, h-kh+1, w-kw+1, cout), int32 only when both
    operands are integer; then ``pool_dtypes``; then an activation that
    keeps a float dtype and turns integer into float32.  Returns
    ``(specs, (out_shape, out_dtype))`` so a caller can chain blocks into
    one whole-network plan (see models/frontends.py)."""
    x_shape, w_shape = tuple(x_shape), tuple(w_shape)
    n, h, w, _ = x_shape
    kh, kw, _, cout = w_shape
    conv_shape = (n, h - kh + 1, w - kw + 1, cout)
    conv_dtype = _conv_dtype(x_dtype, w_dtype or x_dtype)
    window, stride = check_pool_geometry(conv_shape, pool_window,
                                         pool_stride)
    # the reference's oracles refuse these at spec time, in this order
    if pool_mode not in MODES:
        raise ValueError(f"unknown pool mode {pool_mode!r}")
    if activation not in KINDS:
        raise ValueError(f"unknown activation {activation!r}; have {KINDS}")
    pool_shape = pool2d_out_shape(conv_shape, window, stride)
    pool_dtype = (conv_dtype if pool_mode == "max"
                  else ("int32" if is_integer_dtype(conv_dtype)
                        else "float32"))
    act_dtype = "float32" if is_integer_dtype(pool_dtype) else pool_dtype
    specs = [
        SiteSpec.make(f"{site}.conv", "conv2d", (x_shape, w_shape),
                      x_dtype, ladder=ladder, dual=False),
        SiteSpec.make(f"{site}.pool", "pool2d", (conv_shape,),
                      conv_dtype, ladder=ladder, window=pool_window,
                      stride=pool_stride, mode=pool_mode),
        SiteSpec.make(f"{site}.act", "activation", (pool_shape,),
                      pool_dtype, ladder=ladder, kind=activation),
    ]
    return specs, (pool_shape, dtype_name(act_dtype))


def _apply_fused_site(fused_s, p, x, *, pool_window, pool_stride, pool_mode,
                      activation, plan, quant_report, tile_overrides):
    """Execute one planned fused site: the whole conv -> pool -> act
    chain in a single launch.  The lowered rungs run the quantized fused
    block (int8: in-register rescale of the int32 accumulator);
    ``quant_report`` measures the one fused output against the composite
    family oracle."""
    if plan is not None:
        plan[fused_s.spec.name] = (fused_s.ip, fused_s.footprint)
    if fused_s.lowered:
        from repro_torch.quant.ops import quantized_fused_cnn_block
        y = quantized_fused_cnn_block(
            x, p["w"], pool_window=pool_window, pool_stride=pool_stride,
            pool_mode=pool_mode, activation=activation,
            bits=fused_s.precision_bits, ip=fused_s.ip.name)
    else:
        from repro_torch.kernels.fused.ops import fused_cnn_block
        tile_kwargs = dict((tile_overrides or {}).get(fused_s.spec.name, {}))
        y = fused_cnn_block(x, p["w"], pool_window=pool_window,
                            pool_stride=pool_stride, pool_mode=pool_mode,
                            activation=activation, ip=fused_s.ip.name,
                            **tile_kwargs)
    if quant_report is not None:
        from repro_torch.core.library import get_family
        from repro_torch.quant.report import record
        ref = get_family("cnn_fused").reference(
            x.to(torch.float32), p["w"].to(torch.float32),
            window=pool_window, stride=pool_stride, mode=pool_mode,
            kind=activation)
        record(quant_report, fused_s.spec.name, fused_s.precision_bits,
               y, ref)
    return y


def apply_cnn_block(p, x, *, budget=None, pool_window=(2, 2),
                    pool_stride=None, pool_mode: str = "max",
                    activation: str = "relu", plan=None,
                    site: str = "cnn_block", network=None, ladder=(),
                    quant_report=None, tile_overrides=None,
                    fuse: bool = True):
    """One adaptive CNN layer: conv -> pool -> activation.

    The three sites are planned as one ``NetworkPlan`` under a
    partitioned ``budget`` (memoized), then each stage runs its planned
    member.  Pass ``network`` (a NetworkPlan containing this block's
    sites, e.g. one spanning a whole frontend) to execute from an outer
    plan instead.  When ``plan`` (a dict) is passed, the (KernelIP,
    Footprint) decisions are recorded under the site names.

    ``fuse`` (default True) plans fusion-aware: when the planner maps
    this block onto a single fused site (``<site>.fused``) the whole
    chain runs as ONE launch; a supplied ``network`` containing
    ``<site>.fused`` runs fused regardless of ``fuse``.

    **Mixed precision.** With a ``ladder`` the planner may lower any
    site's operand width; execution inserts quantize/dequantize
    boundaries only where adjacent sites disagree: an int8 conv feeds
    its requantized codes straight into an int8 pool, and an int8 relu
    runs on the codes (relu commutes with the positive scale), so a
    fully lowered block dequantizes once, at its egress.
    ``quant_report`` (a dict) receives a ``SiteQuantReport`` per site:
    the relative error against the family oracles in float32.  The
    oracles measure; they never supply a served output.

    ``tile_overrides`` maps site name -> tiling kwargs for that site's
    kernel call; only full-precision sites honor them.
    """
    from repro_torch.core.plan import plan_network
    from repro_torch.kernels.activation.ops import activation as activation_op
    from repro_torch.kernels.conv2d.ops import conv2d
    from repro_torch.kernels.pool2d.ops import pool2d

    specs, _ = cnn_block_site_specs(
        x.shape, p["w"].shape, x_dtype=x.dtype, w_dtype=p["w"].dtype,
        pool_window=pool_window, pool_stride=pool_stride,
        pool_mode=pool_mode, activation=activation, site=site,
        ladder=ladder)
    if network is None:
        network = plan_network(specs, budget, fuse=fuse)
    else:
        # An outer plan was built from its own view of the graph; its
        # feasibility guarantees are void if that view disagrees with
        # this call's actual shapes/dtypes/knobs.
        from repro_torch.core.library import get_family
        fused_view = get_family("cnn_fused").fuse_sites(tuple(specs))
        if f"{site}.fused" in network and fused_view is None:
            raise ValueError(
                f"plan/site mismatch at '{site}.fused': the supplied "
                f"network fused this block, but this call's sites "
                f"{[s.name for s in specs]} are not fusable")
        check = ([fused_view] if f"{site}.fused" in network else specs)
        for spec in check:
            planned = network.site(spec.name).spec
            if planned != spec:
                raise ValueError(
                    f"plan/site mismatch at {spec.name!r}: the supplied "
                    f"network was planned for {planned}, but this call "
                    f"executes {spec}")

    if f"{site}.fused" in network:
        return _apply_fused_site(
            network.site(f"{site}.fused"), p, x, pool_window=pool_window,
            pool_stride=pool_stride, pool_mode=pool_mode,
            activation=activation, plan=plan, quant_report=quant_report,
            tile_overrides=tile_overrides)

    conv_s, pool_s, act_s = (network.site(f"{site}.{part}")
                             for part in ("conv", "pool", "act"))
    if plan is not None:
        for s in (conv_s, pool_s, act_s):
            plan[s.spec.name] = (s.ip, s.footprint)

    def tiles(s):
        return dict((tile_overrides or {}).get(s.spec.name, {}))

    if quant_report is not None:
        from repro_torch.kernels.activation.ref import activation_ref
        from repro_torch.kernels.conv2d.ref import conv2d_ref
        from repro_torch.kernels.pool2d.ref import pool2d_ref
        from repro_torch.quant.report import record
        ref = conv2d_ref(x.to(torch.float32), p["w"].to(torch.float32))

    # qscale is not None  <=>  y holds fixed-point codes (or an integer
    # accumulator) whose real value is y * qscale.
    qscale = None

    # -- conv ---------------------------------------------------------------
    if conv_s.lowered:
        from repro_torch.quant.ops import quantized_conv2d
        # int8 returns the raw accumulator + scale (the dequantize fuses
        # into the next stage); 16-bit fake-quant returns (float, None).
        y, qscale = quantized_conv2d(x, p["w"], bits=conv_s.precision_bits,
                                     ip=conv_s.ip.name, return_scale=True)
    else:
        y = conv2d(x, p["w"], ip=conv_s.ip.name, **tiles(conv_s))
    if quant_report is not None:
        got = y if qscale is None else y.to(torch.float32) * qscale
        record(quant_report, conv_s.spec.name, conv_s.precision_bits,
               got, ref)

    # -- pool ---------------------------------------------------------------
    if qscale is not None and pool_s.precision_bits == 8 and pool_s.lowered:
        # Adjacent int8 sites: requantize the int32 accumulator to int8
        # codes (the fixed-point interlayer step) and pool the codes.
        from repro_torch.quant.quantize import quantize_acts
        yq = quantize_acts(y.to(torch.float32) * qscale, bits=8)
        y = pool2d(yq.q, window=pool_window, stride=pool_stride,
                   mode=pool_mode, ip=pool_s.ip.name)
        qscale = yq.scale
    else:
        if qscale is not None:      # widths disagree: dequantize boundary
            y = y.to(torch.float32) * qscale
            qscale = None
        if pool_s.lowered:
            from repro_torch.quant.ops import quantized_pool2d
            y = quantized_pool2d(y, window=pool_window, stride=pool_stride,
                                 mode=pool_mode,
                                 bits=pool_s.precision_bits,
                                 ip=pool_s.ip.name)
        else:
            y = pool2d(y, window=pool_window, stride=pool_stride,
                       mode=pool_mode, ip=pool_s.ip.name, **tiles(pool_s))
    if quant_report is not None:
        ref = pool2d_ref(ref, window=pool_window, stride=pool_stride,
                         mode=pool_mode)
        got = y if qscale is None else y.to(torch.float32) * qscale
        record(quant_report, pool_s.spec.name, pool_s.precision_bits,
               got, ref)

    # -- activation ---------------------------------------------------------
    if (qscale is not None and act_s.lowered and activation == "relu"
            and act_s.precision_bits == pool_s.precision_bits):
        # relu(q * s) == relu(q) * s for s > 0: the activation runs on
        # the codes and the whole lowered chain dequantizes once, here.
        y = activation_op(y, kind="relu", ip=act_s.ip.name) * qscale
        qscale = None
    else:
        if qscale is not None:
            y = y.to(torch.float32) * qscale
            qscale = None
        if act_s.lowered:
            from repro_torch.quant.ops import quantized_activation
            y = quantized_activation(y, kind=activation,
                                     bits=act_s.precision_bits,
                                     ip=act_s.ip.name)
        else:
            y = activation_op(y, kind=activation, ip=act_s.ip.name,
                              **tiles(act_s))
    if quant_report is not None:
        record(quant_report, act_s.spec.name, act_s.precision_bits, y,
               activation_ref(ref, kind=activation))
    return y
