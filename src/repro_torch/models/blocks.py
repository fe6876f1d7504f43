"""CNN block — conv -> pool -> activation, planned as one NetworkPlan: the
three sites share ONE ResourceBudget partitioned across them (the paper's
full-layer scenario: a CNN layer whose implementation adapts to the
available resources while its math stays fixed).

The LM-side blocks of ``repro.models.blocks`` (norms, FFN, embeddings,
RoPE, loss) are ROADMAP queue 1, item 12.
"""
from __future__ import annotations

import torch

from repro_torch.core.ip import SiteSpec, dtype_name, is_integer_dtype
from repro_torch.kernels.pool2d.ref import (check_pool_geometry,
                                            pool2d_out_shape)

QUANT_NOT_PORTED = ("quantized execution (precision ladder, quant_report) "
                    "is not ported yet (ROADMAP queue 1, item 4)")


def _generator(seed_or_generator) -> torch.Generator:
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator().manual_seed(int(seed_or_generator))


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
                      activation, plan, tile_overrides):
    """Execute one planned fused site: the whole conv -> pool -> act
    chain in a single launch."""
    if fused_s.lowered:
        raise NotImplementedError(QUANT_NOT_PORTED)
    if plan is not None:
        plan[fused_s.spec.name] = (fused_s.ip, fused_s.footprint)
    from repro_torch.kernels.fused.ops import fused_cnn_block
    tile_kwargs = dict((tile_overrides or {}).get(fused_s.spec.name, {}))
    return fused_cnn_block(x, p["w"], pool_window=pool_window,
                           pool_stride=pool_stride, pool_mode=pool_mode,
                           activation=activation, ip=fused_s.ip.name,
                           **tile_kwargs)


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

    ``tile_overrides`` maps site name -> tiling kwargs for that site's
    kernel call.  A plan the precision ladder lowered, and
    ``quant_report``, raise ``NotImplementedError`` (ROADMAP queue 1,
    item 4).
    """
    from repro_torch.core.plan import plan_network
    from repro_torch.kernels.activation.ops import activation as activation_op
    from repro_torch.kernels.conv2d.ops import conv2d
    from repro_torch.kernels.pool2d.ops import pool2d

    if quant_report is not None:
        raise NotImplementedError(QUANT_NOT_PORTED)
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
            activation=activation, plan=plan,
            tile_overrides=tile_overrides)

    sites = [network.site(f"{site}.{part}") for part in ("conv", "pool",
                                                          "act")]
    if any(s.lowered for s in sites):
        raise NotImplementedError(QUANT_NOT_PORTED)
    conv_s, pool_s, act_s = sites
    if plan is not None:
        for s in sites:
            plan[s.spec.name] = (s.ip, s.footprint)

    def tiles(s):
        return dict((tile_overrides or {}).get(s.spec.name, {}))

    y = conv2d(x, p["w"], ip=conv_s.ip.name, **tiles(conv_s))
    y = pool2d(y, window=pool_window, stride=pool_stride, mode=pool_mode,
               ip=pool_s.ip.name, **tiles(pool_s))
    return activation_op(y, kind=activation, ip=act_s.ip.name,
                         **tiles(act_s))
