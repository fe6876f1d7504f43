"""Block-shape autotuning for the kernel IPs.

Replaces ``repro/core/autotune.py``.

The paper sizes each IP to its resource budget by hand; this module
automates the remaining free parameters (the tiling hints ``bm``/``bn``/
``bk``, ``bq``/``bk``, ``block_cout``) the way the planner does
everything else: score candidate tilings against the footprint cost
model (fit -> feasibility; est_cycles -> rank), optionally refined by
wall-clock measurement.

    best = autotune_matmul(m, k, n, budget=ResourceBudget())
    y = mm_mxu(a, b, **best.params)

**Few hints shape the CUDA launches.**  The matmul and attention
kernels validate ``bm``/``bn``/``bk`` and ``bq``/``bk`` and then run
their own CTA tiles (``kernels/matmul/mxu.py``,
``kernels/attention/flash.py``), so a measured sweep on the card
(``autotune_matmul(measure=True)``) times the same launch for every
candidate: it ranks noise.  ``block_cout`` caps the channels a conv or
fused CTA owns (``kernels/conv2d/inner.py::tile_plan``), but the grid
here starts at 128 channels, past every served frontend's width, so
there too every candidate runs one launch.  No hint changes a result.
The sweep is kept for its footprint ranking, which the tuned plans'
feasibility rests on, and as a calibration sample collector
(``table=``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.ip import dtype_itemsize
from repro_torch.core.resources import (LANE, MXU_DIM, SUBLANE, Footprint,
                                        ResourceBudget)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    params: Dict[str, int]
    footprint: Footprint
    est_cycles: float
    measured_us: Optional[float] = None


def _aligned(lo: int, hi: int, align: int) -> List[int]:
    out = []
    v = align
    while v <= hi:
        if v >= lo:
            out.append(v)
        v *= 2
    return out or [align]


def sweep(footprint_fn: Callable[..., Footprint], grid: Dict[str, Sequence[int]],
          budget: ResourceBudget, *fp_args, top: int = 3,
          measure: Optional[Callable[..., float]] = None,
          **fp_kwargs) -> List[TuneResult]:
    """Generic sweep: rank feasible tilings by est_cycles (then VMEM)."""
    names = list(grid)
    results: List[TuneResult] = []
    for combo in itertools.product(*(grid[n] for n in names)):
        params = dict(zip(names, combo))
        fp = footprint_fn(*fp_args, **fp_kwargs, **params)
        if not fp.fits(budget):
            continue
        results.append(TuneResult(params, fp, fp.est_cycles))
    results.sort(key=lambda r: (r.est_cycles, r.footprint.vmem_bytes))
    results = results[:top]
    if measure is not None:
        measured = []
        for r in results:
            us = measure(**r.params)
            measured.append(dataclasses.replace(r, measured_us=us))
        measured.sort(key=lambda r: r.measured_us)
        return measured
    return results


def autotune_matmul(m: int, k: int, n: int, *, itemsize: int = 2,
                    budget: Optional[ResourceBudget] = None,
                    measure: bool = False, table=None,
                    device=None) -> TuneResult:
    """Tile sweep for mm_mxu; MXU-aligned candidates only.

    ``measure=True`` refines the top analytical candidates by wall
    clock (``calibrate_cost.timeit_us`` on seeded int8 operands on
    ``device``, ``None`` = ``cuda``); passing a ``CalibrationTable`` as
    ``table`` additionally records each (footprint, measured us) pair as
    a calibration sample for the ``matmul.mm_mxu`` member — the tuner
    doubles as a sample collector.  On the card every candidate runs
    the same launch (module docstring), so the measured order is noise.
    """
    from repro_torch.kernels.matmul.mxu import footprint_mxu, mm_mxu
    budget = budget or ResourceBudget()
    grid = {"bm": _aligned(MXU_DIM, min(m, 1024), MXU_DIM),
            "bn": _aligned(MXU_DIM, min(n, 1024), MXU_DIM),
            "bk": _aligned(MXU_DIM, min(k, 2048), MXU_DIM)}
    meas = None
    if measure or table is not None:
        import numpy as np
        import torch

        from repro_torch.core.calibrate_cost import timeit_us
        from repro_torch.models.frontends import resolve_device
        dev = resolve_device(device)
        rng = np.random.default_rng(0)
        a = torch.from_numpy(rng.integers(-128, 128, (m, k),
                                          dtype=np.int8)).to(dev)
        b = torch.from_numpy(rng.integers(-128, 128, (k, n),
                                          dtype=np.int8)).to(dev)

        def run(**params):
            us = timeit_us(mm_mxu, a, b, **params)
            if table is not None:
                table.record("matmul.mm_mxu",
                             footprint_mxu(m, k, n, itemsize=itemsize,
                                           **params),
                             us, family="matmul")
            return us

        meas = run
    res = sweep(footprint_mxu, grid, budget, m, k, n, itemsize=itemsize,
                measure=meas)
    if not res:
        raise ValueError(f"no feasible matmul tiling for ({m},{k},{n}) "
                         f"under {budget}")
    return res[0]


def autotune_flash(b: int, hq: int, hkv: int, sq: int, skv: int, d: int, *,
                   itemsize: int = 2,
                   budget: Optional[ResourceBudget] = None) -> TuneResult:
    """Chunk sweep for flash attention (bq, bk)."""
    from repro_torch.kernels.attention.flash import footprint
    budget = budget or ResourceBudget()
    grid = {"bq": _aligned(SUBLANE * 16, min(sq, 2048), 128),
            "bk": _aligned(LANE, min(skv, 4096), 128)}
    res = sweep(footprint, grid, budget, b, hq, hkv, sq, skv, d,
                itemsize=itemsize)
    if not res:
        raise ValueError("no feasible flash tiling")
    return res[0]


def autotune_conv(n: int, h: int, w: int, cin: int, kh: int, kw: int,
                  cout: int, *, ip: str = "ip2_mxu", itemsize: int = 1,
                  budget: Optional[ResourceBudget] = None) -> TuneResult:
    """Cout-block sweep for the conv IPs."""
    import importlib
    mod = importlib.import_module(
        f"repro_torch.kernels.conv2d."
        f"{ip if ip.startswith('ip') else 'ip2_mxu'}")
    budget = budget or ResourceBudget()
    grid = {"block_cout": _aligned(LANE, max(cout, LANE), LANE)}
    res = sweep(mod.footprint, grid, budget, n, h, w, cin, kh, kw, cout,
                itemsize=itemsize)
    if not res:
        raise ValueError("no feasible conv tiling")
    return res[0]


def autotune_fused(n: int, h: int, w: int, cin: int, kh: int, kw: int,
                   cout: int, ph: int, pw: int, sh: int, sw: int, *,
                   ip: str = "fused_mxu", itemsize: int = 1,
                   mode: str = "max", kind: str = "relu",
                   budget: Optional[ResourceBudget] = None) -> TuneResult:
    """Cout-block sweep for the fused conv->pool->act members."""
    from repro_torch.kernels.fused import cnn_block as fused_mod
    fp_fn = (fused_mod.footprint_mxu if ip.endswith("mxu")
             else fused_mod.footprint_vpu)
    budget = budget or ResourceBudget()
    grid = {"block_cout": _aligned(LANE, max(cout, LANE), LANE)}
    res = sweep(fp_fn, grid, budget, n, h, w, cin, kh, kw, cout,
                ph, pw, sh, sw, itemsize=itemsize, mode=mode, kind=kind)
    if not res:
        raise ValueError("no feasible fused-block tiling")
    return res[0]


# ---------------------------------------------------------------------------
# Plan bridge — tile choices for the sites of a NetworkPlan.
# ---------------------------------------------------------------------------
# Families/members with sweepable tiling parameters; everything else in a
# plan runs its member's built-in defaults.
_TUNABLE = {("conv2d", "ip2_mxu"), ("matmul", "mm_mxu"),
            ("cnn_fused", "fused_vpu"), ("cnn_fused", "fused_mxu")}


def plan_tile_overrides(plan) -> Dict[str, Dict[str, int]]:
    """Autotuned tiling parameters for the tunable sites of a
    ``NetworkPlan`` — the bridge from the tuner to executed plans.

    Returns ``{site_name: tiling_kwargs}`` suitable for the
    ``tile_overrides=`` parameter of ``apply_cnn_block`` /
    ``apply_cnn_frontend`` (the serving runtime threads it through when
    its ``autotune=`` flag is on).  Each site is tuned against the slice
    of the plan's budget the partitioner granted it, so a tuned tiling
    can never outgrow the envelope the plan certified.  Lowered sites
    keep their quantized wrappers' defaults, and a site whose sweep
    finds no feasible tiling is skipped — its member's default already
    passed the selector's feasibility check.
    """
    out: Dict[str, Dict[str, int]] = {}
    for site in plan.sites:
        short = site.ip.name.split(".")[-1]
        if site.lowered or (site.spec.family, short) not in _TUNABLE:
            continue
        sub = plan.budget.scaled(site.fraction)
        itemsize = dtype_itemsize(site.spec.dtype)
        try:
            if site.spec.family == "conv2d":
                x_shape, w_shape = site.spec.shapes
                n, h, w = x_shape[0], x_shape[1], x_shape[2]
                kh, kw, cin, cout = w_shape
                res = autotune_conv(n, h, w, cin, kh, kw, cout, ip=short,
                                    itemsize=itemsize, budget=sub)
            elif site.spec.family == "cnn_fused":
                from repro_torch.kernels.pool2d.ref import check_pool_geometry
                x_shape, w_shape = site.spec.shapes
                n, h, w = x_shape[0], x_shape[1], x_shape[2]
                kh, kw, cin, cout = w_shape
                (ph, pw), (sh, sw) = check_pool_geometry(
                    (n, h - kh + 1, w - kw + 1, cout),
                    site.spec.knob("window", (2, 2)),
                    site.spec.knob("stride"))
                res = autotune_fused(
                    n, h, w, cin, kh, kw, cout, ph, pw, sh, sw, ip=short,
                    itemsize=itemsize, mode=site.spec.knob("mode", "max"),
                    kind=site.spec.knob("kind", "relu"), budget=sub)
            else:
                a_shape, b_shape = site.spec.shapes
                res = autotune_matmul(a_shape[-2], a_shape[-1], b_shape[-1],
                                      itemsize=itemsize, budget=sub)
        except ValueError:
            continue
        out[site.spec.name] = dict(res.params)
    return out
