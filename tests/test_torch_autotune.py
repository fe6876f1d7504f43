"""The port's block-shape autotuner (``repro_torch.core.autotune``)
against the reference's (``repro.core.autotune``): every case of the
reference's ``tests/test_autotune.py`` on the same inputs through both
packages.  The bars: candidate grids, sweep rankings and tuned results
equal (footprints field for field); ``plan_tile_overrides`` equal for
the same plan; ``apply_cnn_block`` with overrides within ``rtol=1e-4,
atol=1e-5`` of the reference and bitwise its own no-override run."""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import autotune as j_tune
from repro.core import plan as j_plan
from repro.core.ip import SiteSpec as JSpec
from repro.core.resources import ResourceBudget as JBudget
from repro.kernels.attention import flash as j_flash
from repro.kernels.fused import cnn_block as j_fused
from repro.kernels.matmul import mxu as j_mxu
from repro_torch.core import autotune as t_tune
from repro_torch.core import calibrate_cost as t_cal
from repro_torch.core import plan as t_plan
from repro_torch.core.ip import SiteSpec as TSpec
from repro_torch.core.resources import MXU_DIM
from repro_torch.core.resources import ResourceBudget as TBudget
from repro_torch.kernels.attention import flash as t_flash
from repro_torch.kernels.fused import cnn_block as t_fused
from repro_torch.kernels.matmul import mxu as t_mxu

J = types.SimpleNamespace(tune=j_tune, plan=j_plan, Spec=JSpec,
                          Budget=JBudget, mxu=j_mxu, flash=j_flash,
                          fused=j_fused)
T = types.SimpleNamespace(tune=t_tune, plan=t_plan, Spec=TSpec,
                          Budget=TBudget, mxu=t_mxu, flash=t_flash,
                          fused=t_fused)


def both(fn):
    return fn(J), fn(T)


def _res(r):
    """A TuneResult as plain data."""
    return (r.params, dataclasses.asdict(r.footprint), r.est_cycles,
            r.measured_us)


# --------------------------------------------------------------------------
# Aligned-candidate generation
# --------------------------------------------------------------------------
@pytest.mark.parametrize("lo,hi,align,want", [
    (128, 1024, 128, [128, 256, 512, 1024]),
    (128, 1000, 128, [128, 256, 512]),
    (256, 1024, 128, [256, 512, 1024])])
def test_aligned_doubles_within_range(lo, hi, align, want):
    assert t_tune._aligned(lo, hi, align) == \
        j_tune._aligned(lo, hi, align) == want


@pytest.mark.parametrize("lo,hi", [(256, 200), (1, 64)])
def test_aligned_falls_back_to_alignment_when_range_is_empty(lo, hi):
    assert t_tune._aligned(lo, hi, 128) == j_tune._aligned(lo, hi, 128) \
        == [128]


def test_aligned_candidates_are_multiples_of_alignment():
    for lo, hi in [(128, 4096), (8, 512), (128, 100)]:
        got = t_tune._aligned(lo, hi, MXU_DIM)
        assert got == j_tune._aligned(lo, hi, MXU_DIM)
        assert all(v % MXU_DIM == 0 for v in got)


# --------------------------------------------------------------------------
# Sweep: feasibility gate + est_cycles ranking
# --------------------------------------------------------------------------
def test_sweep_ranks_feasible_tilings_by_est_cycles():
    grid = {"bm": [128, 256], "bn": [128, 256], "bk": [128, 256]}
    jr, tr = both(lambda ns: ns.tune.sweep(
        ns.mxu.footprint_mxu, grid, ns.Budget(), 512, 512, 512, top=8,
        itemsize=2))
    assert [_res(r) for r in tr] == [_res(r) for r in jr]
    assert tr
    cycles = [r.est_cycles for r in tr]
    assert cycles == sorted(cycles)
    for r in tr:
        assert r.footprint.fits(TBudget())
        assert r.est_cycles == r.footprint.est_cycles


def test_sweep_excludes_tilings_that_do_not_fit():
    grid = {"bm": [128, 1024], "bn": [128, 1024], "bk": [128, 1024]}
    jr, tr = both(lambda ns: ns.tune.sweep(
        ns.mxu.footprint_mxu, grid, ns.Budget(vmem_bytes=200 * 1024),
        1024, 1024, 1024, top=100, itemsize=2))
    assert [_res(r) for r in tr] == [_res(r) for r in jr]
    assert tr
    for r in tr:
        assert r.footprint.fits(TBudget(vmem_bytes=200 * 1024))
        assert not (r.params["bm"] == r.params["bn"]
                    == r.params["bk"] == 1024)


def test_sweep_measure_reorders_by_the_stopwatch():
    grid = {"bm": [128, 256], "bn": [128, 256], "bk": [128]}

    def measure(**p):
        return 1000.0 / (p["bm"] * p["bn"])

    jr, tr = both(lambda ns: ns.tune.sweep(
        ns.mxu.footprint_mxu, grid, ns.Budget(), 512, 512, 512, top=3,
        itemsize=2, measure=measure))
    assert [_res(r) for r in tr] == [_res(r) for r in jr]
    assert [r.measured_us for r in tr] == sorted(r.measured_us for r in tr)


# --------------------------------------------------------------------------
# Family entry points
# --------------------------------------------------------------------------
def test_autotune_matmul_respects_tight_vmem():
    def run(ns):
        return (ns.tune.autotune_matmul(1024, 1024, 1024, itemsize=2),
                ns.tune.autotune_matmul(1024, 1024, 1024, itemsize=2,
                                        budget=ns.Budget(
                                            vmem_bytes=200 * 1024)))

    (ja, jt), (ta, tt) = both(run)
    assert (_res(ta), _res(tt)) == (_res(ja), _res(jt))
    assert tt.footprint.fits(TBudget(vmem_bytes=200 * 1024))
    assert tt.footprint.vmem_bytes <= 200 * 1024
    assert ta.est_cycles <= tt.est_cycles


def test_autotune_matmul_infeasible_raises():
    for ns in (J, T):
        with pytest.raises(ValueError, match="no feasible matmul tiling"):
            ns.tune.autotune_matmul(1024, 1024, 1024, itemsize=2,
                                    budget=ns.Budget(vmem_bytes=1024))


def test_autotune_matmul_measure_records_calibration_samples():
    """``measure=True`` with a table times each top candidate (here on
    the CPU's plain version) and records it under ``matmul.mm_mxu``."""
    table = t_cal.CalibrationTable()
    best = t_tune.autotune_matmul(256, 256, 256, itemsize=1, measure=True,
                                  table=table, device="cpu")
    grid = {n: j_tune._aligned(128, 256, 128) for n in ("bm", "bn", "bk")}
    top = j_tune.sweep(j_mxu.footprint_mxu, grid, JBudget(), 256, 256, 256,
                       itemsize=1)
    assert best.measured_us is not None and best.measured_us > 0.0
    assert table.sample_count("matmul.mm_mxu") == len(top) == 3
    assert [(s.compute_cycles, s.hbm_bytes) for s in table.samples] == \
        [(r.footprint.compute_cycles, r.footprint.hbm_bytes) for r in top]
    assert best.params in [r.params for r in top]
    assert best.measured_us == min(s.measured_us for s in table.samples)


@pytest.mark.parametrize("ip,itemsize", [("ip2_mxu", 4), ("ip1_vpu", 4),
                                         ("ip2_mxu", 1), ("other", 2)])
def test_autotune_conv_fits_and_aligns(ip, itemsize):
    jr, tr = both(lambda ns: ns.tune.autotune_conv(
        2, 16, 16, 8, 3, 3, 256, ip=ip, itemsize=itemsize,
        budget=ns.Budget()))
    assert _res(tr) == _res(jr)
    assert tr.params["block_cout"] % 128 == 0
    assert tr.footprint.fits(TBudget())


def test_autotune_flash_fits_budget():
    jr, tr = both(lambda ns: ns.tune.autotune_flash(
        1, 4, 2, 512, 512, 64, itemsize=2, budget=ns.Budget()))
    assert _res(tr) == _res(jr)
    assert set(tr.params) == {"bq", "bk"}
    assert tr.footprint.fits(TBudget())


@pytest.mark.parametrize("ip", ["fused_vpu", "fused_mxu"])
def test_autotune_fused_matches(ip):
    jr, tr = both(lambda ns: ns.tune.autotune_fused(
        2, 18, 18, 8, 3, 3, 200, 2, 2, 2, 2, ip=ip, itemsize=4,
        kind="tanh", budget=ns.Budget()))
    assert _res(tr) == _res(jr)
    for ns in (J, T):
        with pytest.raises(ValueError, match="no feasible fused-block"):
            ns.tune.autotune_fused(2, 18, 18, 8, 3, 3, 200, 2, 2, 2, 2,
                                   ip=ip, budget=ns.Budget(vmem_bytes=64))


# --------------------------------------------------------------------------
# plan_tile_overrides: tuner -> executed plans
# --------------------------------------------------------------------------
def _mixed_specs(ns):
    return [
        ns.Spec.make("net.conv", "conv2d",
                     ((2, 16, 16, 8), (3, 3, 8, 256)), "float32",
                     dual=False),
        ns.Spec.make("net.mm", "matmul", ((512, 512), (512, 512)),
                     "bfloat16", dual=False),
        ns.Spec.make("net.pool", "pool2d", ((2, 14, 14, 256),), "float32",
                     window=(2, 2), mode="max"),
    ]


@pytest.mark.parametrize("budget", [{}, {"vpu_ops_budget": 2_000_000},
                                    {"mxu_available": False}],
                         ids=["ample", "vpu_starved", "no_mxu"])
def test_plan_tile_overrides_covers_tunable_sites_only(budget):
    def run(ns):
        ns.plan.clear_plan_cache()
        plan = ns.plan.plan_network(_mixed_specs(ns), ns.Budget(**budget))
        return plan, ns.tune.plan_tile_overrides(plan)

    (jplan, jover), (tplan, tover) = both(run)
    assert tplan.to_json() == jplan.to_json()
    assert tover == jover
    assert "net.pool" not in tover
    for name, params in tover.items():
        site = tplan.site(name)
        assert site.ip.name.split(".")[-1] in ("ip2_mxu", "mm_mxu")
        assert params
        if site.spec.family == "matmul":
            assert set(params) <= {"bm", "bn", "bk"}
        else:
            assert set(params) == {"block_cout"}
    if "net.mm" in tover:
        from repro_torch.kernels.matmul.ops import matmul
        rng = np.random.default_rng(0)
        a = torch.from_numpy(rng.normal(size=(512, 512)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(512, 512)).astype(np.float32))
        want = matmul(a, b, ip="mm_mxu")
        got = matmul(a, b, ip="mm_mxu", **tover["net.mm"])
        assert torch.equal(got, want)


def test_plan_tile_overrides_skips_lowered_sites():
    def run(ns):
        spec = ns.Spec.make("low.mm", "matmul", ((512, 512), (512, 512)),
                            "float32", ladder=(8,), dual=False)
        for kib in (96, 128, 192, 256, 384):
            ns.plan.clear_plan_cache()
            try:
                cand = ns.plan.plan_network(
                    [spec], ns.Budget(vmem_bytes=kib * 1024))
            except ValueError:
                continue
            if cand.lowered_sites():
                return kib, cand, ns.tune.plan_tile_overrides(cand)
        return None

    jr, tr = both(run)
    assert jr is not None and tr is not None
    assert tr[0] == jr[0] and tr[1].to_json() == jr[1].to_json()
    assert tr[1].site("low.mm").lowered
    assert tr[2] == jr[2] and "low.mm" not in tr[2]


def test_plan_tile_overrides_of_served_frontend_plans():
    """The served frontend's fused and chained plans: the same overrides
    as the reference, for the fused members and Conv2 sites."""
    from repro.models.frontends import cnn_frontend_site_specs as j_specs
    from repro.models.frontends import init_cnn_frontend as j_init
    from repro_torch.models.frontends import cnn_frontend_site_specs as t_specs
    from repro_torch.models.frontends import params_from_numpy
    jp = j_init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    seen = set()
    for fuse, budget in ((True, {}), (False, {"vpu_ops_budget": 400_000}),
                         (True, {"vpu_ops_budget": 400_000})):
        j_plan.clear_plan_cache()
        t_plan.clear_plan_cache()
        jplan = j_plan.plan_network(j_specs(jp, (2, 32, 32, 3), "float32"),
                                    JBudget(**budget), fuse=fuse)
        tplan = t_plan.plan_network(
            t_specs(tp, (2, 32, 32, 3), torch.float32), TBudget(**budget),
            fuse=fuse)
        assert tplan.to_json() == jplan.to_json()
        got = t_tune.plan_tile_overrides(tplan)
        assert got == j_tune.plan_tile_overrides(jplan)
        seen |= {tplan.site(n).ip.name for n in got}
    assert {"cnn_fused.fused_vpu", "conv2d.ip2_mxu"} <= seen


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_cnn_block_executes_with_tile_overrides(rng, fuse):
    """tile_overrides thread through apply_cnn_block to the conv (or
    fused) kernel without changing the result."""
    from repro.models.blocks import apply_cnn_block as j_block
    from repro.models.blocks import init_cnn_block as j_init_block
    from repro_torch.models.blocks import apply_cnn_block as t_block
    jb = j_init_block(jax.random.PRNGKey(0), cin=8, cout=16, k=3)
    tb = {"w": torch.from_numpy(np.array(jb["w"]))}
    xn = rng.normal(size=(2, 12, 12, 8)).astype(np.float32)
    x = torch.from_numpy(xn)
    budget = dict(vpu_ops_budget=200_000)
    site = "cnn_block.fused" if fuse else "cnn_block.conv"
    probe = {}
    base = t_block(tb, x, activation="relu", plan=probe,
                   budget=TBudget(**budget), fuse=fuse)
    assert probe[site][0].name.endswith("mxu")
    over = {site: {"block_cout": 128}}
    y = t_block(tb, x, activation="relu", budget=TBudget(**budget),
                fuse=fuse, tile_overrides=over)
    assert torch.equal(y, base)
    want = j_block(jb, jax.numpy.asarray(xn), activation="relu",
                   budget=JBudget(**budget), fuse=fuse, tile_overrides=over)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
