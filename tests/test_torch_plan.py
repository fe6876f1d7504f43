"""The port's planner (``repro_torch.core``) against the reference's
(``repro.core``): for the CNN frontend's site specs, the port's
``plan_network(...).to_json()`` must equal the reference's byte for
byte — members, fractions, est-cycles, footprints, the budget block and
the decision audit."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import calibrate_cost as j_calibrate_cost
from repro.core import library as j_library
from repro.core import plan as j_plan
from repro.core import resources as j_resources
from repro.core.ip import SiteSpec as JSiteSpec
from repro.core.resources import ResourceBudget as JBudget
from repro.models.frontends import cnn_frontend_site_specs as j_specs
from repro.models.frontends import init_cnn_frontend as j_init
from repro_torch.core import calibrate_cost as t_calibrate_cost
from repro_torch.core import library as t_library
from repro_torch.core import plan as t_plan
from repro_torch.core import resources as t_resources
from repro_torch.core.ip import SiteSpec as TSiteSpec
from repro_torch.core.resources import MeshSpec
from repro_torch.core.resources import ResourceBudget as TBudget
from repro_torch.models.frontends import cnn_frontend_site_specs as t_specs
from repro_torch.models.frontends import params_from_numpy

IMAGES = [(1, 224, 224, 3), (4, 224, 224, 3), (2, 32, 32, 3)]
IMAGE_IDS = ["1x224", "4x224", "2x32"]
BUDGETS = {"default": {}, "logic_only": {"mxu_available": False},
           "vmem_2MiB": {"vmem_bytes": 2 * 2**20},
           "vpu_capped": {"vpu_ops_budget": 50_000_000}}


@pytest.fixture(scope="module")
def frontends():
    p = j_init(jax.random.PRNGKey(0))      # channels (3, 16, 32), d 64
    pn = jax.tree_util.tree_map(np.asarray, p)
    return p, params_from_numpy(pn, "cpu")


def _clear():
    j_plan.clear_plan_cache()
    t_plan.clear_plan_cache()


def _plans(frontends, shape, budget_kw, fuse, **spec_kw):
    jp, tp = frontends
    _clear()
    try:
        want = j_plan.plan_network(j_specs(jp, shape, "float32", **spec_kw),
                                   JBudget(**budget_kw), fuse=fuse)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_plan.plan_network(t_specs(tp, shape, torch.float32, **spec_kw),
                                TBudget(**budget_kw), fuse=fuse)
        assert str(got.value) == str(e)
        return None, None
    got = t_plan.plan_network(t_specs(tp, shape, torch.float32, **spec_kw),
                              TBudget(**budget_kw), fuse=fuse)
    return want, got


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("shape", IMAGES, ids=IMAGE_IDS)
def test_frontend_plan_json_byte_equal(frontends, shape, budget, fuse):
    want, got = _plans(frontends, shape, BUDGETS[budget], fuse)
    if want is None:
        return                      # both raised the same named error
    assert got.to_json() == want.to_json()
    assert got.describe() == want.describe()
    assert got.explain() == want.explain()


def test_served_plans_are_the_issue_table(frontends):
    """At 224x224x3, batch 1 and 4: fused -> fused_vpu + fused_mxu (2
    launches); unfused -> 6 launches; logic-only -> fused_vpu twice."""
    for n in (1, 4):
        shape = (n, 224, 224, 3)
        _, fused = _plans(frontends, shape, {}, True)
        assert [s.ip.name for s in fused.sites] == [
            "cnn_fused.fused_vpu", "cnn_fused.fused_mxu"]
        assert fused.total_launches == 2
        _, chain = _plans(frontends, shape, {}, False)
        assert [s.ip.name.split(".")[1] for s in chain.sites] == [
            "ip1_vpu", "pool_vpu", "act_vpu",
            "ip2_mxu", "pool_vpu", "act_vpu"]
        _, logic = _plans(frontends, shape, {"mxu_available": False}, True)
        assert [s.ip.name for s in logic.sites] == ["cnn_fused.fused_vpu"] * 2


@pytest.fixture
def inflated_fused():
    """Inflate both packages' fused footprints to ``vmem`` bytes (the
    reference's own fallback-test technique), restoring them after."""
    members = ([j_library.CNN_FUSED.members[n]
                for n in sorted(j_library.CNN_FUSED.members)]
               + [t_library.CNN_FUSED.members[n]
                  for n in sorted(t_library.CNN_FUSED.members)])
    originals = [m.footprint_fn for m in members]

    def inflate(vmem):
        for m, fn in zip(members, originals):
            def wrapped(*a, _fn=fn, **kw):
                return dataclasses.replace(_fn(*a, **kw), vmem_bytes=vmem)
            object.__setattr__(m, "footprint_fn", wrapped)

    yield inflate
    for m, fn in zip(members, originals):
        object.__setattr__(m, "footprint_fn", fn)
    _clear()


def test_vmem_tight_budget_forces_the_unfused_chain(frontends,
                                                    inflated_fused):
    """A fused footprint larger than the VMEM budget: fusion is rejected
    at full budget and both planners settle on the six-site chain."""
    inflated_fused(3 * 2**20)
    want, got = _plans(frontends, (2, 32, 32, 3),
                       {"vmem_bytes": 2 * 2**20}, True)
    assert got.to_json() == want.to_json()
    assert all(s.spec.family != "cnn_fused" for s in got.sites)
    assert any("fusion rejected" in e for e in got.audit.events)


def test_partition_fallback_unfuses_one_group(frontends, inflated_fused):
    """Each fused group fits alone but two cannot share the envelope:
    both planners unfuse one group and keep the other fused."""
    inflated_fused(120 * 1024)
    before = t_plan.planner_stats().fused_fallbacks
    want, got = _plans(frontends, (2, 32, 32, 3),
                       {"vmem_bytes": 220 * 1024}, True)
    assert got.to_json() == want.to_json()
    assert [s.spec.family for s in got.sites].count("cnn_fused") == 1
    assert t_plan.planner_stats().fused_fallbacks > before


@pytest.mark.parametrize("shape", IMAGES, ids=IMAGE_IDS)
def test_network_min_fraction_equal(frontends, shape):
    jp, tp = frontends
    for kw in BUDGETS.values():
        assert t_plan.network_min_fraction(
            t_specs(tp, shape, torch.float32), TBudget(**kw)) == \
            j_plan.network_min_fraction(j_specs(jp, shape, "float32"),
                                        JBudget(**kw))


def test_replan_fast_path_matches_reference(frontends):
    """The serving re-plan fast path (memoized shares) lands on the same
    plans, byte for byte, and counts the same fast replans."""
    jp, tp = frontends
    js = tuple(j_specs(jp, (4, 64, 64, 3), "float32"))
    ts = tuple(t_specs(tp, (4, 64, 64, 3), torch.float32))
    _clear()
    j_plan.plan_network(js, JBudget())
    t_plan.plan_network(ts, TBudget())
    j0, t0 = j_plan.STATS.replan_fast, t_plan.STATS.replan_fast
    for frac in (0.9, 0.5, 0.3):
        want = j_plan.replan(js, JBudget().scaled(frac))
        got = t_plan.replan(ts, TBudget().scaled(frac))
        assert got.to_json() == want.to_json()
    assert t_plan.STATS.replan_fast - t0 == j_plan.STATS.replan_fast - j0


def test_plan_json_round_trips(frontends):
    _, tp = frontends
    _clear()
    plan = t_plan.plan_network(t_specs(tp, (2, 32, 32, 3), torch.float32))
    back = t_plan.NetworkPlan.from_json(plan.to_json())
    assert back == plan and back.to_json() == plan.to_json()


@pytest.mark.parametrize("dtype", [torch.float32, np.float32, "float32",
                                   float, torch.int8, np.int8, "int8",
                                   torch.bfloat16, "bfloat16", torch.int32])
def test_sitespec_dtype_names_match_reference(dtype):
    import jax.numpy as jnp
    ref_dtype = {torch.float32: "float32", torch.int8: "int8",
                 torch.bfloat16: jnp.bfloat16,
                 torch.int32: "int32"}.get(dtype, dtype)
    want = JSiteSpec.make("s", "conv2d", ((1, 4, 4, 1), (3, 3, 1, 2)),
                          ref_dtype, dual=False)
    got = TSiteSpec.make("s", "conv2d", ((1, 4, 4, 1), (3, 3, 1, 2)),
                         dtype, dual=False)
    assert got.to_dict() == want.to_dict()
    assert got.native_bits == want.native_bits


def test_select_ip_and_plan_single_match_reference():
    for dtype, kw in (("float32", {}), ("float32", {"mxu_available": False}),
                      ("int8", {"precision_bits": 8})):
        js = JSiteSpec.make("c", "conv2d", ((2, 16, 16, 4), (3, 3, 4, 8)),
                            dtype, dual=False)
        ts = TSiteSpec.make("c", "conv2d", ((2, 16, 16, 4), (3, 3, 4, 8)),
                            dtype, dual=False)
        jip, jfp = j_plan.select_ip("conv2d", js, JBudget(**kw),
                                    with_footprint=True)
        tip, tfp = t_plan.select_ip("conv2d", ts, TBudget(**kw),
                                    with_footprint=True)
        assert tip.name == jip.name
        assert dataclasses.asdict(tfp) == dataclasses.asdict(jfp)
        assert t_plan.plan_single(ts, TBudget(**kw)).ip.name == \
            j_plan.plan_single(js, JBudget(**kw)).ip.name


def test_dual_sites_plan_the_packed_members():
    """Dual-stream sites are never built on the served path, but they
    plan (over ip3/ip4 footprints) exactly as in the reference."""
    for dtype, kw in (("int8", {"precision_bits": 8}), ("float32", {})):
        js = JSiteSpec.make("d", "conv2d", ((2, 16, 16, 4), (3, 3, 4, 8)),
                            dtype, dual=True)
        ts = TSiteSpec.make("d", "conv2d", ((2, 16, 16, 4), (3, 3, 4, 8)),
                            dtype, dual=True)
        _clear()
        assert t_plan.plan_network([ts], TBudget(**kw)).to_json() == \
            j_plan.plan_network([js], JBudget(**kw)).to_json()


def _cal_fp(cal, compute, hbm):
    """A footprint of ``cal``'s package with analytical axes (compute,
    hbm)."""
    res = j_resources if cal is j_calibrate_cost else t_resources
    return res.Footprint(vmem_bytes=1024, hbm_bytes=hbm, mxu_passes=0,
                         vpu_ops=100,
                         est_cycles=compute + res.hbm_cycles(hbm))


def test_unported_planner_paths_raise_named_errors(frontends):
    _, tp = frontends
    specs = t_specs(tp, (1, 16, 16, 3), torch.float32)
    # mesh= past one device (no longer refused): byte-equal to the
    # reference's mesh plan
    jp, _ = frontends
    _clear()
    want = j_plan.plan_network(j_specs(jp, (2, 16, 16, 3), "float32"),
                               mesh=j_resources.MeshSpec(devices=2))
    got = t_plan.plan_network(t_specs(tp, (2, 16, 16, 3), torch.float32),
                              mesh=MeshSpec(devices=2))
    assert got.to_json() == want.to_json()
    assert got.mesh == MeshSpec(devices=2)
    # calibration= plans (no longer refused): byte-equal to the
    # reference's plan under a table fitted on the same samples
    tables = []
    for cal in (j_calibrate_cost, t_calibrate_cost):
        table = cal.CalibrationTable()
        for i, m in enumerate(("conv2d.ip1_vpu", "cnn_fused.fused_vpu",
                               "cnn_fused.fused_mxu")):
            for comp, hbm in ((1e3, 1 << 12), (5e4, 1 << 16),
                              (2e5, 1 << 20)):
                table.record(m, _cal_fp(cal, comp, hbm),
                             1e-4 * (i + 1) * comp + 1e-6 * hbm + 3.0)
        tables.append(table.fit())
    _clear()
    want = j_plan.plan_network(j_specs(jp, (1, 16, 16, 3), "float32"),
                               calibration=tables[0])
    got = t_plan.plan_network(specs, calibration=tables[1])
    assert got.to_json() == want.to_json()
    assert got.calibrated_cycles(tables[1]) == \
        want.calibrated_cycles(tables[0])
    ssm = TSiteSpec.make("s", "ssm_scan", ((1, 8, 16), (1, 8, 4)))
    with pytest.raises(NotImplementedError,
                       match="'ssm_scan' has no site adapter registered"):
        t_plan.plan_network([ssm])
    with pytest.raises(ValueError, match="duplicate site names"):
        t_plan.plan_network([specs[0], specs[0]])
    with pytest.raises(ValueError, match="no feasible IP"):
        t_plan.plan_network(specs, TBudget(vmem_bytes=1024))
