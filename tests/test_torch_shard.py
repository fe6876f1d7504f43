"""The port's mesh planning (``repro_torch.core.shard``, the mesh paths
of ``repro_torch.core.plan`` and the arbiter's whole-device grants)
against the reference's (``repro.core.shard``).

Everything here is pure Python over specs, budgets and meshes, so the
comparisons are exact: every ``core/shard.py`` function returns what the
reference's returns over a seeded grid of site specs, axes, degrees and
meshes (specs compared by ``to_dict()``, cycles as floats, ``==``);
``plan_network(mesh=)`` and ``replan(mesh=)`` JSON and
``export_plan_cache`` are byte-equal on a fuzz of CNN networks (1-3
blocks, fused and unfused, random budgets, meshes of 2 and 4); and the
reference's planning cases of ``tests/test_shard_exec.py`` re-run
against the port."""
import hashlib
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import calibrate_cost as j_cal
from repro.core import plan as j_plan
from repro.core import resources as j_res
from repro.core import shard as j_shard
from repro.core.ip import SiteSpec as JSiteSpec
from repro.models.frontends import cnn_frontend_site_specs as j_specs
from repro.runtime.arbiter import BudgetArbiter as JArbiter
from repro_torch.core import calibrate_cost as t_cal
from repro_torch.core import plan as t_plan
from repro_torch.core import resources as t_res
from repro_torch.core import shard as t_shard
from repro_torch.core.ip import SiteSpec as TSiteSpec
from repro_torch.core.plan import NetworkPlan, plan_network, replan
from repro_torch.core.resources import MeshSpec, ResourceBudget
from repro_torch.core.shard import force_shard_decisions
from repro_torch.models.frontends import cnn_frontend_site_specs as t_specs
from repro_torch.runtime.arbiter import BudgetArbiter

MESH2 = MeshSpec(devices=2)
WIN_BUDGET = ResourceBudget(mxu_passes_budget=7)


def _both(fn, *args, **kw):
    """fn(JSiteSpec, j_res) and fn(TSiteSpec, t_res)."""
    return fn(JSiteSpec, j_res, *args, **kw), fn(TSiteSpec, t_res, *args,
                                                 **kw)


def _grid_specs(S, _res):
    conv = ((8, 16, 16, 32), (3, 3, 32, 128))
    return [
        S.make("conv", "conv2d", conv, "float32", dual=False),
        S.make("conv_odd", "conv2d", ((3, 9, 9, 6), (3, 3, 6, 5)), "float32",
               dual=False),
        S.make("conv_bf16", "conv2d", ((4, 12, 12, 8), (3, 3, 8, 16)),
               "bfloat16", dual=False),
        S.make("dual", "conv2d", conv, "int8", dual=True),
        S.make("pool", "pool2d", ((4, 14, 14, 16),), "float32",
               window=(2, 2)),
        S.make("pool_s", "pool2d", ((6, 15, 15, 12),), "float32",
               window=(3, 3), stride=(2, 2)),
        S.make("act", "activation", ((4, 7, 7, 32),), "float32",
               kind="tanh"),
        S.make("fused", "cnn_fused", ((4, 16, 16, 8), (3, 3, 8, 16)),
               "float32", window=(2, 2), kind="relu"),
        S.make("mm", "matmul", ((64, 128), (128, 256)), "float32"),
        S.make("attn", "attention", ((1, 4, 64, 8), (1, 2, 64, 8)),
               "float32"),
    ]


MESHES = [dict(devices=1), dict(devices=2), dict(devices=4),
          dict(devices=3, axis="x", ici_bytes_per_cycle=7.5)]


def _d(spec):
    return None if spec is None else spec.to_dict()


def test_degree_ladder_matches_reference():
    for degree in range(1, 25):
        assert t_shard.degree_ladder(degree) == j_shard.degree_ladder(degree)
        for survivors in range(1, degree + 2):
            assert (t_shard.degree_ladder(degree, survivors=survivors)
                    == j_shard.degree_ladder(degree, survivors=survivors))
    for bad in (dict(degree=0), dict(degree=4, survivors=0)):
        with pytest.raises(ValueError) as want:
            j_shard.degree_ladder(**bad)
        with pytest.raises(ValueError) as got:
            t_shard.degree_ladder(**bad)
        assert str(got.value) == str(want.value)


def test_shard_rules_match_reference_over_the_grid():
    js, ts = _both(_grid_specs)
    for j, t in zip(js, ts):
        if j.family != "attention":
            assert t_shard.site_output_shape(t) == \
                j_shard.site_output_shape(j)
            assert t_shard.site_output_bytes(t) == \
                j_shard.site_output_bytes(j)
        else:
            with pytest.raises(ValueError) as want:
                j_shard.site_output_shape(j)
            with pytest.raises(ValueError) as got:
                t_shard.site_output_shape(t)
            assert str(got.value) == str(want.value)
        for axis in ("batch", "chan"):
            for degree in (1, 2, 3, 4, 8):
                assert _d(t_shard.shard_site_spec(t, axis, degree)) == \
                    _d(j_shard.shard_site_spec(j, axis, degree)), \
                    (j.name, axis, degree)
                assert t_shard.required_input_layout(t, axis, degree) == \
                    j_shard.required_input_layout(j, axis, degree)
                assert t_shard.output_layout(t, axis, degree) == \
                    j_shard.output_layout(j, axis, degree)
                if j.family == "attention":
                    continue
                for mk in MESHES:
                    assert t_shard.site_comm_cycles(
                        t, axis, degree, t_res.MeshSpec(**mk)) == \
                        j_shard.site_comm_cycles(j, axis, degree,
                                                 j_res.MeshSpec(**mk))
        with pytest.raises(ValueError) as want:
            j_shard.shard_site_spec(j, "spatial", 2)
        with pytest.raises(ValueError) as got:
            t_shard.shard_site_spec(t, "spatial", 2)
        assert str(got.value) == str(want.value)


def test_mesh_pricing_and_boundaries_match_reference():
    layouts = [("full", 1), ("batch", 2), ("chan", 2), ("batch", 4)]
    for mk in MESHES:
        jm, tm = j_res.MeshSpec(**mk), t_res.MeshSpec(**mk)
        assert hash(tm) == hash(t_res.MeshSpec(**mk)) and tm == tm
        for n in (0, 1, 4096, 10 ** 9 + 7):
            for name in ("ici_cycles", "all_gather_cycles",
                         "all_reduce_cycles", "halo_cycles"):
                assert getattr(tm, name)(n) == getattr(jm, name)(n)
            for a in layouts:
                for b in layouts:
                    assert t_shard.boundary_comm_cycles(tm, a, b, n) == \
                        j_shard.boundary_comm_cycles(jm, a, b, n)


def _decisions(pkg_shard, specs, budget, mesh, **kw):
    return [(d.axis, d.degree, d.spec.to_dict(), d.comm_cycles)
            for d in pkg_shard.plan_shard_decisions(specs, budget, mesh,
                                                    **kw)]


def _fitted(cal, res):
    table = cal.CalibrationTable()
    for i, m in enumerate(("conv2d.ip1_vpu", "conv2d.ip2_mxu",
                           "pool2d.pool_vpu", "activation.act_vpu",
                           "cnn_fused.fused_vpu", "cnn_fused.fused_mxu")):
        for comp, hbm in ((1e3, 1 << 12), (5e4, 1 << 16), (2e5, 1 << 20)):
            fp = res.Footprint(vmem_bytes=1024, hbm_bytes=hbm, mxu_passes=0,
                               vpu_ops=100,
                               est_cycles=comp + res.hbm_cycles(hbm))
            table.record(m, fp, 1e-4 * (i + 1) * comp + 1e-6 * hbm + 3.0)
    return table.fit()


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["analytical", "calibrated"])
def test_plan_shard_decisions_match_reference(calibrated):
    js, ts = _both(_grid_specs)
    chains = [(0,), (1,), (4,), (6,), (7,), (8,), (0, 6), (2,), (1, 4, 6)]
    jcal = _fitted(j_cal, j_res) if calibrated else None
    tcal = _fitted(t_cal, t_res) if calibrated else None
    budgets = [dict(), dict(mxu_passes_budget=7),
               dict(vmem_bytes=256 * 1024), dict(mxu_available=False)]
    for chain in chains:
        for bk in budgets:
            for mk in MESHES:
                jspecs = [js[i] for i in chain]
                tspecs = [ts[i] for i in chain]
                j_ev, t_ev = [], []
                try:
                    want = _decisions(j_shard, jspecs, j_res.ResourceBudget(
                        **bk), j_res.MeshSpec(**mk), calibration=jcal,
                        events=j_ev)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        _decisions(t_shard, tspecs, t_res.ResourceBudget(
                            **bk), t_res.MeshSpec(**mk), calibration=tcal)
                    assert str(got.value) == str(e)
                    continue
                got = _decisions(t_shard, tspecs, t_res.ResourceBudget(**bk),
                                 t_res.MeshSpec(**mk), calibration=tcal,
                                 events=t_ev)
                assert got == want, (chain, bk, mk)
                assert t_ev == j_ev


def test_force_shard_decisions_match_reference():
    js, ts = _both(_grid_specs)
    for chain in [(0,), (0, 6), (4, 6), (7,), (8,), (3,)]:
        for axis in ("batch", "chan"):
            for mk in MESHES:
                jm, tm = j_res.MeshSpec(**mk), t_res.MeshSpec(**mk)
                try:
                    want = j_shard.force_shard_decisions(
                        [js[i] for i in chain], jm, axis=axis)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        t_shard.force_shard_decisions(
                            [ts[i] for i in chain], tm, axis=axis)
                    assert str(got.value) == str(e)
                    continue
                got = t_shard.force_shard_decisions([ts[i] for i in chain],
                                                    tm, axis=axis)
                assert [(d.axis, d.degree, d.spec.to_dict(), d.comm_cycles)
                        for d in got] == \
                    [(d.axis, d.degree, d.spec.to_dict(), d.comm_cycles)
                     for d in want]


# --------------------------------------------------------------------------
# plan_network(mesh=) / replan(mesh=) / export_plan_cache: byte-equal
# --------------------------------------------------------------------------
def _params(blocks, rng):
    chans = [int(rng.choice([3, 4, 6]))]
    for _ in range(blocks):
        chans.append(int(rng.choice([4, 8, 12, 16])))
    w = [{"w": np.zeros((3, 3, a, b), np.float32)}
         for a, b in zip(chans, chans[1:])]
    jp = {"blocks": w, "proj": np.zeros((chans[-1], 8), np.float32)}
    tp = {"blocks": [{"w": torch.zeros(x["w"].shape)} for x in w],
          "proj": torch.zeros(chans[-1], 8)}
    return jp, tp, chans[0]


def _fuzz_cases(n=20, seed=0):
    rng = np.random.default_rng(seed)
    cases = []
    for i in range(n):
        blocks = 1 + i % 3
        jp, tp, cin = _params(blocks, rng)
        side = int(rng.choice({1: [8, 12, 16], 2: [14, 20],
                               3: [30, 34]}[blocks]))
        batch = int(rng.choice([1, 2, 4, 6]))
        budget = {}
        pick = rng.integers(0, 5)
        if pick == 1:
            budget["mxu_passes_budget"] = int(rng.integers(1, 40))
        elif pick == 2:
            budget["vmem_bytes"] = int(rng.integers(64, 2048)) * 1024
        elif pick == 3:
            budget["vpu_ops_budget"] = int(rng.integers(10 ** 5, 10 ** 7))
        elif pick == 4:
            budget["mxu_available"] = False
        cases.append((jp, tp, (batch, side, side, cin), budget,
                       int(rng.choice([2, 4]))))
    return cases


FUZZ = _fuzz_cases()


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("case", range(len(FUZZ)))
def test_mesh_plans_byte_equal_on_a_fuzz(case, fuse):
    jp, tp, shape, bk, devices = FUZZ[case]
    j_plan.clear_plan_cache()
    t_plan.clear_plan_cache()
    jspecs = tuple(j_specs(jp, shape, "float32"))
    tspecs = tuple(t_specs(tp, shape, torch.float32))
    assert [s.to_dict() for s in tspecs] == [s.to_dict() for s in jspecs]
    jm, tm = j_res.MeshSpec(devices=devices), t_res.MeshSpec(devices=devices)
    calls = [("plan", j_res.ResourceBudget(**bk), t_res.ResourceBudget(**bk)),
             ("replan", j_res.ResourceBudget(**bk).scaled(0.5),
              t_res.ResourceBudget(**bk).scaled(0.5)),
             ("replan", j_res.ResourceBudget(**bk),
              t_res.ResourceBudget(**bk))]
    for how, jb, tb in calls:
        jf = j_plan.plan_network if how == "plan" else j_plan.replan
        tf = plan_network if how == "plan" else replan
        try:
            want = jf(jspecs, jb, fuse=fuse, mesh=jm)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tf(tspecs, tb, fuse=fuse, mesh=tm)
            assert str(got.value) == str(e)
            continue
        got = tf(tspecs, tb, fuse=fuse, mesh=tm)
        assert got.to_json() == want.to_json()
        assert got.describe() == want.describe()
        assert got.explain() == want.explain()
        assert got.device_plan().to_json() == want.device_plan().to_json()
        assert [s.spec.name for s in got.sharded_sites()] == \
            [s.spec.name for s in want.sharded_sites()]
    assert json.dumps(t_plan.export_plan_cache(), sort_keys=True) == \
        json.dumps(j_plan.export_plan_cache(), sort_keys=True)


# --------------------------------------------------------------------------
# The reference's planning cases (tests/test_shard_exec.py), on the port
# --------------------------------------------------------------------------
def _conv(name="conv", x=(8, 16, 16, 32), w=(3, 3, 32, 128)):
    return TSiteSpec.make(name, "conv2d", (x, w), "float32", dual=False)


def test_split_wins_flips_member_and_cuts_cycles():
    t_plan.clear_plan_cache()
    spec = _conv()
    p1 = plan_network((spec,), WIN_BUDGET)
    p2 = plan_network((spec,), WIN_BUDGET, mesh=MESH2)
    s1, s2 = p1.sites[0], p2.sites[0]
    assert not s1.sharded
    assert s2.sharded and (s2.shard_axis, s2.shard_degree) == ("batch", 2)
    assert s2.footprint.comm_cycles > 0.0
    assert p2.total_cycles < p1.total_cycles
    assert s1.ip.name.endswith("ip1_vpu")
    assert s2.ip.name.endswith("ip2_mxu")


def test_refusal_when_collectives_dominate():
    spec = _conv(x=(4, 64, 64, 4), w=(1, 1, 4, 128))
    pr = plan_network((spec,), ResourceBudget(), mesh=MESH2)
    s = pr.sites[0]
    assert not s.sharded and s.shard_degree == 1
    assert s.footprint.comm_cycles == 0.0
    forced = force_shard_decisions((spec,), MESH2, axis="chan")
    assert sum(f.comm_cycles for f in forced) > pr.total_cycles


def test_sharding_rescues_single_device_infeasibility():
    spec = _conv()
    tight = ResourceBudget(vmem_bytes=256 * 1024)
    with pytest.raises(ValueError, match="no feasible IP"):
        plan_network((spec,), tight)
    rescued = plan_network((spec,), tight, mesh=MESH2)
    s = rescued.sites[0]
    assert s.sharded and s.shard_degree == 2


def test_single_device_mesh_is_the_trivial_plan():
    p = plan_network((_conv("one"),), WIN_BUDGET, mesh=MeshSpec(devices=1))
    assert not p.sites[0].sharded
    assert p.sites[0].footprint.comm_cycles == 0.0


def test_plan_json_round_trips_sharding_fields():
    p2 = plan_network((_conv("json"),), WIN_BUDGET, mesh=MESH2)
    restored = NetworkPlan.from_json(p2.to_json())
    assert restored == p2
    assert restored.mesh == MESH2
    s = restored.sites[0]
    assert (s.shard_axis, s.shard_degree) == ("batch", 2)
    assert s.footprint.comm_cycles == p2.sites[0].footprint.comm_cycles
    assert restored.to_json() == p2.to_json()


def test_plan_cache_keys_on_mesh():
    t_plan.clear_plan_cache()
    specs = (_conv("cachemesh"),)
    p0 = plan_network(specs, WIN_BUDGET)
    p2 = plan_network(specs, WIN_BUDGET, mesh=MESH2)
    assert p0 is not p2
    keys = [k for k in t_plan._PLAN_CACHE if k[0] == specs]
    assert {k[3] for k in keys} == {None, MESH2}
    assert plan_network(specs, WIN_BUDGET, mesh=MESH2) is p2
    assert replan(specs, WIN_BUDGET, mesh=MESH2) is p2


def test_device_plan_halves_the_sharded_dim():
    p2 = plan_network((_conv("dev"),), WIN_BUDGET, mesh=MESH2)
    dp = p2.device_plan()
    gx = p2.sites[0].spec.shapes[0]
    dx = dp.sites[0].spec.shapes[0]
    assert dx[0] == gx[0] // 2 and dx[1:] == gx[1:]
    assert p2.sites[0].spec.shapes[0] == gx
    assert plan_network((_conv("dev1"),), WIN_BUDGET).device_plan() \
        .sites[0].spec.shapes[0] == gx


def test_arbiter_grants_partition_the_mesh():
    arb = BudgetArbiter(ResourceBudget(), mesh=MeshSpec(devices=4))
    ref = JArbiter(j_res.ResourceBudget(), mesh=j_res.MeshSpec(devices=4))
    for a in (arb, ref):
        for name in ("a", "b", "c"):
            a.register(name)
        a.observe("a", 6000.0)
        a.observe("b", 1000.0)
        a.observe("c", 1000.0)
    shares = arb.split()
    assert {n: s.devices for n, s in ref.split().items()} == \
        {n: s.devices for n, s in shares.items()}
    devs = {n: s.devices for n, s in shares.items()}
    assert sum(devs.values()) == 4
    assert all(v >= 1 for v in devs.values())
    assert devs["a"] == 2
    slices = [arb.device_slice(n) for n in ("a", "b", "c")]
    assert slices == [ref.device_slice(n) for n in ("a", "b", "c")]
    assert slices[0][0] == 0 and slices[-1][1] == 4
    for (_, a1), (b0, _) in zip(slices, slices[1:]):
        assert a1 == b0
    for n in devs:
        assert arb.mesh_for(n).devices == devs[n]
        assert arb.budget_for(n) == arb.budget
        assert arb.devices_for(n) == devs[n]
    assert arb.state_dict() == ref.state_dict()


def test_arbiter_rejects_tenants_beyond_devices():
    arb = BudgetArbiter(ResourceBudget(), mesh=MESH2)
    arb.register("a")
    arb.register("b")
    with pytest.raises(ValueError, match="whole device"):
        arb.register("c")
    assert set(arb.split()) == {"a", "b"}
    with pytest.raises(ValueError, match="fractional-mode only"):
        arb.preempt("a", "b")
    with pytest.raises(ValueError, match="not in mesh mode"):
        BudgetArbiter(ResourceBudget()).devices_for("a")


def test_chip_smoke_mesh_plan_is_the_references():
    """``chip_smoke.py``'s "mesh" phase serves the default frontend at
    full width under ``MESH_BUDGET`` on 2 devices and checks the plan's
    sha256 against ``MESH_PLAN_SHA``: that constant is the reference's
    plan JSON, and the port's plan is the same bytes, batch-split at
    every site (so the server's sharded path runs)."""
    from repro.models.frontends import init_cnn_frontend as j_init
    from repro_torch.models.frontends import init_cnn_frontend
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    shape = (cs.MAX_BATCH,) + cs.IMAGE
    j_plan.clear_plan_cache()
    t_plan.clear_plan_cache()
    want = j_plan.plan_network(
        tuple(j_specs(j_init(jax.random.PRNGKey(0)), shape, "float32")),
        j_res.ResourceBudget(**cs.MESH_BUDGET),
        mesh=j_res.MeshSpec(devices=cs.MESH_DEVICES)).to_json()
    got = plan_network(
        tuple(t_specs(init_cnn_frontend(cs.SEED, device="cpu"), shape,
                      torch.float32)),
        ResourceBudget(**cs.MESH_BUDGET),
        mesh=MeshSpec(devices=cs.MESH_DEVICES))
    assert got.to_json() == want
    assert hashlib.sha256(want.encode()).hexdigest() == cs.MESH_PLAN_SHA
    assert all(s.shard_axis == "batch" and s.shard_degree == cs.MESH_DEVICES
               for s in got.sites)
