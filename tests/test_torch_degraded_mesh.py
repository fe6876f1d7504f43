"""Degraded-mesh survival in the port: the reference's
``tests/test_degraded_mesh.py`` re-run against ``repro_torch`` — the
degree ladder, post-loss grant previews (ladder snap),
``BudgetArbiter.on_device_loss``, spare-plan pre-warming against the
exact keys the degraded mesh re-plans under — and the end-to-end
lose-a-device-keep-serving path on two CPU logical devices
(``device="cpu"``: the mesh's ranks are two CPU entries of one process,
as the reference runs two forced host devices).  Then, across the
packages: the same arbiter sequences give the same grants, and the
end-to-end run's completions agree with the reference server's within
``rtol=1e-4, atol=1e-5`` and its telemetry equals it."""
import numpy as np
import pytest
import torch

from repro_torch.core.plan import (STATS, clear_plan_cache,
                                   plan_cache_contains, plan_network, replan)
from repro_torch.core.resources import MeshSpec, ResourceBudget
from repro_torch.core.shard import degree_ladder
from repro_torch.models.frontends import init_cnn_frontend
from repro_torch.obs import EVENTS
from repro_torch.runtime import AdaptiveServer, FaultSpec, GuardPolicy, \
    INJECTOR
from repro_torch.runtime.arbiter import BudgetArbiter
from repro_torch.runtime.recovery import cold_replans_since

DEVICE = ResourceBudget(vpu_ops_budget=15_000_000)


# --------------------------------------------------------------------------
# The degree ladder
# --------------------------------------------------------------------------
def test_degree_ladder_is_divisors_descending():
    assert degree_ladder(12) == (12, 6, 4, 3, 2, 1)
    assert degree_ladder(1) == (1,)
    assert degree_ladder(7) == (7, 1)


def test_degree_ladder_survivors_filter():
    assert degree_ladder(12, survivors=5) == (4, 3, 2, 1)
    assert degree_ladder(4, survivors=4) == (4, 2, 1)
    assert degree_ladder(16, survivors=1) == (1,)


def test_degree_ladder_validation():
    with pytest.raises(ValueError, match="degree"):
        degree_ladder(0)
    with pytest.raises(ValueError, match="survivors"):
        degree_ladder(4, survivors=0)


def test_every_rung_keeps_batches_tileable():
    for degree in (2, 4, 6, 8, 12, 16):
        for batch in range(degree, 4 * degree + 1, degree):
            for rung in degree_ladder(degree):
                assert batch % rung == 0


# --------------------------------------------------------------------------
# Arbiter: post-loss grants
# --------------------------------------------------------------------------
def _mesh_arbiter(devices, tenants=("a", "b"), cls=BudgetArbiter,
                  budget=ResourceBudget, mesh=MeshSpec):
    arb = cls(budget(), mesh=mesh(devices=devices))
    for name in tenants:
        arb.register(name, 0.05)
    for name in tenants:
        arb.observe(name, 100.0)
    arb.split()
    return arb


def test_degraded_grants_is_a_pure_preview():
    arb = _mesh_arbiter(6)
    before_devices = dict(arb._devices)
    grants = arb.degraded_grants(1)
    assert sum(grants.values()) <= 5
    assert all(g >= 1 for g in grants.values())
    assert arb.mesh.devices == 6 and arb._devices == before_devices


def test_degraded_grants_snap_down_the_ladder():
    arb = BudgetArbiter(ResourceBudget(), mesh=MeshSpec(devices=5))
    arb.register("big", 0.05)
    arb.register("small", 0.05)
    arb.observe("big", 1000.0)
    arb.observe("small", 1.0)
    arb.split()
    assert arb._devices == {"big": 4, "small": 1}
    grants = arb.degraded_grants(1)
    assert grants["big"] in degree_ladder(4)
    assert grants["small"] >= 1


def test_degraded_grants_refuses_eviction():
    arb = _mesh_arbiter(2)
    with pytest.raises(ValueError, match="at least one whole device"):
        arb.degraded_grants(1)


def test_degraded_grants_is_mesh_only():
    arb = BudgetArbiter(ResourceBudget())
    arb.register("a", 0.1)
    with pytest.raises(ValueError, match="mesh-mode only"):
        arb.degraded_grants(1)
    with pytest.raises(ValueError, match="mesh-mode only"):
        arb.on_device_loss()


def test_on_device_loss_shrinks_and_regrants():
    EVENTS.clear()
    arb = _mesh_arbiter(4)
    rebalances = arb.rebalances
    affected = arb.on_device_loss(3)
    assert arb.mesh.devices <= 3
    assert sum(arb._devices.values()) <= arb.mesh.devices
    assert all(g >= 1 for g in arb._devices.values())
    assert affected
    assert arb.rebalances == rebalances + 1
    evs = EVENTS.recent(kind="mesh.degraded")
    assert evs and evs[-1]["lost"] == 3


def test_on_device_loss_refuses_eviction():
    arb = _mesh_arbiter(2)
    with pytest.raises(ValueError, match="recover instead"):
        arb.on_device_loss()
    assert arb.mesh.devices == 2


@pytest.mark.parametrize("devices", [3, 4, 5, 6, 8])
def test_loss_sequences_equal_the_references(devices):
    """One seeded observe / split / preview / loss sequence through both
    arbiters: grants, previews, affected tenants and state equal."""
    from repro.core.resources import MeshSpec as JMesh
    from repro.core.resources import ResourceBudget as JBudget
    from repro.runtime.arbiter import BudgetArbiter as JArbiter
    rng = np.random.default_rng(devices)
    names = ("a", "b", "c")[:min(3, devices - 1)]
    arbs = [_mesh_arbiter(devices, names),
            _mesh_arbiter(devices, names, JArbiter, JBudget, JMesh)]
    for _ in range(3):
        for name in names:
            w = float(rng.integers(1, 5000))
            for arb in arbs:
                arb.observe(name, w)
        got, want = (arb.split() for arb in arbs)
        assert {n: (s.devices, s.fraction) for n, s in got.items()} == \
            {n: (s.devices, s.fraction) for n, s in want.items()}
        if arbs[0].mesh.devices - 1 >= len(names):
            assert arbs[0].degraded_grants(1) == arbs[1].degraded_grants(1)
            assert arbs[0].on_device_loss(1) == arbs[1].on_device_loss(1)
            assert arbs[0].mesh.devices == arbs[1].mesh.devices
        assert arbs[0]._devices == arbs[1]._devices
        assert arbs[0].state_dict() == arbs[1].state_dict()


# --------------------------------------------------------------------------
# Spare-plan pre-warming: the exact keys the degraded mesh asks for
# --------------------------------------------------------------------------
def _params():
    return init_cnn_frontend(0, channels=(6, 12), d_model=16, device="cpu")


def _mesh_server(max_batch=4):
    srv = AdaptiveServer(DEVICE, mesh=MeshSpec(devices=2),
                         max_batch=max_batch, device="cpu")
    srv.register("a", _params(), (12, 12, 6))
    srv.arbiter.observe("a", 100.0)
    srv._apply_shares(srv.arbiter.split())
    return srv


def test_prewarm_spares_is_mesh_only():
    srv = AdaptiveServer(DEVICE, max_batch=2, device="cpu")
    srv.register("a", _params(), (12, 12, 6))
    with pytest.raises(ValueError, match="mesh-mode only"):
        srv.prewarm_spares()


def test_prewarm_then_degrade_replans_nothing_cold():
    clear_plan_cache()
    srv = _mesh_server(max_batch=4)
    t = srv.tenants["a"]
    specs_b3 = srv._specs(t.params, (3,) + t.input_shape, "float32",
                          t.pool_window, t.activation, t.ladder)
    assert not plan_cache_contains(specs_b3, srv.budget, fuse=srv.fuse)
    warmed = srv.prewarm_spares(losses=1)
    assert warmed >= srv.max_batch
    assert plan_cache_contains(specs_b3, srv.budget, fuse=srv.fuse)

    before = STATS.plan_misses
    affected = srv.on_device_loss(1)
    assert affected == ["a"]
    assert srv.mesh.devices == 1 and srv.arbiter.devices_for("a") == 1
    for b in range(1, srv.max_batch + 1):
        specs = srv._specs(t.params, (b,) + t.input_shape, "float32",
                           t.pool_window, t.activation, t.ladder)
        replan(specs, srv.arbiter.budget_for("a"), fuse=srv.fuse,
               mesh=srv.arbiter.mesh_for("a"))
    assert cold_replans_since(before) == 0
    assert t.telemetry.degradations == 1


def test_degraded_plan_keeps_full_precision():
    srv = _mesh_server(max_batch=2)
    t = srv.tenants["a"]
    specs = srv._specs(t.params, (2,) + t.input_shape, "float32",
                       t.pool_window, t.activation, t.ladder)
    p2 = plan_network(specs, srv.arbiter.budget_for("a"), fuse=srv.fuse,
                      mesh=srv.arbiter.mesh_for("a"))
    srv.on_device_loss(1)
    p1 = plan_network(specs, srv.arbiter.budget_for("a"), fuse=srv.fuse,
                      mesh=srv.arbiter.mesh_for("a"))
    assert max(s.shard_degree for s in p2.sites) >= 1
    assert all(s.shard_degree == 1 for s in p1.sites)
    assert all(s.precision_bits == 32 for s in p1.sites)
    assert all(not s.lowered for s in p1.sites)


def test_mesh_server_needs_its_devices():
    """A CUDA mesh server is never handed cuda:0 for a card that is not
    there: without enough cards it raises the reference's error unless
    the caller names the devices."""
    with pytest.raises(ValueError, match="plan wants 3 devices but only 2"):
        AdaptiveServer(DEVICE, mesh=MeshSpec(devices=3), device="cpu",
                       devices=["cpu", "cpu"])
    srv = AdaptiveServer(DEVICE, mesh=MeshSpec(devices=2), device="cpu")
    assert srv.devices == (torch.device("cpu"),) * 2
    assert AdaptiveServer(DEVICE, device="cpu").devices is None


# --------------------------------------------------------------------------
# End to end on two CPU logical devices: lose a device mid-serving, keep
# serving — and the same run through the reference's server
# --------------------------------------------------------------------------
def _survive(server, params, rng_seed=0):
    server.register("a", params, (12, 12, 6))
    server.set_guard("a", GuardPolicy(max_retries=2, backoff_base_s=0.001))
    rng = np.random.default_rng(rng_seed)

    def wave(n=2):
        for _ in range(n):
            server.submit("a", rng.normal(size=(12, 12, 6))
                          .astype(np.float32))
        return server.drain()

    healthy = wave()
    server.prewarm_spares(losses=1)
    return healthy, wave


def test_server_survives_device_loss_end_to_end():
    from repro_torch.runtime import faults as t_faults
    srv = AdaptiveServer(DEVICE, mesh=MeshSpec(devices=2), max_batch=2,
                         device="cpu")
    healthy, wave = _survive(srv, _params())
    assert all(c.ok for c in healthy)
    before = STATS.plan_misses
    with t_faults.INJECTOR.armed([FaultSpec("device_loss", step=0,
                                            param=1)]):
        degraded = wave()
    assert all(c.ok for c in degraded), degraded
    assert srv.mesh.devices == 1
    tel = srv.telemetry()["a"]
    assert tel["degradations"] == 1
    assert sorted(tel["shard_degree_mix"]) == [1, 2]
    assert set(tel["precision_mix"]) == {32}
    assert STATS.plan_misses - before == 0
    assert len(degraded) == 2
    assert not INJECTOR.enabled


def test_device_loss_run_equals_the_references():
    """The same seeded run through the reference's server (one host
    device serves both of its mesh ranks' slices here: the reference
    falls back to its replicated walk, the same math) and the port's:
    completions within rtol=1e-4, atol=1e-5, telemetry equal."""
    import jax

    from repro.core.plan import clear_plan_cache as j_clear
    from repro.core.resources import MeshSpec as JMesh
    from repro.core.resources import ResourceBudget as JBudget
    from repro.runtime import AdaptiveServer as JServer
    from repro.runtime import FaultSpec as JFaultSpec
    from repro.runtime import INJECTOR as J_INJECTOR
    from repro_torch.models.frontends import params_from_numpy
    from repro.models.frontends import init_cnn_frontend as j_init
    jp = j_init(jax.random.PRNGKey(0), channels=(6, 12), d_model=16)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    runs = []
    for server, params, injector, spec in (
            (JServer(JBudget(vpu_ops_budget=15_000_000),
                     mesh=JMesh(devices=2), max_batch=2), jp, J_INJECTOR,
             JFaultSpec),
            (AdaptiveServer(DEVICE, mesh=MeshSpec(devices=2), max_batch=2,
                            device="cpu"), tp, INJECTOR, FaultSpec)):
        j_clear()
        clear_plan_cache()
        # the reference's sharded frontend needs two host devices; with
        # one it serves the same plans through its replicated walk
        if server.__class__ is JServer:
            server._shardable = lambda plan, xb: False
        healthy, wave = _survive(server, params)
        with injector.armed([spec("device_loss", step=0, param=1)]):
            degraded = wave()
        tel = server.telemetry()["a"]
        runs.append((healthy + degraded, tel))
    (jc, jt), (tc, tt) = runs
    assert [(c.rid, c.ok, c.arrival, c.finished, c.batch_size) for c in tc] \
        == [(c.rid, c.ok, c.arrival, c.finished, c.batch_size) for c in jc]
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.result.numpy(), np.asarray(b.result),
                                   rtol=1e-4, atol=1e-5)
    drop = {"calibration_key"}
    assert {k: v for k, v in tt.items() if k not in drop} == \
        {k: v for k, v in jt.items() if k not in drop}
