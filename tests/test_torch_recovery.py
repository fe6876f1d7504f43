"""The port's plan-preserving recovery (``repro_torch.runtime.recovery``,
``repro_torch.checkpoint.store``, the plan-cache export of
``repro_torch.core.plan``) against the reference's.

The reference's ``tests/test_recovery.py``, re-run against the port on
the CPU (``device="cpu"``): blind checkpoint restore, the
zero-cold-replan restart guarantee, snapshot validation (calibration
identity, floor drift) and the watchdog-armed ``RecoveryManager``,
``test_degrade_rearms_the_watchdog`` on a mesh of two CPU logical
devices (on one device ``degrade`` raises the reference's
``ValueError``), and a degraded mesh server snapshotted and recovered
onto its shrunk mesh.  Then, across the packages:

* ``export_plan_cache`` is byte-equal (``json.dumps(..., sort_keys=
  True)``) after the same serving trace;
* a snapshot written by the reference's ``snapshot_server`` is
  recovered by the port with zero cold plans, and the port serves the
  same next wave as the reference's own recovered server;
* a snapshot written by the port is read by the reference's
  ``restore_blind``;
* a bf16 tenant's params round-trip bitwise in the port, and
  ``restore`` puts each leaf on its target's dtype and device.
"""
import json
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import restore_blind as j_restore_blind
from repro.core.plan import clear_plan_cache as j_clear
from repro.core.plan import export_plan_cache as j_export
from repro.core.resources import ResourceBudget as JBudget
from repro.models.frontends import init_cnn_frontend as j_init
from repro.runtime import AdaptiveServer as JServer
from repro.runtime import SLOScheduler as JScheduler
from repro.runtime import SLOSpec as JSLOSpec
from repro.runtime import recover_server as j_recover
from repro.runtime import snapshot_server as j_snapshot
from repro_torch.checkpoint.store import restore, restore_blind, save
from repro_torch.core.plan import (STATS, clear_plan_cache,
                                   export_plan_cache, import_plan_cache,
                                   plan_cache_contains, plan_cache_stats)
from repro_torch.core.resources import ResourceBudget
from repro_torch.models.frontends import init_cnn_frontend, params_from_numpy
from repro_torch.obs import EVENTS
from repro_torch.runtime import (AdaptiveServer, GuardPolicy,
                                 RecoveryManager, SLOScheduler, SLOSpec,
                                 recover_server, simulate_worker_death,
                                 snapshot_server)
from repro_torch.runtime.recovery import cold_replans_since

DEVICE = ResourceBudget(vpu_ops_budget=15_000_000)
SHAPE = (12, 12, 6)


def _frontend(key=0, channels=(6, 12), d_model=16):
    return init_cnn_frontend(key, channels=channels, d_model=d_model,
                             device="cpu")


def _deployment():
    srv = AdaptiveServer(DEVICE, policy="demand", max_batch=4, device="cpu")
    sched = SLOScheduler(srv)
    sched.register("a", _frontend(0), (12, 12, 6),
                   slo=SLOSpec(deadline_s=60.0, priority=1))
    sched.register("b", _frontend(1), (12, 12, 6),
                   slo=SLOSpec(deadline_s=120.0))
    return srv, sched


def _wave(sched, rng, n=4):
    for _ in range(n):
        sched.submit("a", rng.normal(size=(12, 12, 6)).astype(np.float32))
        sched.submit("b", rng.normal(size=(12, 12, 6)).astype(np.float32))
    return sched.run()


# --------------------------------------------------------------------------
# Blind restore: the crash-recovery entry point
# --------------------------------------------------------------------------
def test_restore_blind_rebuilds_without_target(tmp_path):
    tree = {"m": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "blocks": [np.ones((2,), np.float32),
                             (np.zeros((3,), np.float32),)]}}
    save(tmp_path, 1, tree, extra={"k": 7})
    got, extra = restore_blind(tmp_path)
    assert extra == {"k": 7}
    assert set(got) == {"m"}
    np.testing.assert_array_equal(got["m"]["w"].numpy(), tree["m"]["w"])
    assert isinstance(got["m"]["blocks"], list)
    assert isinstance(got["m"]["blocks"][1], tuple)
    np.testing.assert_array_equal(got["m"]["blocks"][1][0].numpy(),
                                  tree["m"]["blocks"][1][0])


def test_restore_blind_requires_structure_spec(tmp_path):
    tree = {"w": np.ones((2,), np.float32)}
    save(tmp_path, 1, tree)
    d = tmp_path / "step_000000001"
    manifest = json.loads((d / "manifest.json").read_text())
    manifest["structure"] = None          # a custom-node checkpoint
    (d / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError):
        restore_blind(tmp_path)


# --------------------------------------------------------------------------
# The headline guarantee: restart re-plans ZERO cold graphs
# --------------------------------------------------------------------------
def test_recover_replans_nothing_cold(tmp_path):
    srv, sched = _deployment()
    rng = np.random.default_rng(0)
    # two identical waves settle the demand EWMA at the mix's fixed
    # point, so the post-crash wave re-arbitrates to the same grants
    _wave(sched, rng)
    _wave(sched, rng)
    grants_before = {n: t.granted for n, t in srv.tenants.items()}
    snapshot_server(srv, tmp_path, 1, scheduler=sched)

    simulate_worker_death()
    assert plan_cache_stats()["size"] == 0       # the crash was real

    before = STATS.plan_misses
    srv2, sched2 = recover_server(tmp_path, device="cpu")
    assert sched2 is not None
    assert sched2.slos == sched.slos
    assert srv2.clock == pytest.approx(srv.clock)
    for n, g in grants_before.items():
        assert srv2.tenants[n].granted == pytest.approx(g)
    comps = _wave(sched2, np.random.default_rng(0))
    assert len(comps) == 8                       # serving resumed
    assert cold_replans_since(before) == 0       # and NOTHING planned cold


def test_recover_without_scheduler_state(tmp_path):
    srv = AdaptiveServer(DEVICE, max_batch=4, device="cpu")
    srv.register("a", _frontend(0), (12, 12, 6))
    rng = np.random.default_rng(0)
    srv.submit("a", rng.normal(size=(12, 12, 6)).astype(np.float32))
    srv.step()
    snapshot_server(srv, tmp_path, 1)
    simulate_worker_death()
    srv2, sched2 = recover_server(tmp_path, device="cpu")
    assert sched2 is None
    assert set(srv2.tenants) == {"a"}


# --------------------------------------------------------------------------
# Snapshot validation: wrong deployment is rejected, not half-restored
# --------------------------------------------------------------------------
def test_recover_rejects_calibration_mismatch(tmp_path):
    srv, sched = _deployment()
    snapshot_server(srv, tmp_path, 1, scheduler=sched)

    class OtherTable:
        def key(self):
            return ("other-table", 42)

    with pytest.raises(ValueError, match="calibration mismatch"):
        recover_server(tmp_path, calibration=OtherTable(), device="cpu")


def test_recover_rejects_floor_drift(tmp_path):
    srv, sched = _deployment()
    snapshot_server(srv, tmp_path, 1, scheduler=sched)
    step_dir = next(p for p in Path(tmp_path).iterdir()
                    if p.name.startswith("step_"))
    manifest = json.loads((step_dir / "manifest.json").read_text())
    manifest["extra"]["tenants"]["a"]["floor"] += 0.05   # drifted deploy
    (step_dir / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="floor drifted"):
        recover_server(tmp_path, device="cpu")


# --------------------------------------------------------------------------
# RecoveryManager: watchdog wiring + adopt-the-replacement
# --------------------------------------------------------------------------
def test_recovery_manager_snapshot_kill_recover(tmp_path):
    srv, sched = _deployment()
    rng = np.random.default_rng(0)
    _wave(sched, rng)
    _wave(sched, rng)
    mgr = RecoveryManager(srv, tmp_path, scheduler=sched)
    mgr.snapshot()
    simulate_worker_death()
    before = STATS.plan_misses
    replacement = mgr.recover(device="cpu")
    assert replacement is not srv                # adopted the new server
    assert mgr.server is replacement
    assert mgr.scheduler is not None and mgr.scheduler is not sched
    _wave(mgr.scheduler, np.random.default_rng(0))
    assert cold_replans_since(before) == 0


def test_recover_rearms_the_watchdog_for_a_second_death(tmp_path):
    """Regression: the fire-once pattern (on_death stops the watchdog)
    left recovery deaf — after one recover() a SECOND worker death never
    fired.  recover() must re-arm: clear the latch on a live monitor or
    replace a joined one."""
    srv, sched = _deployment()
    died = []
    holder = {}

    def on_death():
        died.append(1)
        holder["mgr"].watchdog.stop()    # fire-once: the thread joins

    mgr = RecoveryManager(srv, tmp_path, scheduler=sched,
                          heartbeat_timeout_s=0.05, on_death=on_death)
    holder["mgr"] = mgr
    try:
        mgr.snapshot()
        deadline = time.monotonic() + 2.0
        while not died and time.monotonic() < deadline:
            time.sleep(0.01)
        assert died == [1]
        assert not mgr.watchdog._thread.is_alive()   # monitor is gone

        mgr.recover(device="cpu")        # adopt replacement + re-arm
        assert mgr.watchdog._thread.is_alive()
        assert not mgr.watchdog.fired
        assert mgr.scheduler is not None
        assert mgr.scheduler.recovery is mgr   # beats reach the new dog

        deadline = time.monotonic() + 2.0
        while len(died) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(died) == 2            # the second death fired too
    finally:
        mgr.stop()


def test_snapshot_round_trips_guard_policies(tmp_path):
    """Guard policies are serving state: a recovered server screens the
    same way the dead one did."""
    srv, sched = _deployment()
    policy = GuardPolicy(on_nonfinite="retry_f32", max_retries=3,
                         backoff_base_s=0.002)
    srv.set_guard("a", policy)
    snapshot_server(srv, tmp_path, 1, scheduler=sched)
    simulate_worker_death()
    srv2, _ = recover_server(tmp_path, device="cpu")
    assert srv2.guard_for("a") == policy
    assert srv2.guard_for("b") is None


def test_recovery_manager_watchdog_detects_silence(tmp_path):
    EVENTS.clear()
    srv, sched = _deployment()
    died = []
    mgr = RecoveryManager(srv, tmp_path, scheduler=sched,
                          heartbeat_timeout_s=0.05,
                          on_death=lambda: died.append(1))
    try:
        deadline = time.monotonic() + 2.0
        while not died and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        mgr.stop()
    assert died
    assert EVENTS.recent(kind="recovery.heartbeat_lost")


def test_degrade_on_one_device_raises_as_the_reference(tmp_path):
    srv, sched = _deployment()
    mgr = RecoveryManager(srv, tmp_path, scheduler=sched)
    with pytest.raises(ValueError, match="mesh-mode only"):
        mgr.degrade(0)
    j = JServer(JBudget(vpu_ops_budget=15_000_000))
    with pytest.raises(ValueError, match="mesh-mode only"):
        j.on_device_loss(0)


def test_degrade_rearms_the_watchdog(tmp_path):
    """The heartbeat path's lighter alternative: degrade() shrinks the
    mesh in place and re-arms, so a second silence still fires."""
    from repro_torch.core.resources import MeshSpec

    srv = AdaptiveServer(DEVICE, max_batch=2, mesh=MeshSpec(devices=2),
                         device="cpu")
    srv.register("a", _frontend(0), (12, 12, 6))
    srv.arbiter.observe("a", 100.0)
    srv._apply_shares(srv.arbiter.split())
    died = []
    holder = {}

    def on_death():
        died.append(1)
        holder["mgr"].watchdog.stop()

    mgr = RecoveryManager(srv, tmp_path, heartbeat_timeout_s=0.05,
                          on_death=on_death)
    holder["mgr"] = mgr
    try:
        deadline = time.monotonic() + 2.0
        while not died and time.monotonic() < deadline:
            time.sleep(0.01)
        assert died == [1]
        affected = mgr.degrade(1)        # silence treated as device loss
        assert affected == ["a"]
        assert srv.mesh.devices == 1
        assert mgr.watchdog._thread.is_alive()
        deadline = time.monotonic() + 2.0
        while len(died) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(died) == 2
    finally:
        mgr.stop()


def test_degraded_mesh_server_recovers_on_its_shrunk_mesh(tmp_path):
    """A mesh server that lost a device snapshots its shrunk mesh; the
    recovered server re-derives its device grants on it, plans with zero
    cold plans and serves the next wave bitwise as the pre-crash server
    does."""
    from repro_torch.core.resources import MeshSpec

    srv = AdaptiveServer(DEVICE, max_batch=2, mesh=MeshSpec(devices=4),
                         device="cpu")
    srv.register("a", _frontend(0), (12, 12, 6))
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=SHAPE).astype(np.float32) for _ in range(4)]
    for x in xs[:2]:
        srv.submit("a", x)
    assert all(c.ok for c in srv.drain())
    assert srv.on_device_loss(3) == ["a"]
    # 3 survivors; the grant snaps down the degree ladder of 4
    assert srv.mesh.devices == 3 and srv.arbiter.devices_for("a") == 2
    for x in xs[:2]:
        srv.submit("a", x)
    before_wave = srv.drain()
    snapshot_server(srv, tmp_path, 1)
    simulate_worker_death()
    misses = STATS.plan_misses
    rec, _ = recover_server(tmp_path, device="cpu")
    assert rec.mesh == srv.mesh
    # the wave after the loss re-split the 3 survivors: 3 devices, as the
    # recovered arbiter re-derives them on the snapshot's mesh
    assert rec.arbiter.devices_for("a") == srv.arbiter.devices_for("a") == 3
    for x in xs[:2]:
        rec.submit("a", x)
    after_wave = rec.drain()
    assert cold_replans_since(misses) == 0
    for a, b in zip(after_wave, before_wave):
        assert torch.equal(a.result, b.result)


def test_arbiter_state_round_trips():
    srv, sched = _deployment()
    _wave(sched, np.random.default_rng(0))
    state = srv.arbiter.state_dict()
    other, _ = _deployment()
    other.arbiter.load_state(json.loads(json.dumps(state)))
    assert other.arbiter.state_dict() == state
    bad = dict(state, floors=dict(state["floors"], ghost=0.1))
    with pytest.raises(ValueError, match="unregistered tenants"):
        other.arbiter.load_state(bad)


def test_plan_cache_export_import_round_trip():
    srv, sched = _deployment()
    _wave(sched, np.random.default_rng(0))
    state = export_plan_cache()
    assert state["plans"] and state["shares"]
    clear_plan_cache()
    assert plan_cache_stats()["size"] == 0
    n = import_plan_cache(json.loads(json.dumps(state)))
    assert n == len(state["plans"])
    assert json.dumps(export_plan_cache(), sort_keys=True) == \
        json.dumps(state, sort_keys=True)
    t = srv.tenants["a"]
    specs = srv._specs(t.params, (4,) + SHAPE, "float32", t.pool_window,
                       t.activation, t.ladder)
    assert plan_cache_contains(specs, DEVICE, fuse=True)
    assert not plan_cache_contains(specs, DEVICE.scaled(0.123), fuse=True)


# --------------------------------------------------------------------------
# Across the packages
# --------------------------------------------------------------------------
J_DEVICE = JBudget(vpu_ops_budget=15_000_000)


def _j_params():
    return {"a": j_init(jax.random.PRNGKey(0), channels=(6, 12), d_model=16),
            "b": j_init(jax.random.PRNGKey(1), channels=(6, 12),
                        d_model=16)}


def _t_params(jp):
    return {k: params_from_numpy(jax.tree_util.tree_map(np.asarray, v),
                                 device="cpu") for k, v in jp.items()}


def _j_deployment(jp):
    srv = JServer(J_DEVICE, policy="demand", max_batch=4)
    sched = JScheduler(srv)
    sched.register("a", jp["a"], SHAPE,
                   slo=JSLOSpec(deadline_s=60.0, priority=1))
    sched.register("b", jp["b"], SHAPE, slo=JSLOSpec(deadline_s=120.0))
    return srv, sched


def _t_deployment(tp):
    srv = AdaptiveServer(DEVICE, policy="demand", max_batch=4, device="cpu")
    sched = SLOScheduler(srv)
    sched.register("a", tp["a"], SHAPE,
                   slo=SLOSpec(deadline_s=60.0, priority=1))
    sched.register("b", tp["b"], SHAPE, slo=SLOSpec(deadline_s=120.0))
    return srv, sched


def test_export_plan_cache_is_byte_equal_to_the_reference():
    jp = _j_params()
    j_clear()
    jsrv, jsched = _j_deployment(jp)
    _wave(jsched, np.random.default_rng(0))
    _wave(jsched, np.random.default_rng(1), n=3)
    clear_plan_cache()
    tsrv, tsched = _t_deployment(_t_params(jp))
    _wave(tsched, np.random.default_rng(0))
    _wave(tsched, np.random.default_rng(1), n=3)
    got = json.dumps(export_plan_cache(), sort_keys=True)
    assert got == json.dumps(j_export(), sort_keys=True)
    assert len(json.loads(got)["plans"]) > 2


def _same_wave(tcomps, jcomps):
    tcomps = sorted(tcomps, key=lambda c: c.rid)
    jcomps = sorted(jcomps, key=lambda c: c.rid)
    assert [(c.rid, c.tenant, c.ok, c.finished) for c in tcomps] == \
        [(c.rid, c.tenant, c.ok, c.finished) for c in jcomps]
    for t, j in zip(tcomps, jcomps):
        np.testing.assert_allclose(t.result.numpy(), np.asarray(j.result),
                                   rtol=1e-4, atol=1e-5)


def test_reference_snapshot_recovers_in_the_port(tmp_path):
    """An f32 snapshot of the reference's deployment (two waves served,
    so the demand EWMA sits at the mix's fixed point) recovers in the
    port with zero cold plans, and the port's first wave after it equals
    the reference's own recovered server's."""
    jp = _j_params()
    j_clear()
    jsrv, jsched = _j_deployment(jp)
    _wave(jsched, np.random.default_rng(0))
    _wave(jsched, np.random.default_rng(0))
    j_snapshot(jsrv, tmp_path, 1, scheduler=jsched)
    clear_plan_cache()
    before = STATS.plan_misses
    tsrv, tsched = recover_server(tmp_path, device="cpu")
    assert tsched is not None and tsrv.device.type == "cpu"
    assert set(tsched.slos) == {"a", "b"}
    for name, t in tsrv.tenants.items():
        assert t.granted == jsrv.tenants[name].granted
        for tl, jl in zip(jax.tree_util.tree_leaves(
                {"b": [x["w"] for x in t.params["blocks"]],
                 "p": t.params["proj"]}),
                jax.tree_util.tree_leaves(
                {"b": [x["w"] for x in jp[name]["blocks"]],
                 "p": jp[name]["proj"]})):
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    tcomps = _wave(tsched, np.random.default_rng(2))
    assert cold_replans_since(before) == 0
    j_clear()
    jsrv2, jsched2 = j_recover(tmp_path)
    _same_wave(tcomps, _wave(jsched2, np.random.default_rng(2)))


def test_port_snapshot_reads_in_the_reference(tmp_path):
    srv, sched = _deployment()
    _wave(sched, np.random.default_rng(0))
    snapshot_server(srv, tmp_path, 3, scheduler=sched)
    tree, extra = j_restore_blind(tmp_path)
    assert extra["tenant_order"] == ["a", "b"]
    assert extra["server"]["device"] == "cpu"
    assert "interpret" not in extra["server"]
    for name, t in srv.tenants.items():
        np.testing.assert_array_equal(np.asarray(tree[name]["proj"]),
                                      t.params["proj"].numpy())
        for jb, tb in zip(tree[name]["blocks"], t.params["blocks"]):
            np.testing.assert_array_equal(np.asarray(jb["w"]),
                                          tb["w"].numpy())


def _bf16_params(key):
    p = _frontend(key)
    return {"blocks": [{"w": b["w"].to(torch.bfloat16)}
                       for b in p["blocks"]],
            "proj": p["proj"].to(torch.bfloat16)}


def test_bf16_tenant_round_trips_bitwise(tmp_path):
    srv = AdaptiveServer(DEVICE, max_batch=4, device="cpu")
    srv.register("a", _bf16_params(3), SHAPE)
    srv.register("b", _frontend(4), SHAPE)
    x = np.random.default_rng(0).normal(size=(2,) + SHAPE)
    srv.submit("a", torch.as_tensor(x, dtype=torch.bfloat16))
    srv.submit("b", x.astype(np.float32))
    first = {c.rid: c.result for c in srv.step()}
    snapshot_server(srv, tmp_path, 1)
    manifest = json.loads((tmp_path / "step_000000001" /
                           "manifest.json").read_text())
    assert "bfloat16" in {leaf["dtype"] for leaf in manifest["leaves"]}
    simulate_worker_death()
    before = STATS.plan_misses
    srv2, _ = recover_server(tmp_path, device="cpu")
    for name in ("a", "b"):
        p, q = srv.tenants[name].params, srv2.tenants[name].params
        for u, v in [(p["proj"], q["proj"])] + [
                (a["w"], b["w"]) for a, b in zip(p["blocks"], q["blocks"])]:
            assert u.dtype == v.dtype and torch.equal(
                u.view(torch.int16) if u.dtype == torch.bfloat16 else u,
                v.view(torch.int16) if v.dtype == torch.bfloat16 else v)
    srv2.submit("a", torch.as_tensor(x, dtype=torch.bfloat16))
    srv2.submit("b", x.astype(np.float32))
    again = {c.rid: c.result for c in srv2.step()}   # rids restart at 0
    assert cold_replans_since(before) == 0
    for rid, y in first.items():
        assert torch.equal(y, again[rid])


def test_restore_takes_the_targets_dtype_and_device(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "h": [torch.tensor([1.5, -2.25], dtype=torch.bfloat16), None],
            "n": np.ones(3, np.int32)}
    save(tmp_path, 5, tree, extra={"x": 1})
    target = {"w": torch.zeros((2, 3), dtype=torch.float64),
              "h": [torch.zeros(2, dtype=torch.bfloat16), None],
              "n": np.zeros(3, np.int64)}
    got, extra = restore(tmp_path, target)
    assert extra == {"x": 1}
    assert got["w"].dtype == torch.float64 and torch.equal(
        got["w"], tree["w"].double())
    assert got["h"][1] is None and torch.equal(got["h"][0], tree["h"][0])
    assert got["n"].dtype == np.int64 and (got["n"] == 1).all()
    blind, _ = restore_blind(tmp_path)
    assert blind["h"][0].dtype == torch.bfloat16
    assert torch.equal(blind["h"][0], tree["h"][0])
