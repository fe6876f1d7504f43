"""Plan-preserving failure recovery for the serving runtime.

Replaces ``repro/runtime/recovery.py``: the same snapshot (the params
tree and the ``extra`` manifest, with the reference's keys), restore
order, events and errors.  One key differs: the reference's
``extra["server"]["interpret"]`` (Pallas interpret mode) is replaced by
``"device"``, the snapshotted server's device type (``"cuda"`` or
``"cpu"``), logged and not obeyed: ``recover_server(device=)`` decides
where the rebuilt server runs (None: ``cuda``, raising
``CudaUnavailableError`` without a card; never a quiet CPU fallback).
A snapshot with either key is read, so one written by the reference's
``snapshot_server`` recovers here.

Wires the previously orphaned fault-tolerance primitives into
``AdaptiveServer``: ``checkpoint/store.py`` persists the serving state,
``fault_tolerance.Watchdog`` detects the death, and this module's
restore path rebuilds a server whose **first post-crash batch re-plans
nothing cold** — the restart storm a naive recovery pays (every tenant's
selector re-running at once) is exactly what a deadline-bound deployment
cannot afford.

What a snapshot preserves (and why):

* tenant params + registration arguments — the checkpointed pytree and
  the ``extra`` manifest; recovery re-registers every tenant in the
  original order (order fixes mesh device slices).
* the **planner memo state** (``core.plan.export_plan_cache``): every
  cached ``NetworkPlan`` with its exact cache key, plus the ``replan``
  fast path's share/fuse memos.  Imported *before* re-registration, so
  even admission re-pricing hits the cache.
* the **arbiter state** (``BudgetArbiter.state_dict``): grants, demand
  and miss-rate EWMAs, un-folded observations.  Restoring grants
  bit-identical is what makes the first batch's slice budget — and
  therefore its plan-cache key — identical to pre-crash.
* the est-cycles clock, the SLO specs and scheduler counters, and the
  **calibration identity** (``calibration_key``) — the table itself is
  NOT serialized; the operator re-supplies it and recovery *validates*
  it against the snapshotted key (a different table would silently
  re-key every cached plan).

What a snapshot deliberately does NOT preserve: queued / in-flight
requests (a crash loses them; clients retry — their wall deadlines
would have expired during the outage anyway), telemetry windows, and
the wall clock (monotonic clocks do not survive a process).

``simulate_worker_death`` models the crash in one process: it clears
every in-memory planner memo — the state an actual process death
destroys — so the zero-cold-replan claim is tested against a genuinely
cold process, not a warm cache that happened to survive.  It leaves the
built CUDA library loaded: a restarted process loads the same build
from ``build/``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from repro_torch.checkpoint.store import restore_blind, save
from repro_torch.core.calibrate_cost import calibration_key
from repro_torch.core.plan import (STATS, clear_plan_cache,
                                   export_plan_cache, import_plan_cache)
from repro_torch.core.resources import MeshSpec, ResourceBudget
from repro_torch.obs.trace import log_event
from repro_torch.runtime.fault_tolerance import Watchdog
from repro_torch.runtime.guards import GuardPolicy
from repro_torch.runtime.scheduler import SLOScheduler
from repro_torch.runtime.server import AdaptiveServer


def _calkey_json(calibration):
    key = calibration_key(calibration)
    return list(key) if key is not None else None


def server_state(server: AdaptiveServer,
                 scheduler: Optional[SLOScheduler] = None) -> Tuple[dict, dict]:
    """(pytree, extra) for ``checkpoint.store.save``: the params tree
    keyed by tenant, and everything else as JSON-able ``extra``."""
    tree = {name: t.params for name, t in server.tenants.items()}
    extra = {
        "server": {
            "budget": dataclasses.asdict(server.budget),
            "policy": server.arbiter.policy,
            "rebalance_threshold": server.arbiter.rebalance_threshold,
            "max_batch": server.max_batch,
            "autotune": server.autotune,
            "device": server.device.type,
            "demand_alpha": server.arbiter.demand_alpha,
            "fuse": server.fuse,
            "mesh": (dataclasses.asdict(server.mesh)
                     if server.mesh is not None else None),
            "slo_pressure": server.arbiter.slo_pressure,
            "miss_alpha": server.arbiter.miss_alpha,
            "grant_quantum": server.arbiter.grant_quantum,
        },
        "tenant_order": list(server.tenants),
        "tenants": {
            name: {
                "input_shape": list(t.input_shape),
                "pool_window": list(t.pool_window),
                "activation": t.activation,
                "ladder": list(t.ladder),
                "measure_quant": t.measure_quant,
                "floor": t.floor,
                "unit_cost": t.unit_cost,
            } for name, t in server.tenants.items()
        },
        "arbiter": server.arbiter.state_dict(),
        "guards": {name: dataclasses.asdict(p)
                   for name, p in server._guards.items()},
        "plan_cache": export_plan_cache(),
        "calibration_key": _calkey_json(server.calibration),
        "clock": server.clock,
        "scheduler": scheduler.state_dict() if scheduler else None,
    }
    return tree, extra


def snapshot_server(server: AdaptiveServer, ckpt_dir: str, step: int, *,
                    scheduler: Optional[SLOScheduler] = None,
                    keep: int = 3) -> str:
    """Atomic-commit snapshot of the full serving state."""
    tree, extra = server_state(server, scheduler)
    path = save(ckpt_dir, step, tree, extra=extra, keep=keep)
    log_event("recovery.snapshot", step=step, tenants=len(tree),
              plans=len(extra["plan_cache"]["plans"]))
    return path


def recover_server(ckpt_dir: str, *, step: Optional[int] = None,
                   calibration=None, wall: Optional[Callable] = None,
                   device=None, devices=None,
                   ) -> Tuple[AdaptiveServer, Optional[SLOScheduler]]:
    """Rebuild (server, scheduler-or-None) from the latest committed
    snapshot so the first post-crash batch re-plans nothing cold.

    The restore order is the guarantee: plan-cache import FIRST (so
    re-registration's admission pricing hits the cache), tenants
    re-registered in the original order, then arbiter grants restored
    bit-identical (so the first batch's slice budget keys match).
    ``calibration`` must be the same table the snapshot was taken under
    — validated against the snapshotted ``calibration_key``.  The
    server and its params land on ``device`` (None: ``cuda``); a mesh
    server (the snapshot's mesh, shrunk if it degraded) runs its ranks
    on ``devices`` (``AdaptiveServer``'s pool, by default one card a
    rank).
    """
    params, extra = restore_blind(ckpt_dir, step=step)
    snap_key = extra.get("calibration_key")
    live_key = _calkey_json(calibration)
    if snap_key != live_key:
        raise ValueError(
            f"calibration mismatch: snapshot was taken under "
            f"{snap_key}, recovery was handed {live_key} — cached plans "
            f"would re-key cold")
    imported = import_plan_cache(extra["plan_cache"])
    cfg = extra["server"]
    mesh = MeshSpec(**cfg["mesh"]) if cfg["mesh"] is not None else None
    server = AdaptiveServer(
        ResourceBudget(**cfg["budget"]), policy=cfg["policy"],
        rebalance_threshold=cfg["rebalance_threshold"],
        max_batch=cfg["max_batch"], autotune=cfg["autotune"],
        demand_alpha=cfg["demand_alpha"],
        fuse=cfg["fuse"], calibration=calibration, mesh=mesh,
        device=device, devices=devices,
        slo_pressure=cfg.get("slo_pressure", 0.0),
        miss_alpha=cfg.get("miss_alpha", 0.5),
        grant_quantum=cfg.get("grant_quantum", 0.0))
    for name in extra["tenant_order"]:
        t = extra["tenants"][name]
        tenant = server.register(
            name, params[name], tuple(t["input_shape"]),
            pool_window=tuple(t["pool_window"]),
            activation=t["activation"], ladder=tuple(t["ladder"]),
            measure_quant=t["measure_quant"])
        if abs(tenant.floor - t["floor"]) > 1e-9:
            raise ValueError(
                f"tenant {name!r} floor drifted across restart: "
                f"snapshot {t['floor']:.6f} vs re-priced "
                f"{tenant.floor:.6f}")
    server.arbiter.load_state(extra["arbiter"])
    server._apply_shares(server.arbiter.shares())
    server.clock = float(extra.get("clock", 0.0))
    for name, p in extra.get("guards", {}).items():
        server.set_guard(name, GuardPolicy(**p))
    scheduler = None
    if extra.get("scheduler") is not None:
        scheduler = (SLOScheduler(server, wall=wall)
                     if wall is not None else SLOScheduler(server))
        scheduler.load_state(extra["scheduler"])
        scheduler.now = server.clock
    log_event("recovery.restore", tenants=len(extra["tenant_order"]),
              plans_imported=imported,
              cold_plans_during_restore=0)
    return server, scheduler


def simulate_worker_death() -> None:
    """Model a process crash: wipe every in-memory planner memo (what a
    real death destroys), so recovery is measured against a genuinely
    cold process.  The built CUDA library stays loaded: a restarted
    process would load the same build."""
    clear_plan_cache()
    log_event("recovery.death", simulated=True)


def cold_replans_since(misses_before: int) -> int:
    """Cold plans since a ``STATS.plan_misses`` reading — the quantity
    the zero-cold-replan guarantee is asserted on."""
    return STATS.plan_misses - misses_before


class RecoveryManager:
    """Watchdog-armed snapshot/restore loop around one server.

    ``beat()`` after every healthy dispatch; a missed heartbeat fires
    ``on_death`` (default: just an event — the harness decides whether
    to restart).  ``snapshot()`` persists, ``recover()`` rebuilds.  The
    manager survives its server: after ``simulate_worker_death`` +
    ``recover()`` it tracks the replacement.
    """

    def __init__(self, server: AdaptiveServer, ckpt_dir: str, *,
                 scheduler: Optional[SLOScheduler] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 on_death: Optional[Callable[[], None]] = None,
                 keep: int = 3):
        self.server = server
        self.scheduler = scheduler
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._step = 0
        self.watchdog = None
        self._heartbeat_timeout_s = heartbeat_timeout_s

        def _fire():
            log_event("recovery.heartbeat_lost",
                      timeout_s=heartbeat_timeout_s)
            if on_death is not None:
                on_death()
        self._fire = _fire
        if heartbeat_timeout_s is not None:
            self.watchdog = Watchdog(heartbeat_timeout_s, _fire).start()

    def beat(self) -> None:
        if self.watchdog is not None:
            self.watchdog.beat()

    def _rearm_watchdog(self) -> None:
        """Re-arm heartbeat monitoring after an adoption or a degrade:
        a live monitor thread just clears its latched ``fired``
        (``Watchdog.rearm``); a stopped one (the fire-once pattern
        joins its thread inside ``on_timeout``) is replaced — either
        way, a SECOND worker death after one recovery fires again."""
        if self._heartbeat_timeout_s is None:
            return
        wd = self.watchdog
        if wd is not None and wd._thread.is_alive():
            wd.rearm()
            return
        if wd is not None:
            wd.stop()
        self.watchdog = Watchdog(self._heartbeat_timeout_s,
                                 self._fire).start()

    def snapshot(self) -> str:
        self._step += 1
        return snapshot_server(self.server, self.ckpt_dir, self._step,
                               scheduler=self.scheduler, keep=self.keep)

    def recover(self, *, calibration=None,
                wall: Optional[Callable] = None,
                device=None, devices=None) -> AdaptiveServer:
        """Rebuild from the latest snapshot and adopt the replacement
        (``self.server`` / ``self.scheduler`` point at the new
        instances afterwards).  The heartbeat watchdog is re-armed —
        its ``fired`` latch cleared, its thread restarted if the first
        death stopped it — so a second worker death fires again."""
        self.server, self.scheduler = recover_server(
            self.ckpt_dir, calibration=calibration, wall=wall,
            device=device, devices=devices)
        if self.scheduler is not None:
            self.scheduler.recovery = self
        self._rearm_watchdog()
        return self.server

    def degrade(self, device: Optional[int] = None) -> list:
        """The heartbeat path's lighter-than-restore alternative: treat
        the silence as a lost device, shrink the mesh in place
        (``AdaptiveServer.on_device_loss``), and re-arm the watchdog so
        a SECOND failure still fires.  Returns the affected tenants.  On
        one device the server raises ``ValueError``, as the reference's
        does."""
        affected = self.server.on_device_loss(device)
        self._rearm_watchdog()
        return affected

    def stop(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
