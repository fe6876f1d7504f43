"""Budget arbitration across co-resident tenants.

The paper sizes ONE network against the device's resources; a serving
deployment runs several at once.  The arbiter is ``plan_network``'s
partitioning logic lifted one level: the device ``ResourceBudget`` is
split across registered tenants proportional to *observed demand* (an
EWMA of the work each tenant submits), with every tenant floored at the
minimal fraction its network can still plan under
(``core.plan.network_min_fraction``).  Because that floor descends each
site's precision ladder, a tenant squeezed below its f32 footprint is
granted a slice where it *degrades to int16/int8* instead of failing —
the paper's resource-driven adaptation, made dynamic.

Hysteresis: grants only move when some tenant's target drifts more than
``rebalance_threshold`` from its current grant.  Every rebalance makes
the server re-plan its tenants under the new slices
(``core.plan.replan``), so the threshold is the knob trading
steady-state optimality against re-plan churn.

The SLO scheduler (``runtime/scheduler.py``) feeds it: ``record_outcome``
folds deadline misses into a per-tenant EWMA that ``slo_pressure``
multiplies into the demand weights, ``preempt`` moves a grant on the
spot, and ``grant_quantum`` snaps grants to a grid so the plan cache
sees few distinct budgets.

``state_dict`` / ``load_state`` carry the arbitration state across a
restart (``runtime/recovery.py``); the mesh itself travels in the
server's snapshot, and ``load_state`` re-derives the device grants on
it.

Pure Python; deterministic given the observation sequence.
**Mesh mode** (``mesh=`` a ``MeshSpec`` with devices > 1): the arbiter
grants *device slices* — disjoint sets of whole devices — instead of
fractions of one chip.  Demand still drives the split, but grants are
integers (largest-remainder rounding, every tenant floored at one whole
device), ``budget_for`` returns the FULL per-device budget (a granted
device is not shared), and ``mesh_for``/``device_slice`` expose the
per-tenant sub-mesh the server plans and executes against
(``core.plan.plan_network(mesh=...)``).  Admission rejects more tenants
than devices — a tenant cannot hold less than one chip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.core.resources import MeshSpec, ResourceBudget
from repro_torch.core.shard import degree_ladder
from repro_torch.obs.trace import NOOP_SPAN, TRACER, log_event

POLICIES = ("demand", "static")


@dataclasses.dataclass(frozen=True)
class TenantShare:
    """One tenant's slice of the device at one arbitration round."""

    name: str
    demand: float       # EWMA of submitted work (est-cycles)
    floor: float        # minimal feasible fraction (ladder included)
    fraction: float     # granted fraction of the device budget
    devices: int = 0    # mesh mode: whole devices granted (0 = no mesh)


class BudgetArbiter:
    """Splits one device budget across tenants; see module docstring.

    ``policy="demand"`` is the headline arbitration;
    ``policy="static"`` grants an even 1/n split regardless of demand
    or floors — the baseline.
    """

    def __init__(self, budget: Optional[ResourceBudget] = None, *,
                 policy: str = "demand", rebalance_threshold: float = 0.05,
                 demand_alpha: float = 0.5, calibration=None,
                 mesh: Optional[MeshSpec] = None,
                 slo_pressure: float = 0.0, miss_alpha: float = 0.5,
                 grant_quantum: float = 0.0):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; have {POLICIES}")
        if not 0.0 < demand_alpha <= 1.0:
            raise ValueError("demand_alpha must be in (0, 1]")
        if slo_pressure < 0.0:
            raise ValueError("slo_pressure must be >= 0")
        if not 0.0 < miss_alpha <= 1.0:
            raise ValueError("miss_alpha must be in (0, 1]")
        if not 0.0 <= grant_quantum < 1.0:
            raise ValueError("grant_quantum must be in [0, 1)")
        self.budget = budget or ResourceBudget()
        self.policy = policy
        # Mesh mode: grants are whole-device slices of this mesh; None
        # (or one device) keeps the fractional single-chip behavior.
        self.mesh = mesh if (mesh is not None and mesh.devices > 1) else None
        self._devices: Dict[str, int] = {}
        # The unit the demand EWMA is denominated in: with a fitted
        # CalibrationTable the server prices each tenant's unit cost in
        # *calibrated* cycles, so grants track measured work, not the
        # analytical estimate.  Kept here so ``calibration_key`` in
        # telemetry names the model the grants were computed under.
        self.calibration = calibration
        self.rebalance_threshold = rebalance_threshold
        self.demand_alpha = demand_alpha
        # SLO pressure: a tenant's demand weight is multiplied by
        # (1 + slo_pressure * deadline-miss-rate EWMA), so grants chase
        # *deadlines missed*, not just work submitted (0.0 = off — the
        # pre-SLO demand arbiter, and what plain AdaptiveServer uses).
        self.slo_pressure = slo_pressure
        self.miss_alpha = miss_alpha
        # Grant quantization: targets snap DOWN to multiples of
        # ``grant_quantum`` (never below a tenant's floor), so grants —
        # and therefore the ``ResourceBudget`` slices the server plans
        # under — take at most 1/quantum distinct values per tenant
        # instead of a fresh float per EWMA fold.  That bounds the plan
        # cache's key cardinality: steady-state traffic re-plans into
        # cache hits rather than minting a new budget key (and a new
        # compile) every rebalance.  0.0 = off (exact targets).
        self.grant_quantum = grant_quantum
        self._floors: Dict[str, float] = {}
        self._demand: Dict[str, float] = {}
        self._pending: Dict[str, float] = {}
        self._granted: Dict[str, float] = {}
        self._miss_rate: Dict[str, float] = {}
        self.rebalances = 0
        self.preemptions = 0

    def register(self, name: str, floor: float = 0.0) -> None:
        """Admit one tenant.  Validates the whole tenant set *before*
        mutating any state, so a rejected registration leaves no ghost
        entry behind."""
        if name in self._floors:
            raise ValueError(f"tenant {name!r} already registered")
        if self.mesh is not None and len(self._floors) >= self.mesh.devices:
            raise ValueError(
                f"mesh has {self.mesh.devices} devices and every tenant "
                f"holds at least one whole device; cannot admit "
                f"{name!r} as tenant #{len(self._floors) + 1}")
        floor = min(max(float(floor), 0.0), 1.0)
        floors = {**self._floors, name: floor}
        if self.policy == "demand":
            total = sum(floors.values())
            if total > 1.0 + 1e-9:
                raise ValueError(
                    f"tenant floors jointly need {total:.3f}x the device "
                    f"budget — co-residency infeasible even at the "
                    f"narrowest ladder rungs: {floors}")
        else:
            # static grants an unconditional 1/n: a tenant whose floor
            # exceeds that can never serve — reject at admission, same
            # honesty as the demand-policy joint check.
            even = 1.0 / len(floors)
            bad = {m: f for m, f in floors.items() if f > even + 1e-9}
            if bad:
                raise ValueError(
                    f"static even split grants {even:.3f} per tenant, "
                    f"below the minimal feasible fraction of: {bad}")
        self._floors[name] = floor
        self._demand[name] = 0.0
        self._pending[name] = 0.0
        self._miss_rate[name] = 0.0

    def observe(self, name: str, cost: float) -> None:
        """Record submitted work (est-cycles) for one tenant; folded
        into the demand EWMA at the next ``split()``."""
        self._pending[name] += float(cost)

    def record_outcome(self, name: str, *, served: int, missed: int) -> None:
        """Fold one dispatch round's deadline outcomes into the
        tenant's miss-rate EWMA (``missed`` counts late completions AND
        shed requests; ``served`` counts everything that left the queue
        this round).  With ``slo_pressure > 0`` the EWMA multiplies the
        tenant's demand weight at the next ``split()`` — deadline
        misses, not just submitted work, set the grants."""
        if name not in self._floors:
            raise KeyError(f"tenant {name!r} is not registered")
        rate = min(max(float(missed) / max(served, 1), 0.0), 1.0)
        a = self.miss_alpha
        self._miss_rate[name] = (1 - a) * self._miss_rate[name] + a * rate

    def miss_rate(self, name: str) -> float:
        """The tenant's current deadline-miss-rate EWMA."""
        return self._miss_rate.get(name, 0.0)

    def _targets(self) -> Dict[str, float]:
        names = list(self._floors)
        n = len(names)
        if self.policy == "static":
            return {m: 1.0 / n for m in names}
        total_floor = sum(self._floors.values())
        weight = {m: self._demand[m]
                  * (1.0 + self.slo_pressure * self._miss_rate[m])
                  for m in names}
        total_weight = sum(weight.values())
        if total_weight <= 0.0:
            raw = {m: 1.0 / n for m in names}
        else:
            raw = {m: weight[m] / total_weight for m in names}
        surplus = max(0.0, 1.0 - total_floor)
        targets = {m: self._floors[m] + surplus * raw[m] for m in names}
        return self._quantize(targets)

    def _quantize(self, targets: Dict[str, float]) -> Dict[str, float]:
        """Snap each target down to the ``grant_quantum`` grid, floored
        at the tenant's minimal feasible fraction.  Rounding down keeps
        the sum feasible (never exceeds the un-quantized total); a
        target that rounds below its floor lands ON the floor — itself
        a recurring, cache-friendly value."""
        q = self.grant_quantum
        if q <= 0.0:
            return targets
        return {m: max(self._floors[m], q * math.floor(t / q + 1e-9))
                for m, t in targets.items()}

    def split(self) -> Dict[str, TenantShare]:
        """Fold pending observations into the EWMA and (re)grant.

        The first call always grants; later calls move the grants only
        when some tenant's target drifted more than
        ``rebalance_threshold`` from its current grant (then every
        grant snaps to target, counted in ``rebalances``).  A change in
        the tenant *set* (a registration since the last round) always
        re-grants — hysteresis only ever holds a split that covers
        every current tenant.
        """
        if not self._floors:
            return {}
        with (TRACER.span("arbiter.split", "arbiter",
                          {"tenants": len(self._floors)})
              if TRACER.enabled else NOOP_SPAN):
            return self._split()

    def _split(self) -> Dict[str, TenantShare]:
        a = self.demand_alpha
        for name, pend in self._pending.items():
            self._demand[name] = (1 - a) * self._demand[name] + a * pend
            self._pending[name] = 0.0
        targets = self._targets()
        if set(self._granted) != set(targets):
            was_granted = bool(self._granted)
            self._granted = dict(targets)
            if was_granted:
                self.rebalances += 1
                log_event("arbiter.rebalance", cause="tenant_set",
                          tenants=len(targets), total=self.rebalances)
        elif any(abs(targets[m] - self._granted[m])
                 > self.rebalance_threshold for m in targets):
            self._granted = dict(targets)
            self.rebalances += 1
            log_event("arbiter.rebalance", cause="drift",
                      threshold=self.rebalance_threshold,
                      tenants=len(targets), total=self.rebalances)
        self._devices = self._device_grants(self._granted)
        return {m: TenantShare(name=m, demand=self._demand[m],
                               floor=self._floors[m],
                               fraction=self._granted[m],
                               devices=self._devices.get(m, 0))
                for m in self._floors}

    def _device_grants(self, granted: Dict[str, float],
                       devices: Optional[int] = None) -> Dict[str, int]:
        """Mesh mode: the fractional grants rounded to whole devices —
        every tenant floored at ONE device, the rest split by largest
        remainder (deterministic: remainder then name).  Empty when not
        in mesh mode.  ``devices=`` overrides the pool size (the
        device-loss path previews grants on the shrunk mesh)."""
        if self.mesh is None or not granted:
            return {}
        d = devices if devices is not None else self.mesh.devices
        names = list(granted)
        spare = d - len(names)
        raw = {m: max(granted[m] * d - 1.0, 0.0) for m in names}
        total = sum(raw.values())
        if total <= 0.0 or spare <= 0:
            ideal = {m: 0.0 for m in names}
        else:
            ideal = {m: raw[m] / total * spare for m in names}
        grant = {m: 1 + int(ideal[m]) for m in names}
        left = d - sum(grant.values())
        order = sorted(names, key=lambda m: (-(ideal[m] - int(ideal[m])), m))
        for m in order[:left]:
            grant[m] += 1
        return grant

    def preempt(self, winner: str, victim: str) -> float:
        """Immediate grant transfer: squeeze ``victim`` to its floor
        and hand the freed fraction to ``winner`` — what a priority
        tenant does to a queued lower-priority bucket *instead of*
        out-bidding it through the demand EWMA (which takes rounds of
        hysteresis to move).  Bypasses the rebalance threshold, counts
        as a rebalance, and logs an ``arbiter.preempt`` event.  Returns
        the fraction that moved (0.0 when the victim already sat at its
        floor).  Fractional mode only — mesh grants are whole devices
        and re-slice through ``split()``."""
        if self.mesh is not None:
            raise ValueError("preempt() is fractional-mode only; mesh "
                             "grants move through split()")
        for m in (winner, victim):
            if m not in self._granted:
                raise KeyError(f"tenant {m!r} has no grant yet "
                               f"(call split() first)")
        freed = max(0.0, self._granted[victim] - self._floors[victim])
        if freed <= 0.0:
            return 0.0
        self._granted[victim] = self._floors[victim]
        self._granted[winner] += freed
        self.rebalances += 1
        self.preemptions += 1
        log_event("arbiter.preempt", winner=winner, victim=victim,
                  moved=freed, total=self.preemptions)
        return freed

    # -- degraded mesh (device loss) -----------------------------------------
    def _ladder_snap(self, raw: Dict[str, int],
                     prior: Dict[str, int]) -> Dict[str, int]:
        """Snap each tenant's shrunk device grant DOWN its degree ladder
        (largest divisor of the pre-loss grant that fits) so every batch
        shape that sharded before still shards on the degraded slice —
        correctness first, utilization second (leftover devices idle).
        Grants that grew (or held) pass through unchanged."""
        out = {}
        for name, g in raw.items():
            p = prior.get(name, g)
            if 0 < g < p:
                g = degree_ladder(p, survivors=g)[0]
            out[name] = g
        return out

    def degraded_grants(self, losses: int = 1) -> Dict[str, int]:
        """Pure preview of the whole-device grants after losing
        ``losses`` devices — what spare-plan pre-warming
        (``AdaptiveServer.prewarm_spares``) plans against *before* any
        fault fires.  No state moves."""
        if self.mesh is None:
            raise ValueError("degraded_grants() is mesh-mode only")
        survivors = self.mesh.devices - int(losses)
        if survivors < len(self._floors):
            raise ValueError(
                f"losing {losses} device(s) leaves {survivors} for "
                f"{len(self._floors)} tenants — every tenant holds at "
                f"least one whole device")
        raw = self._device_grants(self._granted, devices=survivors)
        return self._ladder_snap(raw, self._devices or raw)

    def on_device_loss(self, device: Optional[int] = None) -> list:
        """Shrink the mesh by one device and re-grant whole-device
        slices on the survivors — device loss handled as a budget shock.

        The pool size comes from ``fault_tolerance.choose_mesh_shape``
        (correctness-first: the usable pool is the best grid the
        survivors can still form against the pre-loss mesh) and each
        shrunk tenant descends its ``degree_ladder`` (largest divisor of
        its pre-loss grant), so surviving batch shapes keep sharding.
        Raises when fewer devices than tenants survive — degradation
        cannot evict.  Returns the tenants whose grant moved (the ones
        the server re-plans); logs ``mesh.degraded``."""
        if self.mesh is None:
            raise ValueError("on_device_loss() is mesh-mode only")
        survivors = self.mesh.devices - 1
        if survivors < len(self._floors):
            raise ValueError(
                f"degraded mesh has {survivors} device(s) for "
                f"{len(self._floors)} tenants — every tenant holds at "
                f"least one whole device; recover instead of degrading")
        from repro_torch.runtime.fault_tolerance import choose_mesh_shape
        data, model = choose_mesh_shape(survivors,
                                        prefer_model=self.mesh.devices)
        usable = max(data * model, len(self._floors))
        before = dict(self._devices)
        self.mesh = dataclasses.replace(self.mesh, devices=usable)
        raw = self._device_grants(self._granted, devices=usable)
        self._devices = self._ladder_snap(raw, before or raw)
        self.rebalances += 1
        affected = sorted(m for m in self._floors
                          if self._devices.get(m) != before.get(m))
        log_event("mesh.degraded",
                  lost=-1 if device is None else int(device),
                  devices=usable, affected=len(affected),
                  total=self.rebalances)
        return affected

    def shares(self) -> Dict[str, TenantShare]:
        """The current grants as ``TenantShare`` rows without folding
        pending observations (what ``split()`` already decided, plus
        any ``preempt()`` moves since)."""
        return {m: TenantShare(name=m, demand=self._demand[m],
                               floor=self._floors[m],
                               fraction=self._granted.get(m, 0.0),
                               devices=self._devices.get(m, 0))
                for m in self._floors}

    # -- persistence (plan-preserving restart) ------------------------------
    def state_dict(self) -> dict:
        """JSON-able snapshot of the arbitration state a restart must
        preserve: floors, demand/miss EWMAs, un-folded observations,
        and the current grants.  Restoring this (``load_state``) keeps
        post-restart budget slices bit-identical to pre-crash, so every
        tenant's first batch re-plans under the *same* slice and hits
        the imported plan cache."""
        return {
            "floors": dict(self._floors),
            "demand": dict(self._demand),
            "pending": dict(self._pending),
            "granted": dict(self._granted),
            "miss_rate": dict(self._miss_rate),
            "rebalances": self.rebalances,
            "preemptions": self.preemptions,
        }

    def load_state(self, state: dict) -> None:
        """Restore a ``state_dict`` snapshot.  Every snapshotted tenant
        must already be registered (registration re-derives the floor
        from the plan, which must match the snapshot — a drifted floor
        means the checkpoint belongs to a different deployment)."""
        missing = set(state["floors"]) - set(self._floors)
        if missing:
            raise ValueError(f"snapshot covers unregistered tenants: "
                             f"{sorted(missing)}")
        for name, floor in state["floors"].items():
            if abs(self._floors[name] - floor) > 1e-9:
                raise ValueError(
                    f"tenant {name!r} floor drifted: snapshot "
                    f"{floor:.6f} vs registered {self._floors[name]:.6f}")
        self._demand.update(state["demand"])
        self._pending.update(state["pending"])
        self._granted.update(state["granted"])
        self._devices = self._device_grants(self._granted)
        self._miss_rate.update(state.get("miss_rate", {}))
        self.rebalances = int(state.get("rebalances", self.rebalances))
        self.preemptions = int(state.get("preemptions", self.preemptions))

    def budget_for(self, name: str) -> ResourceBudget:
        """The budget slice currently granted to ``name``.  Mesh mode
        grants whole devices, so every tenant plans against the FULL
        per-device budget; its parallelism comes from ``mesh_for``."""
        if name not in self._granted:
            raise KeyError(f"tenant {name!r} has no grant yet "
                           f"(call split() first)")
        if self.mesh is not None:
            return self.budget
        return self.budget.scaled(self._granted[name])

    def devices_for(self, name: str) -> int:
        """Mesh mode: whole devices currently granted to ``name``."""
        if self.mesh is None:
            raise ValueError("arbiter is not in mesh mode")
        if name not in self._devices:
            raise KeyError(f"tenant {name!r} has no device grant yet "
                           f"(call split() first)")
        return self._devices[name]

    def mesh_for(self, name: str) -> MeshSpec:
        """The per-tenant sub-mesh: same axis and link bandwidth as the
        arbiter's mesh, sized to the tenant's device grant — what the
        server hands to ``plan_network(mesh=...)``."""
        return dataclasses.replace(self.mesh,
                                   devices=self.devices_for(name))

    def device_slice(self, name: str) -> Tuple[int, int]:
        """The contiguous [start, stop) device-index range granted to
        ``name`` (registration order) — the ranks of the server's device
        pool its execution runs on."""
        n = self.devices_for(name)
        start = 0
        for m in self._floors:
            if m == name:
                return (start, start + n)
            start += self._devices[m]
        raise KeyError(name)  # pragma: no cover — devices_for gates
