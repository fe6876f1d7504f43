"""Budget arbitration across co-resident tenants (fractional, one device).

The paper sizes ONE network against the device's resources; a serving
deployment runs several at once.  The arbiter is ``plan_network``'s
partitioning logic lifted one level: the device ``ResourceBudget`` is
split across registered tenants proportional to *observed demand* (an
EWMA of the work each tenant submits), with every tenant floored at the
minimal fraction its network can still plan under
(``core.plan.network_min_fraction``).

Hysteresis: grants only move when some tenant's target drifts more than
``rebalance_threshold`` from its current grant.  Every rebalance makes
the server re-plan its tenants under the new slices
(``core.plan.replan``).

The SLO scheduler (``runtime/scheduler.py``) feeds it: ``record_outcome``
folds deadline misses into a per-tenant EWMA that ``slo_pressure``
multiplies into the demand weights, ``preempt`` moves a grant on the
spot, and ``grant_quantum`` snaps grants to a grid so the plan cache
sees few distinct budgets.

``state_dict`` / ``load_state`` carry the arbitration state across a
restart (``runtime/recovery.py``).

Pure Python; deterministic given the observation sequence.  Mesh mode
(whole-device grants, device loss, ``degraded_grants``) is ROADMAP
queue 1, item 9: a ``mesh=`` of more than one device raises
``NotImplementedError``, and ``on_device_loss`` on one device raises
the reference's ``ValueError`` (a guard turns it into a rejection).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.core.resources import MeshSpec, ResourceBudget
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
        if mesh is not None and mesh.devices > 1:
            raise NotImplementedError(
                "mesh-mode arbitration is not ported yet (ROADMAP queue 1, "
                "item 9)")
        self.budget = budget or ResourceBudget()
        self.policy = policy
        self.mesh = None
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
        # deadlines missed, not just work submitted (0.0 = off).
        self.slo_pressure = slo_pressure
        self.miss_alpha = miss_alpha
        # Grant quantization: targets snap DOWN to multiples of
        # ``grant_quantum`` (never below a tenant's floor), so the budget
        # slices the server plans under take at most 1/quantum values a
        # tenant and steady traffic re-plans into cache hits (0.0 = off).
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
            # exceeds that can never serve — reject at admission.
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
        tenant's demand weight at the next ``split()``."""
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
        the sum feasible; a target that rounds below its floor lands ON
        the floor."""
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
        the tenant set always re-grants.
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
        return self.shares()

    def preempt(self, winner: str, victim: str) -> float:
        """Immediate grant transfer: squeeze ``victim`` to its floor and
        hand the freed fraction to ``winner`` — what a priority tenant
        does to a queued lower-priority bucket instead of out-bidding it
        through the demand EWMA.  Bypasses the rebalance threshold,
        counts as a rebalance, and logs an ``arbiter.preempt`` event.
        Returns the fraction that moved (0.0 when the victim already sat
        at its floor)."""
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

    def on_device_loss(self, device: Optional[int] = None) -> list:
        """Shrink the mesh by one device and re-grant whole-device slices
        on the survivors.  Mesh mode only (ROADMAP queue 1, item 9): on
        one device there is nothing to shrink past, so it raises, as the
        reference's does without a mesh (``self.mesh`` is always None:
        the constructor refuses a mesh of more than one device)."""
        raise ValueError("on_device_loss() is mesh-mode only")

    def shares(self) -> Dict[str, TenantShare]:
        """The current grants as ``TenantShare`` rows without folding
        pending observations (what ``split()`` decided, plus any
        ``preempt()`` moves since)."""
        return {m: TenantShare(name=m, demand=self._demand[m],
                               floor=self._floors[m],
                               fraction=self._granted.get(m, 0.0))
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
        self._miss_rate.update(state.get("miss_rate", {}))
        self.rebalances = int(state.get("rebalances", self.rebalances))
        self.preemptions = int(state.get("preemptions", self.preemptions))

    def budget_for(self, name: str) -> ResourceBudget:
        """The budget slice currently granted to ``name``."""
        if name not in self._granted:
            raise KeyError(f"tenant {name!r} has no grant yet "
                           f"(call split() first)")
        return self.budget.scaled(self._granted[name])
