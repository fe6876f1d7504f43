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

Pure Python; deterministic given the observation sequence.  Mesh mode
(whole-device grants, device loss) is ROADMAP queue 1, item 9: a
``mesh=`` of more than one device raises ``NotImplementedError``.  The
SLO scheduler's inputs (miss-rate pressure, preemption, grant
quantization) come with the scheduler (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

import dataclasses
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
                 mesh: Optional[MeshSpec] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; have {POLICIES}")
        if not 0.0 < demand_alpha <= 1.0:
            raise ValueError("demand_alpha must be in (0, 1]")
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
        self._floors: Dict[str, float] = {}
        self._demand: Dict[str, float] = {}
        self._pending: Dict[str, float] = {}
        self._granted: Dict[str, float] = {}
        self.rebalances = 0

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

    def observe(self, name: str, cost: float) -> None:
        """Record submitted work (est-cycles) for one tenant; folded
        into the demand EWMA at the next ``split()``."""
        self._pending[name] += float(cost)

    def _targets(self) -> Dict[str, float]:
        names = list(self._floors)
        n = len(names)
        if self.policy == "static":
            return {m: 1.0 / n for m in names}
        total_floor = sum(self._floors.values())
        total_demand = sum(self._demand.values())
        if total_demand <= 0.0:
            raw = {m: 1.0 / n for m in names}
        else:
            raw = {m: self._demand[m] / total_demand for m in names}
        surplus = max(0.0, 1.0 - total_floor)
        return {m: self._floors[m] + surplus * raw[m] for m in names}

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

    def shares(self) -> Dict[str, TenantShare]:
        """The current grants as ``TenantShare`` rows without folding
        pending observations."""
        return {m: TenantShare(name=m, demand=self._demand[m],
                               floor=self._floors[m],
                               fraction=self._granted.get(m, 0.0))
                for m in self._floors}

    def budget_for(self, name: str) -> ResourceBudget:
        """The budget slice currently granted to ``name``."""
        if name not in self._granted:
            raise KeyError(f"tenant {name!r} has no grant yet "
                           f"(call split() first)")
        return self.budget.scaled(self._granted[name])
