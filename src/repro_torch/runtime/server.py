"""AdaptiveServer — multi-tenant serving over the adaptive-IP planner.

Several registered CNN frontends ("tenants") share one device
``ResourceBudget``; a ``BudgetArbiter`` splits it proportional to
observed demand (floored at each tenant's minimal feasible fraction),
and when the split shifts the affected tenants are live re-planned
through ``core.plan.replan``.

Time model: latency is accounted in **estimated cycles**, the same cost
model the planner optimizes, so the port's latencies equal the
reference's exactly.  With ``calibration=`` (a fitted
``core.calibrate_cost.CalibrationTable``) both sides upgrade together:
plans are ranked by measured scale factors and the lane clock advances
by the same calibrated cycles, so grants, telemetry and the planner all
optimize the objective that was actually measured.  Each tenant owns a
serving lane: batches of a lane execute sequentially, a batch occupies
the lane for its plan's cost, and a request's latency is queue wait plus
service.  Numerics are real — every batch runs its planned kernels on
the server's device (``cuda`` unless the caller passes
``device="cpu"``).

Requests are shape-bucketed (``batching.py``): same-shaped samples of a
tenant stack into one planned execution, so repeat batch shapes hit the
plan cache with zero selector work.  With ``autotune=True`` the tunable
sites of each executed plan run sweep-chosen tilings
(``core.autotune.plan_tile_overrides``) instead of member defaults.

The SLO scheduler (``runtime/scheduler.py``) drives the same server per
launch: ``slo_pressure``, ``miss_alpha`` and ``grant_quantum`` pass to
the arbiter, ``_execute(deadline_budget_s=)`` carries the batch's
tightest remaining deadline, and ``metrics()`` folds the state into a
``MetricsRegistry``.  What the reference server also has comes in later
slices: fault seams, guards and recovery (ROADMAP queue 1, item 8,
part 2), mesh/sharded execution, device-loss degradation and spare-plan
pre-warming (item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.autotune import plan_tile_overrides
from repro_torch.core.calibrate_cost import calibration_key
from repro_torch.core.plan import (STATS, network_min_fraction, plan_network,
                                   replan)
from repro_torch.core.resources import ResourceBudget
from repro_torch.models.frontends import (apply_cnn_frontend,
                                          cnn_frontend_site_specs,
                                          resolve_device)
from repro_torch.obs.metrics import system_metrics
from repro_torch.obs.trace import NOOP_SPAN, TRACER, log_event
from repro_torch.quant.report import max_rel_error
from repro_torch.runtime.arbiter import BudgetArbiter, TenantShare
from repro_torch.runtime.batching import Request, ShapeBucketQueue
from repro_torch.runtime.telemetry import TenantTelemetry

_SIDE_CACHE_MAX = 256   # bound for the tile- and specs-caches


@dataclasses.dataclass
class Tenant:
    """One registered CNN frontend and its serving state."""

    name: str
    params: Any
    input_shape: Tuple[int, ...]        # per-sample (H, W, C)
    pool_window: Tuple[int, int]
    activation: str
    ladder: Tuple[int, ...]
    measure_quant: bool
    floor: float                        # min feasible device fraction
    unit_cost: float                    # est-cycles of one request, ample
    granted: float = 0.0                # current device fraction
    lane_free: float = 0.0              # when this lane next idles (cycles)
    telemetry: TenantTelemetry = None


@dataclasses.dataclass(frozen=True)
class Completion:
    """One served request: result + accounting.  ``ok=False`` means an
    execution guard gave the batch up (guards: ROADMAP queue 1, item 8,
    part 2); every completion of this slice is ``ok``."""

    rid: int
    tenant: str
    result: Any                         # (S, d_model) patch embeddings
    arrival: float
    finished: float
    batch_size: int
    ok: bool = True

    @property
    def latency(self) -> float:
        return self.finished - self.arrival


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)


class AdaptiveServer:
    """Admit, batch, arbitrate, re-plan, execute.  See module docstring.

    ``policy="demand"`` arbitrates; ``policy="static"`` is the even-split
    baseline.  ``autotune=True`` swaps member-default tilings for
    sweep-chosen ones on the tunable sites of every executed plan.
    ``device=None`` serves on ``cuda`` and raises
    ``CudaUnavailableError`` where there is none; ``device="cpu"`` runs
    the plain PyTorch versions.
    """

    def __init__(self, budget: Optional[ResourceBudget] = None, *,
                 policy: str = "demand", rebalance_threshold: float = 0.05,
                 max_batch: int = 4, autotune: bool = False,
                 demand_alpha: float = 0.5, fuse: bool = True,
                 calibration=None, device=None,
                 slo_pressure: float = 0.0, miss_alpha: float = 0.5,
                 grant_quantum: float = 0.0):
        self.device = resolve_device(device)
        self.budget = budget or ResourceBudget()
        # fuse (default True): every block the planner can fuse runs
        # conv->pool->act as ONE launch, falling back per block when the
        # fused footprint won't fit the tenant's slice.
        self.fuse = fuse
        # calibration: a fitted CalibrationTable prices every planning
        # decision, the demand weights, and the lane time model in
        # measured scale factors instead of the raw analytical cycles
        # (see core/calibrate_cost.py).  None keeps the analytical model.
        self.calibration = calibration
        # slo_pressure > 0 makes the arbiter chase deadline-miss EWMAs
        # on top of demand — only meaningful under the SLO scheduler
        # (``runtime/scheduler.py``), which feeds ``record_outcome``.
        self.arbiter = BudgetArbiter(self.budget, policy=policy,
                                     rebalance_threshold=rebalance_threshold,
                                     demand_alpha=demand_alpha,
                                     calibration=calibration,
                                     slo_pressure=slo_pressure,
                                     miss_alpha=miss_alpha,
                                     grant_quantum=grant_quantum)
        self.mesh = self.arbiter.mesh        # None: one device
        self.max_batch = max_batch
        self.autotune = autotune
        self.clock = 0.0
        self.tenants: Dict[str, Tenant] = {}
        self._queue = ShapeBucketQueue()
        self._shares: Dict[str, TenantShare] = {}
        self._tile_cache: Dict[tuple, dict] = {}
        # bucket key -> site specs: hot repeat buckets do not rebuild them
        self._specs_cache: Dict[tuple, tuple] = {}
        self._next_rid = 0

    # -- admission ----------------------------------------------------------
    def register(self, name: str, params, input_shape, *,
                 pool_window=(2, 2), activation: str = "relu",
                 ladder: Tuple[int, ...] = (),
                 measure_quant: bool = False) -> Tenant:
        """Register a CNN frontend as a tenant (its params move to the
        server's device).  ``measure_quant=True`` (with a ``ladder``)
        measures every batch's per-site quantization error against the
        family oracles and records the worst in the telemetry's
        ``max_quant_rel_err``; it costs the oracles' compute and one
        host sync per site.

        Prices the tenant up front: its *floor* (minimal feasible device
        fraction at max batch, ladder included) and its *unit cost*
        (est-cycles of a one-sample plan under the full device, the
        demand weight).  Raises the planner's error when the tenant
        cannot run even with the whole device to itself.
        """
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already registered")
        params = _to_device(params, self.device)
        input_shape = tuple(int(d) for d in input_shape)
        canonical = self._specs(params, (self.max_batch,) + input_shape,
                                "float32", pool_window, activation, ladder)
        # Both the max-batch and the one-sample graphs must plan under
        # the full device, and both plans warm the share cache for the
        # replan fast path.  The floor is priced on the unfused graph:
        # fusion-aware planning always falls back to the chain.
        plan_network(canonical, self.budget, fuse=self.fuse,
                     calibration=self.calibration)
        floor = network_min_fraction(canonical, self.budget)
        unit = plan_network(
            self._specs(params, (1,) + input_shape, "float32",
                        pool_window, activation, ladder),
            self.budget, fuse=self.fuse,
            calibration=self.calibration).calibrated_cycles(self.calibration)
        tenant = Tenant(name=name, params=params, input_shape=input_shape,
                        pool_window=tuple(pool_window), activation=activation,
                        ladder=tuple(ladder), measure_quant=measure_quant,
                        floor=floor, unit_cost=unit,
                        telemetry=TenantTelemetry(name=name,
                                                  max_batch=self.max_batch))
        self.arbiter.register(name, floor)
        self.tenants[name] = tenant
        return tenant

    @staticmethod
    def _specs(params, batch_shape, dtype, pool_window, activation, ladder):
        return tuple(cnn_frontend_site_specs(
            params, batch_shape, dtype, pool_window=tuple(pool_window),
            activation=activation, ladder=tuple(ladder)))

    def submit(self, name: str, x, *, at: Optional[float] = None):
        """Queue one sample (H, W, C) — numpy or tensor — or a
        (B, H, W, C) stack, queued as B independent requests, arriving
        at clock ``at`` (default: now).  Returns the request id (or list
        of ids)."""
        tenant = self.tenants[name]
        x = torch.as_tensor(x, device=self.device)
        if x.dim() == len(tenant.input_shape) + 1:
            return [self.submit(name, xi, at=at) for xi in x]
        if tuple(x.shape) != tenant.input_shape:
            raise ValueError(
                f"tenant {name!r} expects samples of shape "
                f"{tenant.input_shape}, got {tuple(x.shape)}")
        arrival = self.clock if at is None else float(at)
        rid = self._next_rid
        self._next_rid += 1
        self._queue.push(Request(rid=rid, tenant=name, x=x, arrival=arrival))
        self.arbiter.observe(name, tenant.unit_cost)
        return rid

    # -- serving ------------------------------------------------------------
    def step(self) -> List[Completion]:
        """One serving round: arbitrate, then drain every bucket."""
        if not self._queue:
            return []
        self._apply_shares(self.arbiter.split())
        completions: List[Completion] = []
        for key in self._queue.keys():
            while True:
                batch = self._queue.pop_batch(key, self.max_batch)
                if not batch:
                    break
                completions.extend(self._execute(batch))
        if completions:
            self.clock = max(self.clock,
                             max(c.finished for c in completions))
        return completions

    def _apply_shares(self, shares: Dict[str, TenantShare]) -> None:
        """Adopt one arbitration round's grants.  A moved grant re-plans
        the tenant's graphs on its next batch — counted as a re-plan
        when the tenant had already been granted before."""
        self._shares = shares
        for name, share in shares.items():
            t = self.tenants[name]
            if t.granted and abs(share.fraction - t.granted) > 1e-12:
                t.telemetry.replans += 1
            t.granted = share.fraction

    def drain(self, max_steps: int = 1000) -> List[Completion]:
        out: List[Completion] = []
        for _ in range(max_steps):
            if not self._queue:
                break
            out.extend(self.step())
        return out

    def _execute(self, batch: List[Request], *,
                 deadline_budget_s: Optional[float] = None
                 ) -> List[Completion]:
        """Run one batch of one tenant.  ``deadline_budget_s`` is the
        batch's tightest remaining wall budget (the SLO scheduler passes
        it); the execution guards of ROADMAP queue 1, item 8, part 2
        charge their retries against it, and nothing reads it yet."""
        with (TRACER.span("serve.execute", "serving",
                          {"tenant": batch[0].tenant,
                           "batch": len(batch)})
              if TRACER.enabled else NOOP_SPAN):
            return self._execute_batch(batch,
                                       deadline_budget_s=deadline_budget_s)

    def _attempt(self, tenant: Tenant, xb):
        """(Re)plan under the tenant's *current* slice and run the
        frontend.  Returns ``(y, plan, quant_err)``: the worst lowered
        site's relative error when the tenant measures it, else 0."""
        slice_budget = self.budget.scaled(tenant.granted)
        skey = (tenant.name, tuple(xb.shape), str(xb.dtype), tenant.ladder)
        specs = self._specs_cache.get(skey)
        if specs is None:
            specs = self._specs(tenant.params, xb.shape, xb.dtype,
                                tenant.pool_window, tenant.activation,
                                tenant.ladder)
            if len(self._specs_cache) >= _SIDE_CACHE_MAX:
                self._specs_cache.pop(next(iter(self._specs_cache)))
            self._specs_cache[skey] = specs
        plan = replan(specs, slice_budget, fuse=self.fuse,
                      calibration=self.calibration)
        tile_overrides = None
        if self.autotune:
            tkey = (specs, slice_budget)
            tile_overrides = self._tile_cache.get(tkey)
            if tile_overrides is None:
                tile_overrides = plan_tile_overrides(plan)
                if len(self._tile_cache) >= _SIDE_CACHE_MAX:
                    self._tile_cache.pop(next(iter(self._tile_cache)))
                self._tile_cache[tkey] = tile_overrides
        quant_report = ({} if (tenant.ladder and tenant.measure_quant)
                        else None)
        with (TRACER.span("kernel", "kernel",
                          {"tenant": tenant.name,
                           "launches": plan.total_launches})
              if TRACER.enabled else NOOP_SPAN):
            y = apply_cnn_frontend(tenant.params, xb, network=plan,
                                   pool_window=tenant.pool_window,
                                   activation=tenant.activation,
                                   ladder=tenant.ladder,
                                   quant_report=quant_report,
                                   tile_overrides=tile_overrides,
                                   fuse=self.fuse)
        quant_err = max_rel_error(quant_report) if quant_report else 0.0
        return y, plan, quant_err

    def _execute_batch(self, batch: List[Request], *,
                       deadline_budget_s: Optional[float] = None
                       ) -> List[Completion]:
        tenant = self.tenants[batch[0].tenant]
        xb = torch.stack([r.x for r in batch])
        hits0, misses0 = STATS.plan_hits, STATS.plan_misses
        y, plan, quant_err = self._attempt(tenant, xb)
        start = max(tenant.lane_free, max(r.arrival for r in batch))
        if TRACER.enabled:
            TRACER.instant(
                "batch.queue_wait", "serving",
                {"tenant": tenant.name,
                 "max_wait_cycles":
                     start - min(r.arrival for r in batch)})
        finish = start + plan.calibrated_cycles(self.calibration)
        tenant.lane_free = finish
        latencies = [finish - r.arrival for r in batch]
        tenant.telemetry.record_batch(
            len(batch), latencies, plan,
            cache_hits=STATS.plan_hits - hits0,
            cache_misses=STATS.plan_misses - misses0,
            quant_err=quant_err)
        return [Completion(rid=r.rid, tenant=r.tenant, result=y[i],
                           arrival=r.arrival, finished=finish,
                           batch_size=len(batch))
                for i, r in enumerate(batch)]

    def on_budget_shrink(self, fraction: float) -> None:
        """Mid-serving budget shock: the device budget scales to
        ``fraction`` of itself (every tenant's slice shrinks with it at
        its next batch — the precision ladder absorbs what the smaller
        envelope cannot fit)."""
        if not 0.0 < fraction <= 1.0:
            raise ValueError("fraction must be in (0, 1]")
        self.budget = self.budget.scaled(fraction)
        self.arbiter.budget = self.budget
        log_event("budget.shrunk", fraction=fraction)

    # -- observability ------------------------------------------------------
    def shares(self) -> Dict[str, TenantShare]:
        """The latest arbitration round's grants (empty before a step)."""
        return dict(self._shares)

    def pending(self) -> int:
        return len(self._queue)

    def queue_stats(self) -> Dict[str, int]:
        """Lifetime counters of the shape-bucket queue."""
        return self._queue.stats()

    def metrics(self, registry=None):
        """This server's state folded into a ``MetricsRegistry``
        (``repro_torch.obs.metrics``): planner/cache counters, event log,
        tracer stats, arbiter rebalances, and per-tenant telemetry.
        Render with ``.render()`` (Prometheus text) or ``.snapshot()``."""
        return system_metrics(server=self, registry=registry)

    def telemetry(self) -> Dict[str, dict]:
        """Per-tenant snapshot: latency percentiles (est-cycles), batch
        occupancy, precision mix, re-plans, plan-cache hit rate and the
        current grant/floor.  ``calibration_key`` identifies the cost
        model the plans and the time accounting were priced under (None =
        analytical)."""
        calkey = calibration_key(self.calibration)
        out = {}
        for name, t in self.tenants.items():
            snap = t.telemetry.snapshot()
            snap["granted_fraction"] = t.granted
            snap["floor_fraction"] = t.floor
            snap["unit_cost_cycles"] = t.unit_cost
            snap["calibration_key"] = calkey
            out[name] = snap
        return out
