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
``MetricsRegistry``.

Fault survival (``runtime/faults.py``, ``runtime/guards.py``): the
injector's seams sit where the reference's do — "execute" before a
batch plans (kernel exception, budget shrink, device loss), "output"
after the frontend (a NaN in a copy of the result), "lane" on the
service cycles (latency spike) — each one ``INJECTOR.enabled`` read
while disarmed.  A tenant with a ``GuardPolicy`` (``set_guard``) runs
its batches through ``execute_guarded``: screened, retried within the
batch's ``deadline_budget_s``, re-planned with the ladder off under
``on_nonfinite="retry_f32"``; a batch the guard gives up returns
``ok=False`` completions.  A CUDA launch failure or a kernel's refusal
of its operands is no injected fault: it propagates.  Recovery
(``runtime/recovery.py``) snapshots and rebuilds the server.

Mesh mode (``mesh=`` a ``MeshSpec`` of more than one device): the
arbiter grants whole-device slices, each batch plans with
``plan_network(mesh=<the tenant's sub-mesh>)``, and a plan that
batch-splits every site runs sharded: one Python process drives every
device (the reference's ``shard_map`` is single-controller too), each
device runs ``plan.device_plan()`` through ``apply_cnn_frontend`` on its
block of the batch, and the blocks are concatenated on the server's
device.  ``devices=`` is the pool the mesh's ranks map onto, one
``torch.device`` a rank: by default ``cuda:0 .. d-1`` when ``d`` cards
exist (``d`` CPU entries for ``device="cpu"``), else the reference's
``ValueError``; on one card the caller asks for logical devices by name
(``devices=("cuda:0",) * d``).  A device loss shrinks the mesh
(``on_device_loss``; the degree ladder descends), and
``prewarm_spares`` plans the post-loss grants ahead of the fault.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.autotune import plan_tile_overrides
from repro_torch.core.calibrate_cost import calibration_key
from repro_torch.core.plan import (STATS, network_min_fraction, plan_network,
                                   replan)
from repro_torch.core.resources import MeshSpec, ResourceBudget
from repro_torch.models.frontends import (apply_cnn_frontend,
                                          cnn_frontend_site_specs,
                                          resolve_device)
from repro_torch.obs.metrics import system_metrics
from repro_torch.obs.trace import NOOP_SPAN, TRACER, log_event
from repro_torch.quant.report import max_rel_error
from repro_torch.runtime.arbiter import BudgetArbiter, TenantShare
from repro_torch.runtime.batching import Request, ShapeBucketQueue
from repro_torch.runtime.faults import INJECTOR, InjectedFault
from repro_torch.runtime.guards import GuardPolicy, execute_guarded
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
    execution guard gave the batch up (``result`` is None; see
    ``runtime/guards.py``)."""

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
    the plain PyTorch versions.  ``mesh=`` / ``devices=``: mesh mode, see
    the module docstring.
    """

    def __init__(self, budget: Optional[ResourceBudget] = None, *,
                 policy: str = "demand", rebalance_threshold: float = 0.05,
                 max_batch: int = 4, autotune: bool = False,
                 demand_alpha: float = 0.5, fuse: bool = True,
                 calibration=None, device=None,
                 mesh: Optional[MeshSpec] = None, devices=None,
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
                                     calibration=calibration, mesh=mesh,
                                     slo_pressure=slo_pressure,
                                     miss_alpha=miss_alpha,
                                     grant_quantum=grant_quantum)
        # mesh: a MeshSpec with devices > 1 puts the arbiter in mesh
        # mode — tenants are granted whole-device slices and each batch
        # is planned with plan_network(mesh=<tenant sub-mesh>), so a
        # tenant holding several devices may serve *sharded* plans
        # (executed device by device when the layout is uniform; see
        # _attempt).  None keeps the fractional single-chip server.
        self.mesh = self.arbiter.mesh
        # the device pool the mesh's ranks run on (mesh mode only); a
        # device loss shrinks the mesh, never this pool
        self.devices = None
        if self.mesh is not None:
            # imported here: shard_exec imports runtime.faults, whose
            # package imports this module
            from repro_torch.distributed.shard_exec import mesh_devices
            self.devices = tuple(mesh_devices(
                self.mesh.devices, torch.empty(0, device=self.device),
                devices))
        # (tenant, device) -> the tenant's params on that device
        self._replicas: Dict[tuple, Any] = {}
        self.max_batch = max_batch
        self.autotune = autotune
        self.clock = 0.0
        self.tenants: Dict[str, Tenant] = {}
        self._queue = ShapeBucketQueue()
        self._shares: Dict[str, TenantShare] = {}
        # opt-in per-tenant survival policies (runtime/guards.py); a
        # tenant without one executes bare — faults propagate
        self._guards: Dict[str, GuardPolicy] = {}
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

    def set_guard(self, name: str,
                  policy: Optional[GuardPolicy]) -> None:
        """Opt tenant ``name`` into guarded execution (output screening
        + bounded deadline-aware retry; see ``runtime/guards.py``).
        ``None`` clears the policy — the tenant executes bare again and
        faults propagate to the caller."""
        if name not in self.tenants:
            raise KeyError(f"tenant {name!r} is not registered")
        if policy is None:
            self._guards.pop(name, None)
        else:
            self._guards[name] = policy

    def guard_for(self, name: str) -> Optional[GuardPolicy]:
        return self._guards.get(name)

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
        it); a guarded tenant's retries are charged against it."""
        with (TRACER.span("serve.execute", "serving",
                          {"tenant": batch[0].tenant,
                           "batch": len(batch)})
              if TRACER.enabled else NOOP_SPAN):
            return self._execute_batch(batch,
                                       deadline_budget_s=deadline_budget_s)

    def _route_execute_faults(self, tenant: Tenant) -> None:
        """Injection seam "execute": apply the faults due at this batch
        — device loss marks the corpse, budget shrink scales the device
        budget, a kernel exception raises (last, so co-scheduled faults
        still land)."""
        boom = None
        for f in INJECTOR.poll("execute", tenant.name):
            if f.kind == "device_loss":
                INJECTOR.lose(int(f.param))
            elif f.kind == "budget_shrink":
                self.on_budget_shrink(f.param if f.param > 0 else 0.5)
            elif f.kind == "kernel_exception":
                boom = InjectedFault(
                    f"injected kernel-launch failure "
                    f"(tenant {tenant.name!r})")
        if boom is not None:
            raise boom

    def _tenant_budget(self, tenant: Tenant):
        if self.mesh is not None:
            # mesh mode: the tenant holds whole devices — plan against
            # the FULL per-device budget and let the planner decide how
            # (whether) to shard across the granted sub-mesh.
            return (self.arbiter.budget_for(tenant.name),
                    self.arbiter.mesh_for(tenant.name))
        return self.budget.scaled(tenant.granted), None

    def _attempt(self, tenant: Tenant, xb, *, retry_f32: bool = False):
        """One execution attempt: route injected faults, (re)plan under
        the tenant's *current* slice and run the frontend.  Returns
        ``(y, plan, quant_err)``: the worst lowered site's relative error
        when the tenant measures it, else 0.  ``retry_f32=True`` plans
        with the precision ladder off (the guard's non-finite
        fallback)."""
        if INJECTOR.enabled:
            self._route_execute_faults(tenant)
        slice_budget, tenant_mesh = self._tenant_budget(tenant)
        ladder = () if retry_f32 else tenant.ladder
        skey = (tenant.name, tuple(xb.shape), str(xb.dtype), ladder)
        specs = self._specs_cache.get(skey)
        if specs is None:
            specs = self._specs(tenant.params, xb.shape, xb.dtype,
                                tenant.pool_window, tenant.activation,
                                ladder)
            if len(self._specs_cache) >= _SIDE_CACHE_MAX:
                self._specs_cache.pop(next(iter(self._specs_cache)))
            self._specs_cache[skey] = specs
        plan = replan(specs, slice_budget, fuse=self.fuse,
                      calibration=self.calibration, mesh=tenant_mesh)
        if INJECTOR.enabled and tenant_mesh is not None:
            INJECTOR.check_devices(*self.arbiter.device_slice(tenant.name))
        tile_overrides = None
        if self.autotune:
            tkey = (specs, slice_budget)
            tile_overrides = self._tile_cache.get(tkey)
            if tile_overrides is None:
                tile_overrides = plan_tile_overrides(plan)
                if len(self._tile_cache) >= _SIDE_CACHE_MAX:
                    self._tile_cache.pop(next(iter(self._tile_cache)))
                self._tile_cache[tkey] = tile_overrides
        quant_report = {} if (ladder and tenant.measure_quant) else None
        sharded = self._shardable(plan, xb)
        with (TRACER.span("kernel", "kernel",
                          {"tenant": tenant.name,
                           "launches": plan.total_launches,
                           "sharded": sharded})
              if TRACER.enabled else NOOP_SPAN):
            if sharded:
                y = self._run_frontend_sharded(
                    tenant, xb, plan, tile_overrides=tile_overrides)
            else:
                y = apply_cnn_frontend(tenant.params, xb, network=plan,
                                       pool_window=tenant.pool_window,
                                       activation=tenant.activation,
                                       ladder=ladder,
                                       quant_report=quant_report,
                                       tile_overrides=tile_overrides,
                                       fuse=self.fuse)
        if INJECTOR.enabled:
            y = INJECTOR.perturb_output("output", y, tenant.name)
        quant_err = max_rel_error(quant_report) if quant_report else 0.0
        return y, plan, quant_err

    def _execute_batch(self, batch: List[Request], *,
                       deadline_budget_s: Optional[float] = None
                       ) -> List[Completion]:
        tenant = self.tenants[batch[0].tenant]
        xb = torch.stack([r.x for r in batch])
        hits0, misses0 = STATS.plan_hits, STATS.plan_misses
        policy = self._guards.get(tenant.name)
        out: Dict[str, Any] = {}

        def attempt(retry_f32: bool = False):
            y, plan, qerr = self._attempt(tenant, xb, retry_f32=retry_f32)
            out["plan"], out["quant_err"] = plan, qerr
            return y

        if policy is None:
            y = attempt()
            report = None
        else:
            y, report = execute_guarded(
                attempt, policy, tenant=tenant.name,
                remaining_s=deadline_budget_s,
                on_device_loss=lambda e: self.on_device_loss(e.device))
            tenant.telemetry.guard_retries += report.retries
        if y is None:
            # the guard gave the batch up: failed completions, lane not
            # advanced, no record_batch (there is no plan bill to pay)
            if report.outcome == "shed":
                tenant.telemetry.guard_shed += len(batch)
            else:
                tenant.telemetry.guard_rejected += len(batch)
            start = max(tenant.lane_free, max(r.arrival for r in batch))
            return [Completion(rid=r.rid, tenant=r.tenant, result=None,
                               arrival=r.arrival, finished=start,
                               batch_size=len(batch), ok=False)
                    for r in batch]
        plan, quant_err = out["plan"], out["quant_err"]
        start = max(tenant.lane_free, max(r.arrival for r in batch))
        if TRACER.enabled:
            TRACER.instant(
                "batch.queue_wait", "serving",
                {"tenant": tenant.name,
                 "max_wait_cycles":
                     start - min(r.arrival for r in batch)})
        service = plan.calibrated_cycles(self.calibration)
        if INJECTOR.enabled:
            service = INJECTOR.scale_latency(service, tenant.name)
        finish = start + service
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

    @staticmethod
    def _shardable(plan, xb) -> bool:
        """True when the plan can run through the sharded frontend path:
        a mesh plan whose sites are ALL batch-sharded at the mesh degree
        (a uniform layout needs no mid-chain relays inside the frontend
        walk), float precision, and a batch that tiles evenly.
        Mixed/chan/degree-1 layouts fall back to the replicated walk of
        the same plan — identical math, the mesh then only reshapes the
        time model."""
        if plan.mesh is None or plan.mesh.devices <= 1:
            return False
        d = plan.mesh.devices
        sharded = plan.sharded_sites()
        if len(sharded) != len(plan.sites):
            return False
        if any(s.shard_axis != "batch" or s.shard_degree != d
               or s.lowered for s in plan.sites):
            return False
        return xb.shape[0] % d == 0

    def _params_on(self, tenant: Tenant, device: torch.device):
        """The tenant's params on ``device`` (copied once a device)."""
        if device.type == self.device.type and (
                device.type == "cpu"
                or (device.index or 0) == (self.device.index or 0)):
            return tenant.params
        key = (tenant.name, device)
        params = self._replicas.get(key)
        if params is None:
            params = self._replicas[key] = _to_device(tenant.params, device)
        return params

    def _run_frontend_sharded(self, tenant: Tenant, xb, plan,
                              *, tile_overrides=None):
        """The whole frontend over the tenant's device slice: each device
        runs the per-device plan (``plan.device_plan()``) on its batch
        block, and the blocks are concatenated on the server's device —
        bitwise the replicated walk for batch sharding.  The slice comes
        from ``fault_tolerance.elastic_remesh`` over the server's pool —
        the same builder the degraded path re-meshes through after a
        device loss."""
        from repro_torch.runtime.fault_tolerance import elastic_remesh
        d = plan.mesh.devices
        start, _stop = self.arbiter.device_slice(tenant.name)
        devs, _axis = elastic_remesh(d, axis=plan.mesh.axis, offset=start,
                                     pool=self.devices)
        dplan = plan.device_plan()
        block = xb.shape[0] // d
        ys = []
        for r, dev in enumerate(devs):
            xr = xb[r * block:(r + 1) * block].to(dev)
            yr = apply_cnn_frontend(self._params_on(tenant, dev), xr,
                                    network=dplan,
                                    pool_window=tenant.pool_window,
                                    activation=tenant.activation,
                                    tile_overrides=tile_overrides)
            ys.append(yr.to(self.device))
        y = torch.cat(ys, dim=0)
        if INJECTOR.enabled:
            # injection seam "collective": the gathered result of a
            # sharded execution (corruption lands after the collective)
            y = INJECTOR.perturb_output("collective", y, tenant.name)
        return y

    # -- degraded mesh / fault survival --------------------------------------
    def on_device_loss(self, device: Optional[int] = None) -> list:
        """Degrade, don't die: shrink the mesh by one device
        (``BudgetArbiter.on_device_loss``) and mark the affected tenants
        — their next batch re-plans at the shrunk shard degree (the
        degree ladder descends; precision is untouched because every
        surviving device still plans under the FULL per-device budget).
        Returns the affected tenant names.  On one device the arbiter
        raises ``ValueError``, as the reference's does, so a guard
        rejects the batch."""
        affected = self.arbiter.on_device_loss(device)
        self.mesh = self.arbiter.mesh
        for name in affected:
            self.tenants[name].telemetry.degradations += 1
        return affected

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

    def prewarm_spares(self, losses: int = 1) -> int:
        """Pre-plan every tenant's graphs against the post-loss device
        grants (``BudgetArbiter.degraded_grants``), so a real device
        loss re-plans **zero graphs cold** — the spare plans already sit
        in the cache under the exact keys the degraded mesh will ask
        for.  Mesh mode only.  Returns the number of spare plans
        warmed (cache hits included: warm is warm)."""
        if self.mesh is None:
            raise ValueError("prewarm_spares() is mesh-mode only")
        grants = self.arbiter.degraded_grants(losses)
        survivors = self.mesh.devices - int(losses)
        # the post-loss split() may also re-settle by plain largest
        # remainder (no ladder snap) — warm those grants too
        resettle = self.arbiter._device_grants(
            self.arbiter._granted, devices=survivors)
        warmed = 0
        for name, tenant in self.tenants.items():
            degrees = {grants.get(name, 0), resettle.get(name, 0)} - {0}
            for n_dev in degrees:
                spare_mesh = dataclasses.replace(self.arbiter.mesh,
                                                 devices=n_dev)
                for b in range(1, self.max_batch + 1):
                    specs = self._specs(
                        tenant.params, (b,) + tenant.input_shape,
                        "float32", tenant.pool_window, tenant.activation,
                        tenant.ladder)
                    plan_network(specs, self.budget, fuse=self.fuse,
                                 calibration=self.calibration,
                                 mesh=spare_mesh if n_dev > 1 else None)
                    warmed += 1
        log_event("mesh.spares_prewarmed", losses=losses, plans=warmed)
        return warmed

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
