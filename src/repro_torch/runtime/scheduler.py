"""SLO-aware continuous-batching scheduler over ``AdaptiveServer``.

Replaces ``repro/runtime/scheduler.py``.

The synchronous loop (``AdaptiveServer.step``) batches in rounds: every
queued bucket drains before any new arrival is considered, deadlines are
invisible, and a burst from one tenant head-of-line-blocks everyone
else.  This scheduler replaces the round with an event-driven dispatch
loop:

* **Continuous batching** — a submitted request joins a *not-yet-
  launched* bucket instead of waiting for the next batching round: the
  dispatch frontier only advances when no lane can launch, so arrivals
  due before a tenant's lane frees ride along in that tenant's next
  batch.
* **SLO admission** — every tenant registers an ``SLOSpec`` (deadline,
  priority, max queue depth).  Admission beyond ``max_queue_depth`` is
  rejected (counted as shed), and queued requests whose deadline has
  already passed are *load-shed* rather than executed — serving a
  hopeless request only makes the next one hopeless too.
* **Deadline-aware dispatch** — launchable buckets are ordered by
  (priority desc, earliest deadline, arrival order); when a priority
  tenant's bucket jumps an earlier-queued lower-priority bucket that is
  a **preemption**: logged through ``obs.EVENTS`` and backed by an
  immediate ``BudgetArbiter.preempt`` grant transfer (the victim is
  squeezed to its floor), instead of waiting rounds of hysteresis for
  the demand EWMA to move.
* **SLO-driven arbitration** — every dispatch folds its deadline
  outcomes into the arbiter's per-tenant miss-rate EWMA
  (``record_outcome``); with ``slo_pressure > 0`` a missing tenant's
  demand weight is amplified at the next ``split()``.

Dual-clock rule (the contract tests assert): ``Request.arrival``, lane
occupancy, and latency percentiles stay in **modeled est-cycles** — the
planner's own cost model, comparable across policies and hosts — while
SLO deadlines and miss detection use a **monotonic wall clock**
(injectable ``wall=``; defaults to ``time.monotonic``).  A request's
wall deadline is stamped when it is *admitted* (deferred ``at=``
arrivals are admitted when the dispatch frontier reaches them), so real
elapsed execution time — not the modeled clock — decides whether it
missed.  ``TenantTelemetry`` therefore carries both clocks:
``p50/p95_cycles`` (modeled) next to ``wall_p50/p95_s`` and
``deadline_miss_rate`` (measured).

On a CUDA server the kernels launch asynchronously, so ``_launch``
synchronizes the device before it reads the wall clock after a batch:
a deadline is judged on finished work, not on enqueue time.  The wall
clock is read exactly where the reference reads it, so a fake clock
that advances per reading gives both packages the same verdicts.
``recovery=`` is duck-typed: anything with a ``beat()``, such as
``runtime/recovery.py::RecoveryManager``.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.obs.metrics import system_metrics
from repro_torch.obs.trace import log_event
from repro_torch.runtime.batching import Request
from repro_torch.runtime.server import AdaptiveServer, Completion


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One tenant's service-level objective.

    ``deadline_s``: wall-clock budget from admission to completion.
    ``priority``: higher dispatches first and may preempt queued
    lower-priority buckets.  ``max_queue_depth``: admission cap on
    queued-but-unlaunched requests (None = unbounded)."""

    deadline_s: float
    priority: int = 0
    max_queue_depth: Optional[int] = None

    def __post_init__(self):
        if self.deadline_s <= 0.0:
            raise ValueError("deadline_s must be > 0")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")


@dataclasses.dataclass
class _Admitted:
    """A queued request with its wall-clock SLO stamps (the est-cycles
    side lives in ``req.arrival``)."""

    req: Request
    admitted_wall: float
    deadline_wall: float


@dataclasses.dataclass
class _Bucket:
    """One not-yet-launched batch-in-progress; ``seq`` is creation
    order — the FIFO baseline preemption is judged against."""

    seq: int
    items: List[_Admitted] = dataclasses.field(default_factory=list)

    def earliest_deadline(self) -> float:
        return min(a.deadline_wall for a in self.items)


class SLOScheduler:
    """Event-driven admission/dispatch over one ``AdaptiveServer``.

    The server keeps its roles — pricing, arbitration mechanics, plan
    cache, kernel execution, est-cycles lane accounting — while this
    loop owns *when* batches launch and *which* requests still deserve
    to.  ``wall=`` injects the monotonic clock (tests pass a fake);
    ``shed_margin_s`` sheds requests whose remaining wall budget is
    below the margin (0.0 = shed only once already expired).
    """

    def __init__(self, server: AdaptiveServer, *,
                 wall: Callable[[], float] = time.monotonic,
                 shed_margin_s: float = 0.0, recovery=None):
        if server.pending():
            raise ValueError("attach the scheduler before submitting "
                             "requests to the server")
        self.server = server
        self.wall = wall
        self.shed_margin_s = float(shed_margin_s)
        # optional recovery manager (anything with a beat()): every
        # healthy launch beats its heartbeat watchdog, so dispatch
        # stalls — not just process death — trip the recovery path
        self.recovery = recovery
        self.slos: Dict[str, SLOSpec] = {}
        self._buckets: Dict[Tuple, _Bucket] = {}
        self._bucket_seq = 0
        # min-heap of deferred arrivals: (at_cycles, order, name, x)
        self._arrivals: List[tuple] = []
        self._order = 0
        self.now = server.clock          # est-cycles dispatch frontier
        self._dirty = True               # re-arbitrate before next launch
        self.launches = 0
        self.sheds = 0
        self.rejections = 0
        self.preemptions = 0
        # rid -> "ok" | "miss" | "shed" | "rejected"
        self.outcomes: Dict[int, str] = {}

    # -- admission ----------------------------------------------------------
    def register(self, name: str, params, input_shape, *, slo: SLOSpec,
                 **kwargs):
        """Register a tenant (delegates pricing/admission to
        ``AdaptiveServer.register``) under an ``SLOSpec``."""
        if not isinstance(slo, SLOSpec):
            raise TypeError(f"slo must be an SLOSpec, got {type(slo)!r}")
        tenant = self.server.register(name, params, input_shape, **kwargs)
        self.slos[name] = slo
        return tenant

    def submit(self, name: str, x, *, at: Optional[float] = None):
        """Queue one sample (or a (B, ...) stack as B requests) arriving
        at est-cycles clock ``at`` (default: now).  The request is
        *admitted* — wall deadline stamped, queue-depth cap checked —
        when the dispatch frontier reaches its arrival, so a deferred
        request's deadline reflects the wall time its turn actually
        comes up.  Returns the request id (or list of ids)."""
        if name not in self.slos:
            raise KeyError(f"tenant {name!r} is not registered with the "
                           f"scheduler")
        tenant = self.server.tenants[name]
        x = torch.as_tensor(x, device=self.server.device)
        if x.dim() == len(tenant.input_shape) + 1:
            return [self.submit(name, xi, at=at) for xi in x]
        if tuple(x.shape) != tenant.input_shape:
            raise ValueError(
                f"tenant {name!r} expects samples of shape "
                f"{tenant.input_shape}, got {tuple(x.shape)}")
        arrival = self.now if at is None else max(float(at), self.now)
        rid = self.server._next_rid      # stable across reordering by at=
        self.server._next_rid += 1
        heapq.heappush(self._arrivals,
                       (arrival, self._order, rid, name, x))
        self._order += 1
        return rid

    def _admit_due(self) -> None:
        """Admit every arrival due at the dispatch frontier: stamp its
        wall deadline, enforce the tenant's queue-depth cap, join (or
        open) its not-yet-launched bucket."""
        while self._arrivals and self._arrivals[0][0] <= self.now:
            arrival, _, rid, name, x = heapq.heappop(self._arrivals)
            tenant = self.server.tenants[name]
            slo = self.slos[name]
            if (slo.max_queue_depth is not None
                    and self.queue_depth(name) >= slo.max_queue_depth):
                self.rejections += 1
                self.outcomes[rid] = "rejected"
                tenant.telemetry.record_shed(1)
                log_event("scheduler.reject", tenant=name, rid=rid,
                          depth=slo.max_queue_depth)
                continue
            req = Request(rid=rid, tenant=name, x=x, arrival=arrival)
            w = self.wall()
            adm = _Admitted(req=req, admitted_wall=w,
                            deadline_wall=w + slo.deadline_s)
            bucket = self._buckets.get(req.bucket_key)
            if bucket is None:
                bucket = _Bucket(seq=self._bucket_seq)
                self._bucket_seq += 1
                self._buckets[req.bucket_key] = bucket
            bucket.items.append(adm)
            self.server.arbiter.observe(name, tenant.unit_cost)
            self._dirty = True

    def queue_depth(self, name: str) -> int:
        """Admitted-but-unlaunched requests of one tenant (the number
        the ``max_queue_depth`` cap is enforced against)."""
        return sum(len(b.items) for (t, _, _), b in self._buckets.items()
                   if t == name)

    def pending(self) -> int:
        """Queued + deferred requests still owed a verdict."""
        return (sum(len(b.items) for b in self._buckets.values())
                + len(self._arrivals))

    # -- dispatch -----------------------------------------------------------
    def _shed_hopeless(self) -> None:
        """Drop queued requests that can no longer meet their deadline
        (wall clock past ``deadline_wall - shed_margin_s``).  Every shed
        is a recorded miss; executing it anyway would only push the
        bucket's *other* deadlines past hope too."""
        w = self.wall()
        for key in list(self._buckets):
            bucket = self._buckets[key]
            keep, drop = [], []
            for adm in bucket.items:
                if w + self.shed_margin_s >= adm.deadline_wall:
                    drop.append(adm)
                else:
                    keep.append(adm)
            if not drop:
                continue
            bucket.items = keep
            tenant = self.server.tenants[key[0]]
            tenant.telemetry.record_shed(len(drop))
            self.sheds += len(drop)
            self.server.arbiter.record_outcome(
                key[0], served=len(drop), missed=len(drop))
            self._dirty = True
            for adm in drop:
                self.outcomes[adm.req.rid] = "shed"
                log_event("scheduler.shed", tenant=key[0], rid=adm.req.rid,
                          late_s=w - adm.deadline_wall)
            if not bucket.items:
                del self._buckets[key]

    def _launchable(self) -> List[Tuple]:
        """Bucket keys whose tenant lane is free at the frontier."""
        return [key for key in self._buckets
                if self.server.tenants[key[0]].lane_free <= self.now]

    def _advance(self) -> bool:
        """Nothing launchable: move the est-cycles frontier to the next
        event (a deferred arrival or a lane freeing).  False = no future
        event exists (only unlaunchable work — cannot happen unless the
        loop is misused)."""
        horizons = []
        if self._arrivals:
            horizons.append(self._arrivals[0][0])
        for key in self._buckets:
            horizons.append(self.server.tenants[key[0]].lane_free)
        if not horizons:
            return False
        self.now = max(self.now, min(horizons))
        return True

    def _choose(self, launchable: List[Tuple]) -> Tuple:
        """Dispatch order: priority desc, earliest wall deadline,
        bucket creation order.  Jumping an earlier-queued lower-priority
        bucket is a preemption: logged, counted, and (fractional mode)
        backed by an immediate arbiter grant transfer."""
        def rank(key):
            b = self._buckets[key]
            return (-self.slos[key[0]].priority, b.earliest_deadline(),
                    b.seq)
        chosen = min(launchable, key=rank)
        fifo = min(launchable, key=lambda k: self._buckets[k].seq)
        if fifo == chosen:
            return chosen
        winner, victim = chosen[0], fifo[0]
        if self.slos[winner].priority <= self.slos[victim].priority:
            return chosen                 # EDF reorder, not a preemption
        self.preemptions += 1
        self.server.tenants[winner].telemetry.preemptions += 1
        log_event("scheduler.preempt", winner=winner, victim=victim,
                  winner_priority=self.slos[winner].priority,
                  victim_priority=self.slos[victim].priority)
        if winner != victim and self.server.mesh is None:
            moved = self.server.arbiter.preempt(winner, victim)
            if moved > 0.0:
                self.server._apply_shares(self.server.arbiter.shares())
                self._dirty = True       # let split() re-settle later
        return chosen

    def _launch(self, key: Tuple) -> List[Completion]:
        """Execute up to ``max_batch`` earliest-deadline requests of one
        bucket and judge them on the wall clock, after the device has
        finished them.  The batch's tightest remaining deadline budget
        rides along for the execution guards (``runtime/guards.py``); a
        guard-failed completion (``ok=False``) counts as a miss for the
        arbiter's SLO pressure."""
        bucket = self._buckets[key]
        bucket.items.sort(key=lambda a: (a.deadline_wall, a.req.rid))
        take = bucket.items[:self.server.max_batch]
        bucket.items = bucket.items[self.server.max_batch:]
        if not bucket.items:
            del self._buckets[key]
        budget_s = min(a.deadline_wall for a in take) - self.wall()
        comps = self.server._execute([a.req for a in take],
                                     deadline_budget_s=max(budget_s, 0.0))
        if self.server.device.type == "cuda":
            torch.cuda.synchronize(self.server.device)
        w = self.wall()
        walls = [w - a.admitted_wall for a in take]
        missed = failed = 0
        for adm, c in zip(take, comps):
            if not c.ok:
                failed += 1
                self.outcomes[adm.req.rid] = "rejected"
            elif w > adm.deadline_wall:
                missed += 1
                self.outcomes[adm.req.rid] = "miss"
            else:
                self.outcomes[adm.req.rid] = "ok"
        name = key[0]
        self.server.tenants[name].telemetry.record_slo_batch(walls, missed)
        self.server.arbiter.record_outcome(name, served=len(take),
                                           missed=missed + failed)
        if missed or failed:
            self._dirty = True
        self.launches += 1
        if self.recovery is not None:
            self.recovery.beat()
        return comps

    def run(self, max_launches: int = 100_000) -> List[Completion]:
        """Drive the loop until every queued and deferred request has a
        verdict (completed, missed, shed, or rejected).  Returns the
        completions in launch order."""
        completions: List[Completion] = []
        while self.pending() and self.launches < max_launches:
            self._admit_due()
            self._shed_hopeless()
            launchable = self._launchable()
            if not launchable:
                if not self._advance():
                    break
                continue
            if self._dirty:
                self.server._apply_shares(self.server.arbiter.split())
                self._dirty = False
            completions.extend(self._launch(self._choose(launchable)))
        if completions:
            self.server.clock = max(self.server.clock, self.now,
                                    max(c.finished for c in completions))
        return completions

    # -- observability / persistence ---------------------------------------
    def metrics(self, registry=None):
        """Server + scheduler state folded into a ``MetricsRegistry``
        (queue-depth gauges, shed/preemption counters, both latency
        clocks).  Render with ``.render()`` (Prometheus text)."""
        return system_metrics(server=self.server, registry=registry,
                              scheduler=self)

    def stats(self) -> dict:
        """Scheduler-level counters (per-tenant SLO outcomes live in
        ``TenantTelemetry``)."""
        return {"launches": self.launches, "sheds": self.sheds,
                "rejections": self.rejections,
                "preemptions": self.preemptions,
                "pending": self.pending(),
                "queue_depths": {name: self.queue_depth(name)
                                 for name in self.slos}}

    def state_dict(self) -> dict:
        """JSON-able SLO state a plan-preserving restart carries: the
        per-tenant specs and the lifetime counters.  Queued requests are
        deliberately NOT snapshotted — in-flight work is lost on a
        crash and the client retries; what must survive is the *plans*
        (recovery: ROADMAP queue 1, item 8, part 2)."""
        return {
            "slos": {name: dataclasses.asdict(spec)
                     for name, spec in self.slos.items()},
            "shed_margin_s": self.shed_margin_s,
            "launches": self.launches, "sheds": self.sheds,
            "rejections": self.rejections,
            "preemptions": self.preemptions,
        }

    def load_state(self, state: dict) -> None:
        """Restore a ``state_dict`` snapshot.  Every snapshotted tenant
        must already be registered with the *server* (the recovery path
        registers tenants there, then re-attaches their SLOs here)."""
        missing = set(state["slos"]) - set(self.server.tenants)
        if missing:
            raise ValueError(f"snapshot covers unregistered tenants: "
                             f"{sorted(missing)}")
        for name, spec in state["slos"].items():
            self.slos[name] = SLOSpec(**spec)
        self.shed_margin_s = float(state.get("shed_margin_s",
                                             self.shed_margin_s))
        self.launches = int(state.get("launches", 0))
        self.sheds = int(state.get("sheds", 0))
        self.rejections = int(state.get("rejections", 0))
        self.preemptions = int(state.get("preemptions", 0))
