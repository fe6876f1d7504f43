"""Metrics registry — one snapshot for the scattered stats.

Replaces ``repro/obs/metrics.py``.  The system counts plenty
(``core.plan.PlannerStats``, the LRU cache's ``plan_cache_stats``,
``BudgetArbiter.rebalances``, per-tenant ``TenantTelemetry``, the
tracer/event-log buffers, the SLO scheduler's counters) but each behind
its own ad-hoc dict.  This module unifies them:

* ``Counter`` / ``Gauge`` / ``Histogram`` — the three metric kinds,
  labeled, registered in a ``MetricsRegistry``.
* ``MetricsRegistry.snapshot()`` — one nested dict of everything.
* ``MetricsRegistry.render()`` — Prometheus-style text exposition
  (``# HELP`` / ``# TYPE``; histograms render summary-style with
  quantile labels, ``_sum`` and ``_count``).  The default namespace is
  the reference's, ``"repro"``, so both packages expose the same text.
* ``system_metrics(server=None, registry=None, scheduler=None)`` — the
  collector: walks the planner stats, plan cache, event log, tracer,
  and (when given a server or a scheduler) the arbiter, per-tenant
  telemetry and the scheduler's queue depths and counters into a
  registry.
* ``percentile(values, q)`` — THE percentile estimator.
  ``TenantTelemetry.latency_percentile`` and ``Histogram.quantile``
  both delegate here, so serving telemetry and metrics exposition can
  never disagree about what "p95" means (sorted linear interpolation,
  the same rule ``numpy.percentile(..., method="linear")`` applies).

Import discipline: lazy imports inside ``system_metrics`` only — the
registry itself depends on nothing from ``repro_torch.core`` or
``repro_torch.runtime`` (``core/plan.py`` imports ``obs`` at module
level).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Tuple

HISTOGRAM_WINDOW = 4096
_QUANTILES = (0.5, 0.9, 0.95, 0.99)


def percentile(values: Sequence[float], q: float) -> float:
    """q-th percentile (0..100) by sorted linear interpolation — the
    single estimator shared by ``Histogram`` and
    ``TenantTelemetry.latency_percentile``.  Empty input returns 0.0
    (a gauge that has seen nothing reads zero, not NaN)."""
    xs = sorted(values)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return float(xs[0])
    q = min(max(float(q), 0.0), 100.0)
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


@dataclasses.dataclass
class Counter:
    """Monotone event count."""

    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += amount


@dataclasses.dataclass
class Gauge:
    """A point-in-time value that can move both ways."""

    value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Histogram:
    """Windowed distribution: total count/sum are exact over the full
    history; quantiles are estimated over the most recent ``window``
    observations (the same bounded-memory treatment the telemetry
    latency deque gets)."""

    def __init__(self, window: int = HISTOGRAM_WINDOW):
        self.count = 0
        self.sum = 0.0
        self._recent: Deque[float] = deque(maxlen=window)

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self._recent.append(value)

    def observe_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.observe(v)

    def quantile(self, q01: float) -> float:
        """Quantile in [0, 1] (Prometheus summary convention)."""
        return percentile(self._recent, q01 * 100.0)

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "quantiles": {q: self.quantile(q) for q in _QUANTILES}}


_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(key: _LabelKey, extra: Tuple[Tuple[str, str], ...] = ()
                   ) -> str:
    items = key + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class MetricsRegistry:
    """Named, labeled metrics behind one snapshot + text exposition.

    A metric name registers with one kind; re-registering the same
    (name, labels) returns the existing instrument (so collectors are
    idempotent), while re-registering a name as a different kind
    raises — the exposition format cannot express that."""

    def __init__(self, namespace: str = "repro"):
        self.namespace = namespace
        self._kinds: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._metrics: Dict[Tuple[str, _LabelKey], object] = {}

    # positional-only parameters: label names like kind= / name= must
    # never collide with the registration arguments
    def _get(self, kind: str, name: str, help_: str, factory, /, **labels):
        have = self._kinds.get(name)
        if have is not None and have != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{have}, not {kind}")
        self._kinds[name] = kind
        if help_:
            self._help[name] = help_
        key = (name, _label_key(labels))
        metric = self._metrics.get(key)
        if metric is None:
            metric = factory()
            self._metrics[key] = metric
        return metric

    def counter(self, name: str, help_: str = "", /, **labels) -> Counter:
        return self._get("counter", name, help_, Counter, **labels)

    def gauge(self, name: str, help_: str = "", /, **labels) -> Gauge:
        return self._get("gauge", name, help_, Gauge, **labels)

    def histogram(self, name: str, help_: str = "", /,
                  window: int = HISTOGRAM_WINDOW, **labels) -> Histogram:
        return self._get("summary", name, help_,
                         lambda: Histogram(window), **labels)

    # -- output -------------------------------------------------------------
    def snapshot(self) -> dict:
        """Everything, as ``{name: [{labels, ...value(s)}]}``."""
        out: Dict[str, List[dict]] = {}
        for (name, key), metric in sorted(self._metrics.items()):
            row: dict = {"labels": dict(key)}
            if isinstance(metric, Histogram):
                row.update(metric.snapshot())
            else:
                row["value"] = metric.value
            out.setdefault(name, []).append(row)
        return out

    def render(self) -> str:
        """Prometheus-style text exposition."""
        by_name: Dict[str, List[Tuple[_LabelKey, object]]] = {}
        for (name, key), metric in sorted(self._metrics.items()):
            by_name.setdefault(name, []).append((key, metric))
        lines: List[str] = []
        for name, rows in by_name.items():
            full = f"{self.namespace}_{name}"
            kind = self._kinds[name]
            if name in self._help:
                lines.append(f"# HELP {full} {self._help[name]}")
            lines.append(f"# TYPE {full} {kind}")
            for key, metric in rows:
                if isinstance(metric, Histogram):
                    for q in _QUANTILES:
                        lab = _render_labels(key, (("quantile", str(q)),))
                        lines.append(f"{full}{lab} {metric.quantile(q):g}")
                    lab = _render_labels(key)
                    lines.append(f"{full}_sum{lab} {metric.sum:g}")
                    lines.append(f"{full}_count{lab} {metric.count}")
                else:
                    lab = _render_labels(key)
                    lines.append(f"{full}{lab} {metric.value:g}")
        return "\n".join(lines) + "\n"


def system_metrics(server=None,
                   registry: Optional[MetricsRegistry] = None,
                   scheduler=None) -> MetricsRegistry:
    """Collect the system's scattered stats into one registry: planner
    counters + plan cache, event log, tracer buffer — and, when given
    an ``AdaptiveServer``, its arbiter, queue, and per-tenant telemetry
    (shard degree, comm share, and SLO outcome columns included).
    ``scheduler=`` (an ``SLOScheduler``) adds per-tenant queue-depth
    gauges and the scheduler-level shed/preemption counters; its server
    is collected automatically when ``server`` is omitted."""
    reg = registry if registry is not None else MetricsRegistry()
    if server is None and scheduler is not None:
        server = scheduler.server

    from repro_torch.core.plan import STATS, plan_cache_stats
    cache = plan_cache_stats()
    reg.gauge("plan_cache_size", "entries in the LRU plan cache").set(
        cache["size"])
    reg.gauge("plan_cache_capacity").set(cache["capacity"])
    reg.gauge("plan_cache_hit_rate", "hits / lookups since start").set(
        cache["hit_rate"])
    for field, value in STATS.snapshot().items():
        reg.counter(f"planner_{field}_total",
                    "planner counter (core.plan.PlannerStats)").inc(value)

    from repro_torch.obs.trace import EVENTS, TRACER
    for kind, n in sorted(EVENTS.counts().items()):
        reg.counter("events_total", "event-log entries in window",
                    kind=kind).inc(n)
    tstats = TRACER.stats()
    reg.gauge("tracer_enabled").set(1.0 if tstats["enabled"] else 0.0)
    reg.gauge("tracer_buffered_events").set(tstats["events"])
    reg.counter("tracer_dropped_events_total").inc(tstats["dropped"])

    if server is not None:
        reg.gauge("server_pending_requests",
                  "requests waiting in the shape-bucket queue").set(
            server.pending())
        reg.counter("arbiter_rebalances_total",
                    "grant moves past hysteresis").inc(
            server.arbiter.rebalances)
        for name, snap in server.telemetry().items():
            reg.counter("tenant_requests_total", "served requests",
                        tenant=name).inc(snap["requests"])
            reg.counter("tenant_batches_total", "executed batches",
                        tenant=name).inc(snap["batches"])
            reg.counter("tenant_replans_total",
                        "grant moves that forced a re-plan",
                        tenant=name).inc(snap["replans"])
            reg.gauge("tenant_granted_fraction",
                      "current device fraction", tenant=name).set(
                snap["granted_fraction"])
            reg.gauge("tenant_batch_occupancy", tenant=name).set(
                snap["batch_occupancy"])
            reg.gauge("tenant_lowered_fraction",
                      "site executions below native width",
                      tenant=name).set(snap["lowered_fraction"])
            reg.gauge("tenant_shard_degree",
                      "max shard degree served (1 = replicated)",
                      tenant=name).set(snap["shard_degree"])
            reg.gauge("tenant_comm_cycles_share",
                      "collective cycles / total est cycles",
                      tenant=name).set(snap["comm_cycles_share"])
            # SLO outcome columns (dual clock: the latency summary
            # below stays est-cycles; wall seconds get their own one)
            reg.gauge("tenant_deadline_miss_rate",
                      "(late completions + shed) / SLO-tracked",
                      tenant=name).set(snap["deadline_miss_rate"])
            reg.counter("tenant_deadline_misses_total",
                        "late completions + shed", tenant=name).inc(
                snap["deadline_misses"])
            reg.counter("tenant_shed_total",
                        "requests dropped as already-hopeless",
                        tenant=name).inc(snap["shed"])
            reg.counter("tenant_preemptions_total",
                        "priority dispatches past a queued bucket",
                        tenant=name).inc(snap["preemptions"])
            hist = reg.histogram("tenant_latency_cycles",
                                 "request latency in est-cycles",
                                 tenant=name)
            tenant = server.tenants[name]
            hist.observe_many(tenant.telemetry.latencies)
            whist = reg.histogram("tenant_wall_latency_seconds",
                                  "measured wall latency of SLO-tracked "
                                  "requests", tenant=name)
            whist.observe_many(tenant.telemetry.wall_latencies)
    if scheduler is not None:
        for name, depth in scheduler.stats()["queue_depths"].items():
            reg.gauge("scheduler_queue_depth",
                      "admitted-but-unlaunched requests",
                      tenant=name).set(depth)
        reg.gauge("scheduler_pending_requests",
                  "queued + deferred requests awaiting a verdict").set(
            scheduler.pending())
        reg.counter("scheduler_launches_total").inc(scheduler.launches)
        reg.counter("scheduler_sheds_total").inc(scheduler.sheds)
        reg.counter("scheduler_rejections_total",
                    "admissions past max_queue_depth").inc(
            scheduler.rejections)
        reg.counter("scheduler_preemptions_total").inc(
            scheduler.preemptions)
    return reg
