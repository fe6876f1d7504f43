"""Per-tenant serving telemetry.

Latency is measured in *estimated cycles* — the same cost model the
planner optimizes (``Footprint.est_cycles``), so arbitration policies
are comparable without wall-clock noise, and the port's numbers equal
the reference's exactly.  Precision mix counts planned-site executions
per operand width (how often the tenant actually served lowered), and
the plan-cache columns are windowed deltas of
``core.plan.plan_cache_stats``.

Sharding columns: ``shard_degree_mix`` counts planned-site executions
per shard degree (degree 1 = replicated), ``shard_degree`` is the
widest degree the tenant has served, and ``comm_cycles_share`` is the
fraction of the tenant's total estimated cycles spent in collectives —
how much of a mesh tenant's bill is traffic, not compute.

SLO columns (populated by ``runtime/scheduler.py``; zero under the
plain synchronous server) keep the **dual-clock rule**: latency
percentiles stay in modeled est-cycles (``p50_cycles``/``p95_cycles``)
while deadline outcomes are judged on the monotonic wall clock — so the
snapshot carries BOTH clocks: ``wall_p50_s``/``wall_p95_s`` are
measured wall-clock latencies of SLO-tracked requests, and
``deadline_miss_rate`` = (late completions + shed) / SLO-tracked
requests.  ``shed`` counts requests dropped as already-hopeless,
``preemptions`` counts dispatches where this tenant's priority jumped a
queued lower-priority bucket.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List

from repro_torch.obs.metrics import percentile

# Percentiles are computed over the most recent window rather than the
# full request history, so a long-lived server's memory stays bounded
# (the same treatment the plan cache gets in core/plan.py).
LATENCY_WINDOW = 4096


@dataclasses.dataclass
class TenantTelemetry:
    """Counters one ``AdaptiveServer`` keeps per registered tenant."""

    name: str
    max_batch: int
    requests: int = 0
    batches: int = 0
    occupancy_sum: float = 0.0
    latencies: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=LATENCY_WINDOW))
    precision_mix: Dict[int, int] = dataclasses.field(default_factory=dict)
    shard_degree_mix: Dict[int, int] = dataclasses.field(
        default_factory=dict)
    comm_cycles_sum: float = 0.0
    est_cycles_sum: float = 0.0
    replans: int = 0            # grant moves that forced a re-plan
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    max_quant_rel_err: float = 0.0
    # SLO accounting (dual clock: deadlines are wall-clock; the
    # percentile columns above stay est-cycles)
    slo_tracked: int = 0        # requests submitted under an SLOSpec
    deadline_misses: int = 0    # late completions + shed
    shed: int = 0               # dropped as already-hopeless
    preemptions: int = 0        # priority dispatches past a queued bucket
    wall_latencies: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=LATENCY_WINDOW))
    # Fault-survival accounting (runtime/guards.py, runtime/faults.py):
    # requests the guard failed outright vs shed as deadline-hopeless,
    # retries spent absorbing transient faults, and how often this
    # tenant's device grant shrank through the degraded-mesh path.
    guard_rejected: int = 0
    guard_shed: int = 0
    guard_retries: int = 0
    degradations: int = 0

    def record_batch(self, batch_size: int, latencies: List[float],
                     plan, *, cache_hits: int, cache_misses: int,
                     quant_err: float = 0.0) -> None:
        self.requests += batch_size
        self.batches += 1
        self.occupancy_sum += batch_size / self.max_batch
        self.latencies.extend(latencies)
        for site in plan.sites:
            bits = site.precision_bits
            self.precision_mix[bits] = self.precision_mix.get(bits, 0) + 1
            deg = getattr(site, "shard_degree", 1)
            self.shard_degree_mix[deg] = (
                self.shard_degree_mix.get(deg, 0) + 1)
            self.comm_cycles_sum += site.footprint.comm_cycles
            self.est_cycles_sum += site.footprint.est_cycles
        self.plan_cache_hits += cache_hits
        self.plan_cache_misses += cache_misses
        self.max_quant_rel_err = max(self.max_quant_rel_err, quant_err)

    @property
    def batch_occupancy(self) -> float:
        """Mean fill of executed batches, in [1/max_batch, 1]."""
        return self.occupancy_sum / self.batches if self.batches else 0.0

    @property
    def lowered_fraction(self) -> float:
        """Fraction of planned-site executions that ran below 32 bits."""
        total = sum(self.precision_mix.values())
        low = sum(n for b, n in self.precision_mix.items() if b < 32)
        return low / total if total else 0.0

    @property
    def shard_degree(self) -> int:
        """Widest shard degree this tenant has served (1 = replicated)."""
        return max(self.shard_degree_mix, default=1)

    @property
    def comm_cycles_share(self) -> float:
        """Collective cycles / total estimated cycles served."""
        return (self.comm_cycles_sum / self.est_cycles_sum
                if self.est_cycles_sum else 0.0)

    def record_slo_batch(self, wall_latencies: List[float],
                         missed: int) -> None:
        """One SLO-tracked batch's wall-clock outcomes: per-request
        measured wall latency (seconds) and how many of them finished
        past their deadline."""
        self.slo_tracked += len(wall_latencies)
        self.wall_latencies.extend(wall_latencies)
        self.deadline_misses += missed

    def record_shed(self, n: int = 1) -> None:
        """``n`` requests dropped as already-hopeless; every shed is a
        deadline miss too."""
        self.shed += n
        self.slo_tracked += n
        self.deadline_misses += n

    @property
    def deadline_miss_rate(self) -> float:
        """(late completions + shed) / SLO-tracked requests."""
        return (self.deadline_misses / self.slo_tracked
                if self.slo_tracked else 0.0)

    def wall_percentile(self, q: float) -> float:
        """q-th percentile of measured wall-clock latency (seconds) of
        SLO-tracked requests — the second clock of the dual-clock rule
        (``latency_percentile`` is the est-cycles one)."""
        return percentile(self.wall_latencies, q)

    def latency_percentile(self, q: float) -> float:
        """q-th percentile (0..100) of request latency in est-cycles,
        over the most recent ``LATENCY_WINDOW`` requests.  Delegates to
        the shared estimator (``repro_torch.obs.metrics.percentile``) so the
        metrics exposition and this snapshot can never disagree."""
        return percentile(self.latencies, q)

    def snapshot(self) -> dict:
        cache_lookups = self.plan_cache_hits + self.plan_cache_misses
        return {
            "name": self.name,
            "requests": self.requests,
            "batches": self.batches,
            "batch_occupancy": self.batch_occupancy,
            "p50_cycles": self.latency_percentile(50),
            "p95_cycles": self.latency_percentile(95),
            "precision_mix": dict(sorted(self.precision_mix.items())),
            "lowered_fraction": self.lowered_fraction,
            "shard_degree": self.shard_degree,
            "shard_degree_mix": dict(sorted(
                self.shard_degree_mix.items())),
            "comm_cycles_share": self.comm_cycles_share,
            # dual-clock SLO columns: *_cycles above are the modeled
            # est-cycles clock; wall_* here are the monotonic wall clock
            "slo_tracked": self.slo_tracked,
            "deadline_misses": self.deadline_misses,
            "deadline_miss_rate": self.deadline_miss_rate,
            "shed": self.shed,
            "preemptions": self.preemptions,
            "wall_p50_s": self.wall_percentile(50),
            "wall_p95_s": self.wall_percentile(95),
            # fault-survival columns (zero in a fault-free life)
            "guard_rejected": self.guard_rejected,
            "guard_shed": self.guard_shed,
            "guard_retries": self.guard_retries,
            "degradations": self.degradations,
            "replans": self.replans,
            "plan_cache_hits": self.plan_cache_hits,
            "plan_cache_misses": self.plan_cache_misses,
            "plan_cache_hit_rate": (self.plan_cache_hits / cache_lookups
                                    if cache_lookups else 0.0),
            "max_quant_rel_err": self.max_quant_rel_err,
        }
