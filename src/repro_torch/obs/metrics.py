"""The shared percentile estimator.

``TenantTelemetry.latency_percentile`` delegates here, so every reader
of serving telemetry agrees on what "p95" means (sorted linear
interpolation, the rule ``numpy.percentile(..., method="linear")``
applies).  The metrics registry and its Prometheus exposition come with
the serving-runtime slice (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """q-th percentile (0..100) by sorted linear interpolation.  Empty
    input returns 0.0 (a gauge that has seen nothing reads zero, not
    NaN)."""
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
