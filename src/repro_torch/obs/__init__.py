"""Observability: span tracer + event log (``obs.trace``), the plan
decision audit (``obs.audit``), the metrics registry and its Prometheus
exposition (``obs.metrics``) and calibration-drift detection
(``obs.drift``).  These modules import nothing from
``repro_torch.core`` or ``repro_torch.runtime`` at module level
(collector functions import lazily), so the planner and the runtime can
import them without cycles."""
from repro_torch.obs.audit import (CandidateRecord, PlanAudit, SiteAudit,
                                   SiteAuditRecorder, unfit_reason)
from repro_torch.obs.drift import DriftMonitor, DriftReport, mis_scaled_table
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, percentile,
                                     system_metrics)
from repro_torch.obs.trace import (EVENTS, NOOP_SPAN, TRACER, EventLog,
                                   SpanTracer, log_event)

__all__ = [
    "CandidateRecord", "PlanAudit", "SiteAudit", "SiteAuditRecorder",
    "unfit_reason",
    "DriftMonitor", "DriftReport", "mis_scaled_table",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "percentile",
    "system_metrics",
    "EVENTS", "NOOP_SPAN", "TRACER", "EventLog", "SpanTracer", "log_event",
]
