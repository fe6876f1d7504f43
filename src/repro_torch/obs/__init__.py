"""Observability: span tracer + event log (``obs.trace``), the plan
decision audit (``obs.audit``) and the shared percentile estimator
(``obs.metrics``).  These modules import nothing from
``repro_torch.core`` or ``repro_torch.runtime``, so the planner and the
runtime can import them without cycles."""
