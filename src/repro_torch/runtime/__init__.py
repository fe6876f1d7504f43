"""Serving runtime: multi-tenant budget arbitration (``arbiter``),
shape-bucketed batching (``batching``), per-tenant telemetry
(``telemetry``) and the server that ties them to the planner
(``server``)."""
