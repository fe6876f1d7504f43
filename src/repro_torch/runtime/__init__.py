"""Serving runtime: multi-tenant budget arbitration (``arbiter``),
shape-bucketed batching (``batching``), per-tenant telemetry
(``telemetry``), the server that ties them to the planner (``server``)
and the SLO-aware continuous-batching dispatch loop over it
(``scheduler``).  Faults, guards and recovery are ROADMAP queue 1,
item 8, part 2."""
from repro_torch.runtime.arbiter import BudgetArbiter, TenantShare
from repro_torch.runtime.batching import Request, ShapeBucketQueue
from repro_torch.runtime.scheduler import SLOScheduler, SLOSpec
from repro_torch.runtime.server import AdaptiveServer, Completion, Tenant
from repro_torch.runtime.telemetry import TenantTelemetry

__all__ = [
    "AdaptiveServer", "BudgetArbiter", "Completion", "Request",
    "SLOScheduler", "SLOSpec", "ShapeBucketQueue", "Tenant", "TenantShare",
    "TenantTelemetry",
]
