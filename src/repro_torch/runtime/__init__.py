"""Serving + reliability runtime.

``server.py``/``arbiter.py``/``batching.py``/``telemetry.py`` form the
adaptive-IP serving subsystem — multi-tenant budget arbitration,
shape-bucketed batching, live re-planning.  ``scheduler.py`` adds the
SLO-aware continuous-batching dispatch loop and ``recovery.py`` the
plan-preserving restart path on top of ``fault_tolerance.py``'s
watchdog / straggler / elastic-remesh hooks.  ``faults.py``
(deterministic fault injection) and ``guards.py`` (output screening +
bounded deadline-aware retry + degraded-mesh survival) are the chaos
half.
"""
from repro_torch.runtime.arbiter import BudgetArbiter, TenantShare
from repro_torch.runtime.batching import Request, ShapeBucketQueue
from repro_torch.runtime.faults import (FAULT_KINDS, INJECTOR, DeviceLost,
                                        FaultInjector, FaultSpec,
                                        InjectedFault)
from repro_torch.runtime.guards import (GuardPolicy, GuardReport,
                                        GuardViolation, backoff_schedule,
                                        execute_guarded, screen_finite)
from repro_torch.runtime.recovery import (RecoveryManager, recover_server,
                                          simulate_worker_death,
                                          snapshot_server)
from repro_torch.runtime.scheduler import SLOScheduler, SLOSpec
from repro_torch.runtime.server import AdaptiveServer, Completion, Tenant
from repro_torch.runtime.telemetry import TenantTelemetry

__all__ = [
    "AdaptiveServer", "BudgetArbiter", "Completion", "DeviceLost",
    "FAULT_KINDS", "FaultInjector", "FaultSpec", "GuardPolicy",
    "GuardReport", "GuardViolation", "INJECTOR", "InjectedFault",
    "RecoveryManager", "Request", "SLOScheduler", "SLOSpec",
    "ShapeBucketQueue", "Tenant", "TenantShare", "TenantTelemetry",
    "backoff_schedule", "execute_guarded", "recover_server",
    "screen_finite", "simulate_worker_death", "snapshot_server",
]
