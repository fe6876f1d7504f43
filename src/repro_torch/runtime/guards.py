"""Execution guards: output screening + bounded deadline-aware retry.

Replaces ``repro/runtime/guards.py`` with the same policy, schedule,
events and outcomes.  The screen is one ``torch.isfinite(y).all()`` and
one ``.item()`` a batch: one host sync, not one a sample.  The guard
absorbs exactly the reference's set — ``DeviceLost``, then
``InjectedFault``, ``GuardViolation``, ``PartitionError`` and
``FloatingPointError`` — so a CUDA launch failure (``RuntimeError``), a
kernel's refusal of its operands (``ValueError``, ``TypeError``) or a
failed build propagates through a guarded tenant.

The fault injector (``faults.py``) makes failures reproducible; this
module is what turns them into degraded service instead of lost
requests.  A tenant opts in with a ``GuardPolicy``
(``AdaptiveServer.set_guard``); guarded batches then run through
``execute_guarded``:

* **Output screening** — ``torch.isfinite`` over the batch result.  A
  non-finite output (NaN-poisoned batch, corrupted collective) is
  handled per policy: ``on_nonfinite="reject"`` fails the requests
  immediately (a poisoned answer is worse than no answer);
  ``"retry_f32"`` re-executes the batch with the precision ladder off —
  the quantized rungs are the usual numerical suspects — and screens
  again.
* **Bounded deadline-aware retry** — transient faults (kernel-launch
  exceptions, injected failures) retry with exponential backoff, but the
  whole schedule is truncated against the batch's remaining ``SLOSpec``
  deadline budget (``backoff_schedule``): retry time is charged to the
  request's wall deadline, and work that cannot finish inside it is
  **shed**, not retried hopelessly.
* **Degrade on device loss** — ``DeviceLost`` is structural, not
  transient: the guard calls the ``on_device_loss`` hook (the server
  shrinks the mesh and re-grants) and retries immediately on the
  surviving devices; the degree ladder descends before the precision
  ladder does.

Every outcome is observable: ``retry.attempt`` per retry,
``guard.rejected`` when the guard gives up, and the per-tenant
telemetry columns ``guard_rejected`` / ``guard_shed`` /
``guard_retries``.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core.plan import PartitionError
from repro_torch.obs.trace import log_event
from repro_torch.runtime.faults import DeviceLost, InjectedFault

NONFINITE_POLICIES = ("reject", "retry_f32")

# Structural (device-loss) retries are bounded separately from the
# backoff schedule: one degrade per surviving rung is enough, and a
# corpse the control plane cannot shrink past must fail, not spin.
MAX_DEVICE_RETRIES = 2


class GuardViolation(RuntimeError):
    """A screened output failed the finiteness check."""


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """One tenant's survival policy for guarded execution.

    ``screen_outputs``: run the ``isfinite`` screen on every batch
    result.  ``on_nonfinite``: ``"reject"`` fails the batch,
    ``"retry_f32"`` re-executes with the precision ladder off first.
    ``max_retries`` bounds the transient-fault retry count;
    ``backoff_base_s`` * ``backoff_factor**i`` is retry ``i``'s delay,
    jittered by up to ``backoff_jitter`` (fraction, seeded — delays stay
    monotone non-decreasing)."""

    screen_outputs: bool = True
    on_nonfinite: str = "reject"
    max_retries: int = 2
    backoff_base_s: float = 0.005
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.0

    def __post_init__(self):
        if self.on_nonfinite not in NONFINITE_POLICIES:
            raise ValueError(f"on_nonfinite must be one of "
                             f"{NONFINITE_POLICIES}, got "
                             f"{self.on_nonfinite!r}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base_s < 0.0:
            raise ValueError("backoff_base_s must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1")
        if not 0.0 <= self.backoff_jitter <= 1.0:
            raise ValueError("backoff_jitter must be in [0, 1]")


def backoff_schedule(policy: GuardPolicy,
                     remaining_s: Optional[float] = None, *,
                     seed: int = 0) -> List[float]:
    """The retry delays a guarded batch may spend, in order.

    Three properties the property tests hold (tests/test_torch_guards.py):
    the schedule is **deterministic** under a fixed seed, delays are
    **monotone non-decreasing**, and the **total never exceeds
    ``remaining_s``** (the request's remaining deadline budget) — the
    schedule is truncated at the first delay that would overdraw it, so
    a hopeless retry is shed instead of attempted."""
    limit = float("inf") if remaining_s is None else max(float(remaining_s),
                                                         0.0)
    rnd = random.Random(seed)
    delays: List[float] = []
    total = prev = 0.0
    for i in range(policy.max_retries):
        d = policy.backoff_base_s * policy.backoff_factor ** i
        if policy.backoff_jitter > 0.0:
            d *= 1.0 + policy.backoff_jitter * rnd.random()
        d = max(d, prev)               # jitter can never break monotonicity
        if total + d > limit:
            break
        delays.append(d)
        total += d
        prev = d
    return delays


def screen_finite(y) -> bool:
    """True when every element of the batch result is finite (one
    reduction on the result's device and one host sync)."""
    return bool(torch.isfinite(torch.as_tensor(y)).all().item())


@dataclasses.dataclass
class GuardReport:
    """What guarded execution did to one batch: the terminal ``outcome``
    (``ok`` / ``rejected`` / ``shed``), retries spent, whether the
    precision ladder was switched off, and the give-up reason."""

    outcome: str = "ok"
    retries: int = 0
    retried_f32: bool = False
    reason: str = ""


def execute_guarded(attempt: Callable[..., object], policy: GuardPolicy, *,
                    tenant: str = "", remaining_s: Optional[float] = None,
                    wall: Callable[[], float] = time.monotonic,
                    sleep: Callable[[float], None] = time.sleep,
                    on_device_loss: Optional[Callable] = None,
                    seed: int = 0) -> Tuple[Optional[object], GuardReport]:
    """Run ``attempt(retry_f32=...)`` under ``policy``.

    Returns ``(result, report)`` — result is None when the guard gave up
    (``report.outcome`` says whether the batch was *rejected* — faulty
    beyond the retry budget or screened out by policy — or *shed* —
    still failing with no deadline budget left to retry in).  ``sleep``
    and ``wall`` are injectable for tests; retry delays run through the
    real ``sleep`` in serving, so retry time is charged against the
    request's wall-clock deadline."""
    deadline = (None if remaining_s is None
                else wall() + max(float(remaining_s), 0.0))
    delays = backoff_schedule(policy, remaining_s, seed=seed)
    truncated = len(delays) < policy.max_retries
    report = GuardReport()
    retry_f32 = False
    device_retries = 0
    while True:
        try:
            y = attempt(retry_f32=retry_f32)
            if policy.screen_outputs and not screen_finite(y):
                raise GuardViolation("non-finite output")
            return y, report
        except DeviceLost as e:
            # structural, not transient: degrade the mesh, retry free
            if on_device_loss is None or device_retries >= MAX_DEVICE_RETRIES:
                report.outcome, report.reason = "rejected", str(e)
                break
            try:
                on_device_loss(e)
            except Exception as degrade_err:
                report.outcome = "rejected"
                report.reason = f"degradation failed: {degrade_err}"
                break
            device_retries += 1
            report.retries += 1
            log_event("retry.attempt", tenant=tenant,
                      attempt=report.retries, delay_s=0.0,
                      cause="device_lost")
        except (InjectedFault, GuardViolation, PartitionError,
                FloatingPointError) as e:
            nonfinite = isinstance(e, GuardViolation)
            if nonfinite and policy.on_nonfinite == "reject":
                report.outcome, report.reason = "rejected", str(e)
                break
            i = report.retries - device_retries   # backoff delays consumed
            if i >= len(delays):
                # out of retry budget: "shed" when the deadline truncated
                # the schedule, "rejected" when the retry count did
                report.outcome = "shed" if truncated else "rejected"
                report.reason = f"retries exhausted: {e}"
                break
            delay = delays[i]
            if deadline is not None and wall() + delay >= deadline:
                report.outcome = "shed"
                report.reason = f"hopeless within deadline: {e}"
                break
            if nonfinite and policy.on_nonfinite == "retry_f32":
                retry_f32 = True
                report.retried_f32 = True
            report.retries += 1
            log_event("retry.attempt", tenant=tenant,
                      attempt=report.retries, delay_s=delay,
                      cause="nonfinite" if nonfinite else "fault")
            sleep(delay)
    log_event("guard.rejected", tenant=tenant, outcome=report.outcome,
              retries=report.retries, reason=report.reason)
    return None, report
