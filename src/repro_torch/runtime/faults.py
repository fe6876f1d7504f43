"""Deterministic fault injection for the serving runtime.

Replaces ``repro/runtime/faults.py``: the same kinds, seams, events and
seeded draws, so one schedule and seed fire at the same polls in both
packages.  ``perturb_output`` poisons a copy of the result (``clone``,
then the write): a tensor the caller holds is never written.

The paper's resource-driven claim is only credible if the runtime
survives the resources *changing under it* — a mesh device dying, a
kernel launch failing, a collective delivering garbage.  This module is
the chaos half of that claim: a seeded ``FaultInjector`` replays a
declarative fault schedule into well-defined *seams* of the serving
path, so every failure mode the survival machinery (``guards.py``,
``BudgetArbiter.on_device_loss``) must absorb is reproducible
bit-for-bit across runs.

Fault taxonomy (``FAULT_KINDS``) and the seam each fires at:

===================  =========  ==============================================
kind                 seam       effect
===================  =========  ==============================================
``device_loss``      execute    a device index joins ``lost``; any execution
                                whose device slice overlaps it raises
                                ``DeviceLost`` until the control plane shrinks
                                the mesh past it
``kernel_exception`` execute    the batch's kernel launch raises
                                ``InjectedFault``
``budget_shrink``    execute    the server's device budget scales down
                                mid-serving (``AdaptiveServer.on_budget_shrink``)
``nan_output``       output     element ``[0, ...]`` of the batch result
                                becomes NaN (what output screening must catch)
``collective_corrupt``  collective  element ``[0, ...]`` of a sharded
                                execution's gathered result becomes Inf
``latency_spike``    lane       the batch's modeled service cycles multiply
                                by ``param`` (default 4x)
===================  =========  ==============================================

Injection contract (mirrors ``obs.trace.TRACER``): the **disabled path
is bit-transparent** — every seam is one ``INJECTOR.enabled`` attribute
read and one branch; no counters move, no RNG draws, no allocation.
``table_chaos`` asserts a disarmed serving run produces identical
outputs, plans, and cache keys to a never-firing armed run.

Determinism: ``arm(schedule, seed=...)`` resets all per-seam step
counters and seeds one ``random.Random``; a step-triggered spec fires
on the Nth poll of its seam (0-based), a probability-triggered spec
draws from the seeded stream in schedule order — the same schedule and
seed replay the same faults against the same serving trace.

Device-loss simulation: a device that dies mid-run cannot be staged, so
the injector *is* the failure — ``lose()`` marks the index, and
``check_devices`` raises for any execution whose granted slice still
overlaps it.  Convention: lose the highest device index, so after the
arbiter shrinks the pool the surviving contiguous slices no longer
overlap the corpse.  On one device (no mesh) the server's
``on_device_loss`` raises, and a guard rejects the batch.
"""
from __future__ import annotations

import dataclasses
import random
from contextlib import contextmanager
from typing import List, Optional, Sequence, Tuple

from repro_torch.obs.trace import log_event

FAULT_KINDS = ("device_loss", "kernel_exception", "collective_corrupt",
               "nan_output", "latency_spike", "budget_shrink")

# kind -> the seam whose poll it answers to
SEAM_OF = {
    "device_loss": "execute",
    "kernel_exception": "execute",
    "budget_shrink": "execute",
    "nan_output": "output",
    "collective_corrupt": "collective",
    "latency_spike": "lane",
}


class InjectedFault(RuntimeError):
    """An injected failure surfacing where the real one would."""


class DeviceLost(InjectedFault):
    """An execution's device slice overlaps a lost device."""

    def __init__(self, message: str, device: Optional[int] = None):
        super().__init__(message)
        self.device = device


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault: *what* (``kind``), *when* (``step`` = fire
    on the Nth poll of the kind's seam, 0-based — or ``p`` = seeded
    per-poll probability), *whom* (``tenant``, None = any), and a
    kind-specific ``param`` (device index / latency factor / budget
    fraction).  ``once=True`` retires the spec after its first fire, so
    a guarded retry of the same batch passes."""

    kind: str
    step: Optional[int] = None
    p: float = 0.0
    tenant: Optional[str] = None
    once: bool = True
    param: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {FAULT_KINDS}")
        if self.step is None and self.p <= 0.0:
            raise ValueError("a FaultSpec needs step= (deterministic) "
                             "or p= (seeded probability)")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError("p must be in [0, 1]")


class FaultInjector:
    """The process-wide injection switchboard (singleton ``INJECTOR``).

    Disabled by default; ``arm(schedule, seed=)`` enables it for the
    given schedule, ``disarm()`` restores the transparent state.  All
    mutable state — per-seam step counters, the retired-spec mask, the
    lost-device set, the fired log — only ever changes while enabled.
    """

    def __init__(self):
        self.enabled = False
        self._specs: Tuple[FaultSpec, ...] = ()
        self._live: List[bool] = []
        self._counters: dict = {}
        self._rng: Optional[random.Random] = None
        self.lost: set = set()
        self.fired: List[tuple] = []   # (kind, seam, step, tenant)

    def arm(self, schedule: Sequence[FaultSpec], *, seed: int = 0) -> None:
        specs = tuple(schedule)
        for s in specs:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"schedule entries must be FaultSpec, "
                                f"got {type(s)!r}")
        self._specs = specs
        self._live = [True] * len(specs)
        self._counters = {}
        self._rng = random.Random(seed)
        self.lost = set()
        self.fired = []
        self.enabled = bool(specs)

    def disarm(self) -> None:
        self.enabled = False
        self._specs = ()
        self._live = []
        self._counters = {}
        self._rng = None
        self.lost = set()
        self.fired = []

    @contextmanager
    def armed(self, schedule: Sequence[FaultSpec], *, seed: int = 0):
        self.arm(schedule, seed=seed)
        try:
            yield self
        finally:
            self.disarm()

    def counters(self) -> dict:
        """Per-seam poll counts (empty while the injector has never been
        armed — the transparency tests assert exactly that)."""
        return dict(self._counters)

    # -- the seam protocol --------------------------------------------------
    def poll(self, seam: str, tenant: Optional[str] = None
             ) -> List[FaultSpec]:
        """Advance ``seam``'s step counter and return the specs due at
        this poll (matching seam + tenant filter + trigger).  Each fire
        is logged as a ``fault.injected`` event; ``once`` specs retire."""
        if not self.enabled:
            return []
        step = self._counters.get(seam, 0)
        self._counters[seam] = step + 1
        due: List[FaultSpec] = []
        for i, spec in enumerate(self._specs):
            if not self._live[i] or SEAM_OF[spec.kind] != seam:
                continue
            if (spec.tenant is not None and tenant is not None
                    and spec.tenant != tenant):
                continue
            if spec.step is not None:
                hit = spec.step == step
            else:
                hit = self._rng.random() < spec.p
            if not hit:
                continue
            if spec.once:
                self._live[i] = False
            self.fired.append((spec.kind, seam, step, tenant))
            log_event("fault.injected", fault=spec.kind, seam=seam,
                      step=step, tenant=tenant or "", param=spec.param)
            due.append(spec)
        return due

    # -- device-loss simulation ---------------------------------------------
    def lose(self, device: int) -> None:
        """Mark one device index dead (the ``device_loss`` effect)."""
        self.lost.add(int(device))

    def check_devices(self, start: int, stop: int) -> None:
        """Raise ``DeviceLost`` when the [start, stop) device slice an
        execution is about to run on overlaps a lost device — the
        single-host stand-in for the launch failing on the dead chip."""
        if not self.lost:
            return
        hit = sorted(d for d in self.lost if start <= d < stop)
        if hit:
            raise DeviceLost(
                f"device(s) {hit} lost; execution slice [{start}, {stop}) "
                f"still overlaps the corpse — shrink the mesh "
                f"(on_device_loss) before retrying", device=hit[-1])

    # -- output perturbation --------------------------------------------------
    def perturb_output(self, seam: str, y, tenant: Optional[str] = None):
        """``nan_output`` / ``collective_corrupt``: poison element
        ``[0, ...]`` of the result due at this poll of ``seam`` (NaN for
        the output seam, Inf for the collective seam).  Writes a copy;
        ``y`` itself is left as it was."""
        for spec in self.poll(seam, tenant):
            val = float("nan") if spec.kind == "nan_output" else float("inf")
            y = y.clone()
            y[(0,) * y.dim()] = val
        return y

    def scale_latency(self, cycles: float,
                      tenant: Optional[str] = None) -> float:
        """``latency_spike``: multiply a batch's modeled service cycles
        by the spec's ``param`` (default 4x)."""
        for spec in self.poll("lane", tenant):
            cycles *= spec.param if spec.param > 0 else 4.0
        return cycles


INJECTOR = FaultInjector()
