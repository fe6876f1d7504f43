"""Fault-tolerance runtime: watchdog, straggler monitor, elastic re-mesh.

Replaces ``repro/runtime/fault_tolerance.py`` (same thresholds, latches,
events and mesh shapes).  On a multi-host deployment these hooks sit in
the per-host agent; here they watch one serving process.
``elastic_remesh`` builds both forms of the reference's mesh: the 2-D
("data", "model") training grid, a ``launch.mesh.Mesh``, and the
serving form, a 1-D mesh given as a tuple of ``torch.device``s (one a
rank, a card possibly repeated for logical devices) with its axis name.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Sequence

from repro_torch.obs.trace import log_event


# ---------------------------------------------------------------------------
# Watchdog: detects a hung/crashed step and triggers restart-from-ckpt.
# ---------------------------------------------------------------------------
class Watchdog:
    def __init__(self, timeout_s: float, on_timeout: Callable[[], None]):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._fired = False
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def beat(self):
        self._last_beat = time.monotonic()

    def stop(self) -> bool:
        """Stop monitoring and join the monitor thread.

        After ``stop()`` returns, no *new* ``on_timeout`` fires: the
        loop re-checks the stop flag right before firing (closing the
        window where the wait timed out just as ``stop`` was called).
        The join is bounded by ``max(timeout_s, 1.0)`` so a wedged
        callback cannot hang the caller; the return value reports
        whether the monitor actually terminated (``False`` means a
        callback was still in flight when the join timed out).  Safe to
        call before ``start()``, more than once, and from inside
        ``on_timeout`` itself (the fire-once pattern) — the monitor
        thread never joins itself.
        """
        self._stop.set()
        if (self._thread.ident is not None and self._thread.is_alive()
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=max(self.timeout_s, 1.0))
        return not self._thread.is_alive()

    @property
    def fired(self) -> bool:
        return self._fired

    def rearm(self) -> "Watchdog":
        """Clear a latched ``fired`` and restart the beat window.

        ``fired`` otherwise latches forever, so a deployment that
        recovered from one hang could never distinguish a SECOND one
        from the stale flag.  ``RecoveryManager.recover()`` re-arms
        after adopting the replacement server; callers with a live
        monitor thread can re-arm in place, callers whose ``on_timeout``
        stopped the watchdog (the fire-once pattern) need a fresh
        ``Watchdog`` instead — ``rearm`` does not resurrect a joined
        thread."""
        self._fired = False
        self._last_beat = time.monotonic()
        return self

    def _loop(self):
        while not self._stop.wait(min(self.timeout_s / 4, 1.0)):
            if (time.monotonic() - self._last_beat > self.timeout_s
                    and not self._stop.is_set()):
                self._fired = True
                log_event("watchdog.timeout", timeout_s=self.timeout_s)
                self.on_timeout()
                self._last_beat = time.monotonic()


# ---------------------------------------------------------------------------
# Straggler monitor: EWMA step-time outlier detection + mitigation hook.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ewma: float
    ratio: float


class StragglerMonitor:
    """Flags steps slower than ``threshold`` x the EWMA.  The mitigation
    hook is where a production deployment rebalances grad-accumulation
    microbatches away from the slow host or swaps in a hot spare.

    Every flagged step is recorded in ``events`` and logged through
    ``obs.EVENTS`` (``straggler.flagged``), but the mitigation hook is
    *rearm-gated*: after it fires, ``rearm`` consecutive normal steps
    must pass before it can fire again (``rearm=0`` fires on every
    flag) — a sustained slowdown triggers one mitigation, not one per
    step."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 warmup: int = 3, rearm: int = 0,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None):
        if rearm < 0:
            raise ValueError("rearm must be >= 0")
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.rearm = rearm
        self.on_straggler = on_straggler
        self.ewma: Optional[float] = None
        self.events: List[StragglerEvent] = []
        self.hook_fires = 0
        self._n = 0
        self._suppress = 0   # normal steps still owed before re-firing

    def record(self, step: int, step_time: float) -> Optional[StragglerEvent]:
        self._n += 1
        if self.ewma is None:
            self.ewma = step_time
            return None
        ev = None
        if self._n > self.warmup and step_time > self.threshold * self.ewma:
            ev = StragglerEvent(step, step_time, self.ewma,
                                step_time / self.ewma)
            self.events.append(ev)
            log_event("straggler.flagged", step=step, ratio=ev.ratio,
                      ewma=self.ewma, suppressed=self._suppress > 0)
            if self._suppress == 0:
                if self.on_straggler:
                    self.on_straggler(ev)
                self.hook_fires += 1
                self._suppress = self.rearm
            # don't poison the EWMA with the outlier
            return ev
        if self._suppress > 0:
            self._suppress -= 1
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
        return ev


# ---------------------------------------------------------------------------
# Elastic re-mesh: pick the best (data, model) mesh for surviving devices.
# Both helpers are expressed over core.shard.degree_ladder — the same
# divisor chain the arbiter's device-loss path descends (the degraded-
# mesh wiring in runtime/arbiter.py and runtime/server.py).
# ---------------------------------------------------------------------------
def choose_mesh_shape(n_devices: int, *, prefer_model: int = 16,
                      min_model: int = 1) -> tuple:
    """Largest (data, model) grid with model | prefer_model, covering as
    many surviving devices as possible (some may idle — correctness
    first, utilization second).  The model-degree candidates are exactly
    ``degree_ladder(prefer_model, survivors=n_devices)`` — a surviving
    model degree must keep the pre-loss model sharding divisible."""
    from repro_torch.core.shard import degree_ladder
    best = (1, 1)
    for model in degree_ladder(prefer_model,
                               survivors=min(prefer_model, n_devices)):
        if model < min_model:
            continue
        data = n_devices // model
        if data * model > best[0] * best[1]:
            best = (data, model)
    return best


def elastic_remesh(n_devices: int, prefer_model: int = 16, *,
                   axis: Optional[str] = None, offset: int = 0,
                   pool: Optional[Sequence] = None):
    """A mesh over surviving devices.  ``pool`` is the device pool
    (default: every CUDA card; a card may be named more than once for
    logical devices); too few devices raise, and no card is ever stood
    in for another.

    Default (``axis=None``): the training-style 2-D ("data", "model")
    grid over the first devices of ``pool``, shaped by
    ``choose_mesh_shape`` — a ``launch.mesh.Mesh``.

    ``axis=`` (serving mode — what ``AdaptiveServer`` executes degraded
    tenants through): ``(devices, axis)``, the 1-D mesh named ``axis``
    over the contiguous slice ``pool[offset : offset + n_devices]`` — a
    tenant's granted slice on the (possibly shrunk) pool."""
    import torch
    if pool is None:
        pool = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in pool]
    if axis is None:
        from repro_torch.launch.mesh import Mesh
        data, model = choose_mesh_shape(n_devices, prefer_model=prefer_model)
        if len(devs) < data * model:
            raise ValueError(
                f"mesh wants {data} x {model} devices but only {len(devs)} "
                f"exist (pass a device pool for logical devices)")
        grid = [devs[d * model:(d + 1) * model] for d in range(data)]
        return Mesh(grid, ("data", "model"))
    if offset < 0 or len(devs) < offset + n_devices:
        raise ValueError(
            f"mesh wants devices [{offset}, {offset + n_devices}) but only "
            f"{len(devs)} exist (pass a device pool for logical devices)")
    return tuple(devs[offset:offset + n_devices]), axis
