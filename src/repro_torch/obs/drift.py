"""Calibration drift monitor — is the cost model still telling the truth?

Replaces ``repro/obs/drift.py``.

``CalibrationTable`` (``core/calibrate_cost.py``) fits predicted
wall-clock from footprint axes; every planning decision then optimizes
those predictions.  But a fit is a snapshot of one host at one moment —
clocks and power state, co-tenant load, a library upgrade, or simply
serving shapes the warmup never measured all move the truth out from
under the table, and a planner optimizing a silently-drifted objective
caps the whole system.

``DriftMonitor`` closes the loop online:

* ``observe(member, footprint, measured_us)`` — compare the table's
  prediction for the executed variant against what the stopwatch just
  said; relative errors accumulate in a rolling window.
* **Drift rule**: once at least ``min_observations`` predictions are in
  the window, the monitor flags when their *mean relative error*
  exceeds ``threshold``.  The flag fires once per excursion (an
  ``on_drift`` callback plus a ``calibration.drift`` event in the
  event log), not once per observation.
* ``recalibrate()`` — the hook back into ``core/calibrate_cost.py``:
  every buffered observation is recorded as a calibration sample and
  the table refit, which moves its fingerprint (so the planner's
  memoized plans invalidate, per the calibration contract), clears the
  window, and re-arms the monitor.

Observations for members the table has no fit for (``predict_us`` is
None) are buffered for recalibration but produce no verdict — you
cannot drift from a prediction that was never made.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

from repro_torch.obs.trace import log_event

DRIFT_THRESHOLD = 0.5       # mean relative error that flags drift
DRIFT_WINDOW = 64           # observations the rolling mean covers
MIN_OBSERVATIONS = 4        # no verdict on fewer predictions
_BUFFER_MAX = 512           # recalibration samples kept


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One drift excursion: the window statistics at the moment the
    monitor flagged."""

    mean_rel_error: float
    threshold: float
    n_observations: int
    worst_member: str
    worst_rel_error: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class DriftMonitor:
    """Online predicted-vs-measured comparison; see module docstring."""

    def __init__(self, table, *, threshold: float = DRIFT_THRESHOLD,
                 window: int = DRIFT_WINDOW,
                 min_observations: int = MIN_OBSERVATIONS,
                 on_drift: Optional[Callable[[DriftReport], None]] = None):
        if threshold <= 0:
            raise ValueError("threshold must be positive")
        self.table = table
        self.threshold = float(threshold)
        self.min_observations = int(min_observations)
        self.on_drift = on_drift
        self.drifted = False
        self.reports: List[DriftReport] = []
        self.observations = 0           # total observe() calls
        self.predictions = 0            # observations the table covered
        # (member, rel_error) pairs the rolling mean covers
        self._window: Deque[Tuple[str, float]] = deque(maxlen=window)
        # (member, footprint, measured_us) buffered for recalibrate()
        self._buffer: List[tuple] = []

    # -- observation --------------------------------------------------------
    def observe(self, member: str, footprint,
                measured_us: float) -> Optional[DriftReport]:
        """Fold one measurement in.  ``member`` is the executed-variant
        key (``member_key(ip, bits, native)`` for lowered rungs).
        Returns the ``DriftReport`` when this observation trips the
        monitor, else None."""
        measured_us = float(measured_us)
        self.observations += 1
        self._buffer.append((member, footprint, measured_us))
        if len(self._buffer) > _BUFFER_MAX:
            del self._buffer[:len(self._buffer) - _BUFFER_MAX]
        predicted = self.table.predict_us(
            member, footprint.compute_cycles, footprint.hbm_bytes,
            footprint.comm_cycles)
        if predicted is None:
            return None                 # no fit -> no verdict
        self.predictions += 1
        rel = abs(predicted - measured_us) / max(measured_us, 1e-9)
        self._window.append((member, rel))
        if self.drifted or len(self._window) < self.min_observations:
            return None
        mean = sum(r for _, r in self._window) / len(self._window)
        if mean <= self.threshold:
            return None
        worst_member, worst = max(self._window, key=lambda t: t[1])
        report = DriftReport(
            mean_rel_error=mean, threshold=self.threshold,
            n_observations=len(self._window),
            worst_member=worst_member, worst_rel_error=worst)
        self.drifted = True
        self.reports.append(report)
        log_event("calibration.drift", mean_rel_error=mean,
                  threshold=self.threshold, n=len(self._window),
                  worst_member=worst_member)
        if self.on_drift is not None:
            self.on_drift(report)
        return report

    @property
    def mean_rel_error(self) -> float:
        if not self._window:
            return 0.0
        return sum(r for _, r in self._window) / len(self._window)

    def snapshot(self) -> dict:
        return {
            "drifted": self.drifted,
            "mean_rel_error": self.mean_rel_error,
            "threshold": self.threshold,
            "window": len(self._window),
            "observations": self.observations,
            "predictions": self.predictions,
            "excursions": len(self.reports),
            "table_fingerprint": self.table.fingerprint(),
        }

    # -- the recalibration hook --------------------------------------------
    def recalibrate(self) -> str:
        """Fold every buffered observation into the table as calibration
        samples (``CalibrationTable.record``), refit, clear the window,
        and re-arm.  Returns the table's new fingerprint — refitting
        moves it, so memoized plans keyed on the old identity invalidate
        exactly as the calibration contract requires."""
        for member, footprint, measured_us in self._buffer:
            self.table.record(member, footprint, measured_us)
        self.table.fit()
        self._buffer.clear()
        self._window.clear()
        self.drifted = False
        fp = self.table.fingerprint()
        log_event("calibration.refit", fingerprint=fp,
                  samples=self.table.sample_count())
        return fp


def mis_scaled_table(table, scale: float):
    """A copy of ``table`` with every fit's coefficients multiplied by
    ``scale`` — the synthetic "this table is lying" counterfactual the
    drift bench and tests feed the monitor (the honest table must stay
    quiet on the same measurements; the mis-scaled one must trip)."""
    import dataclasses as dc

    from repro_torch.core.calibrate_cost import CalibrationTable

    def scaled(fit):
        return dc.replace(
            fit,
            us_per_compute_cycle=fit.us_per_compute_cycle * scale,
            us_per_hbm_byte=fit.us_per_hbm_byte * scale,
            us_per_comm_cycle=fit.us_per_comm_cycle * scale,
            overhead_us=fit.overhead_us * scale)

    return CalibrationTable(
        samples=list(table.samples),
        fits={m: scaled(f) for m, f in table.fits.items()},
        global_fit=(scaled(table.global_fit)
                    if table.global_fit is not None else None),
        min_samples=table.min_samples)
