"""Calibration keys — the two helpers the planner needs from the
measurement-calibrated cost model.

The measurement loop itself (timing samples on the card, affine fits,
``CalibrationTable``) is ROADMAP queue 1, item 7.  Until it lands the
planner runs on the analytical cost model only, and any
``calibration=`` table is refused with ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional


def member_key(ip_name: str, bits: Optional[int] = None,
               native_bits: int = 32) -> str:
    """The calibration key for one executed variant of a member: the
    qualified IP name, suffixed with ``@int<bits>`` when the precision
    ladder lowered the site below its native width."""
    if bits is not None and bits < native_bits:
        return f"{ip_name}@int{bits}"
    return ip_name


def calibration_key(calibration) -> Optional[tuple]:
    """The cache-key component for an optional table (None stays None,
    so the uncalibrated planner's keys are unchanged)."""
    if calibration is None:
        return None
    raise NotImplementedError(
        "calibration tables are not ported yet (ROADMAP queue 1, item 7: "
        "the measurement loop); plan with calibration=None")
