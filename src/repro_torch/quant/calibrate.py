"""Calibration — activation ranges from sample batches
(``repro/quant/calibrate.py``).

``Calibrator`` accumulates running |x|-max ranges per named site over
the batches it is fed, then hands back per-site scales that
``quantize_acts(x, scale=...)`` consumes, so serving can quantize
against frozen ranges instead of per-batch statistics.  Ranges
serialize to and from plain dicts.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.quant.quantize import (MIN_SCALE, QuantizedTensor, qmax,
                                        quantize_acts)


class Calibrator:
    """Running per-site activation ranges (symmetric |x|-max)."""

    def __init__(self, momentum: Optional[float] = None):
        """``momentum=None`` keeps the running max over all observed
        batches; ``momentum=m`` keeps an EMA ``m * old + (1-m) * batch``."""
        self.momentum = momentum
        self._amax: Dict[str, float] = {}
        self._batches: Dict[str, int] = {}

    def observe(self, site: str, x: torch.Tensor) -> None:
        batch = float(x.to(torch.float32).abs().amax())
        old = self._amax.get(site)
        if old is None or self.momentum is None:
            new = batch if old is None else max(old, batch)
        else:
            new = self.momentum * old + (1.0 - self.momentum) * batch
        self._amax[site] = new
        self._batches[site] = self._batches.get(site, 0) + 1

    def sites(self):
        return sorted(self._amax)

    def amax(self, site: str) -> float:
        return self._amax[site]

    def scale(self, site: str, *, bits: int = 8) -> float:
        """The frozen quantization scale for ``site`` at ``bits`` width."""
        if site not in self._amax:
            raise KeyError(f"site {site!r} was never observed; "
                           f"have {self.sites()}")
        return max(self._amax[site], MIN_SCALE) / qmax(bits)

    def quantize(self, site: str, x: torch.Tensor, *,
                 bits: int = 8) -> QuantizedTensor:
        """Quantize against the calibrated (not the batch) range."""
        return quantize_acts(x, bits=bits, scale=self.scale(site, bits=bits))

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {"momentum": self.momentum,
                "amax": dict(self._amax),
                "batches": dict(self._batches)}

    @classmethod
    def from_dict(cls, d: dict) -> "Calibrator":
        cal = cls(momentum=d.get("momentum"))
        cal._amax = {k: float(v) for k, v in d.get("amax", {}).items()}
        cal._batches = {k: int(v) for k, v in d.get("batches", {}).items()}
        return cal
