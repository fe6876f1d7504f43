"""Per-site quantization-error reporting (``repro/quant/report.py``).

``apply_cnn_block`` threads a report dict through execution and records,
for every site it runs, the relative error of the site output against
the family oracle evaluated in float32.  ``relative_error`` converts to
a Python float, one host sync per site per batch; the server asks for
reports only for tenants registered with ``measure_quant=True``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class SiteQuantReport:
    """One site's measured precision outcome."""

    site: str
    precision_bits: int
    rel_error: float        # ||got - ref|| / ||ref|| vs the f32 oracle

    @property
    def lowered(self) -> bool:
        return self.precision_bits < 32


def relative_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative Frobenius error, guarded for an all-zero reference."""
    got = got.to(torch.float32).reshape(-1)
    ref = ref.to(torch.float32).reshape(-1)
    return float(torch.linalg.vector_norm(got - ref)
                 / (torch.linalg.vector_norm(ref) + 1e-12))


def record(report: Dict[str, SiteQuantReport], site: str, bits: int,
           got: torch.Tensor, ref: torch.Tensor) -> None:
    report[site] = SiteQuantReport(site=site, precision_bits=bits,
                                   rel_error=relative_error(got, ref))


def max_rel_error(report: Dict[str, SiteQuantReport], *,
                  lowered_only: bool = True) -> float:
    """Worst per-site error in the report (0.0 when nothing qualifies)."""
    errs = [r.rel_error for r in report.values()
            if r.lowered or not lowered_only]
    return max(errs, default=0.0)


def summarize(report: Dict[str, SiteQuantReport]) -> str:
    lines = []
    for name in sorted(report):
        r = report[name]
        mark = f"int{r.precision_bits}" if r.lowered else "f32"
        lines.append(f"{name:<40s} {mark:<6s} rel_err={r.rel_error:.2e}")
    return "\n".join(lines)
