"""Plan decision audit — why the planner chose what it chose.

``plan_network`` makes four kinds of decisions that were previously
write-only: per-site member selection (with rejections), precision-
ladder descent, fusion-group substitution/fallback, and mesh shard
refusal.  This module is the record of those decisions:

* ``CandidateRecord`` — one (member, width) candidacy: chosen, feasible
  -but-outranked, or rejected with a **concrete** reason (the exact
  budget axis that failed, with numbers — ``unfit_reason`` mirrors
  ``Footprint.fits`` clause by clause).
* ``SiteAudit`` — one site's full candidate set across every ladder
  rung it tried, plus the fraction the partitioner granted it.
* ``PlanAudit`` — the per-site audits plus plan-level events (fusion
  decisions, partition repair, shard decisions/refusals).

The audit rides on ``NetworkPlan.audit`` (``core/plan.py``), renders
through ``NetworkPlan.explain()``, and round-trips through the plan's
JSON.  Recording happens on **cold plans only** — cache hits return the
memoized plan, audit included — so the amortized cost is zero on the
serving path.

Nothing here imports ``repro_torch.core``: reason helpers duck-type on the
footprint/budget attributes, keeping the obs package import-cycle-free.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


def unfit_reason(fp, budget) -> str:
    """The first budget axis ``fp`` fails, with numbers — mirrors
    ``Footprint.fits`` (core/resources.py) clause by clause so the
    reported reason is exactly why ``fits`` said no."""
    if fp.vmem_bytes > budget.vmem_bytes:
        return (f"vmem {fp.vmem_bytes / 1024:.0f}KiB > "
                f"budget {budget.vmem_bytes / 1024:.0f}KiB")
    if fp.hbm_bytes > budget.hbm_bytes:
        return (f"hbm {fp.hbm_bytes / 2**20:.1f}MiB > "
                f"budget {budget.hbm_bytes / 2**20:.1f}MiB")
    if fp.mxu_passes > 0 and not budget.mxu_available:
        return f"needs {fp.mxu_passes} MXU passes but mxu_available=False"
    if (budget.mxu_passes_budget is not None
            and fp.mxu_passes > budget.mxu_passes_budget):
        return (f"mxu_passes {fp.mxu_passes} > "
                f"budget {budget.mxu_passes_budget}")
    if (budget.vpu_ops_budget is not None
            and fp.vpu_ops > budget.vpu_ops_budget):
        return (f"vpu_ops {fp.vpu_ops:.2e} > "
                f"budget {budget.vpu_ops_budget:.2e}")
    if budget.precision_bits > fp.max_operand_bits:
        return (f"deployment needs {budget.precision_bits}-bit operands, "
                f"member ceiling is {fp.max_operand_bits}-bit")
    return "fits"       # defensive: caller only asks after fits() failed


@dataclasses.dataclass(frozen=True)
class CandidateRecord:
    """One (member, operand-width) candidacy at one selection."""

    member: str
    bits: int
    status: str                       # "chosen" | "feasible" | "rejected"
    reason: str = ""                  # non-empty iff rejected
    cost: Optional[float] = None      # ranking cycles when feasible

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CandidateRecord":
        return cls(member=d["member"], bits=int(d["bits"]),
                   status=d["status"], reason=d.get("reason", ""),
                   cost=d.get("cost"))


@dataclasses.dataclass(frozen=True)
class SiteAudit:
    """One site's selection record: every candidate tried at every
    ladder rung, the winner, and the budget fraction granted."""

    site: str
    family: str
    chosen: str
    chosen_bits: int
    native_bits: int
    fraction: float
    candidates: Tuple[CandidateRecord, ...] = ()
    notes: Tuple[str, ...] = ()

    @property
    def lowered(self) -> bool:
        return self.chosen_bits < self.native_bits

    def rejected(self) -> Tuple[CandidateRecord, ...]:
        return tuple(c for c in self.candidates if c.status == "rejected")

    def rejection_reasons(self) -> Tuple[str, ...]:
        """The distinct concrete reasons recorded against candidates of
        this site (order preserved)."""
        seen, out = set(), []
        for c in self.candidates:
            if c.status == "rejected" and c.reason and c.reason not in seen:
                seen.add(c.reason)
                out.append(f"{c.member}@{c.bits}b: {c.reason}")
        return tuple(out)

    def to_dict(self) -> dict:
        return {
            "site": self.site, "family": self.family,
            "chosen": self.chosen, "chosen_bits": self.chosen_bits,
            "native_bits": self.native_bits, "fraction": self.fraction,
            "candidates": [c.to_dict() for c in self.candidates],
            "notes": list(self.notes),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SiteAudit":
        return cls(
            site=d["site"], family=d["family"], chosen=d["chosen"],
            chosen_bits=int(d["chosen_bits"]),
            native_bits=int(d["native_bits"]),
            fraction=float(d["fraction"]),
            candidates=tuple(CandidateRecord.from_dict(c)
                             for c in d.get("candidates", ())),
            notes=tuple(d.get("notes", ())))


@dataclasses.dataclass(frozen=True)
class PlanAudit:
    """The whole plan's decision record: per-site audits + plan-level
    events (fusion substitutions/fallbacks, partition repair, shard
    decisions) in the order they happened."""

    sites: Tuple[SiteAudit, ...] = ()
    events: Tuple[str, ...] = ()

    def site(self, name: str) -> SiteAudit:
        for s in self.sites:
            if s.site == name:
                return s
        raise KeyError(f"no audit for site {name!r}; "
                       f"have {[s.site for s in self.sites]}")

    def with_events(self, *events: str) -> "PlanAudit":
        return dataclasses.replace(self,
                                   events=self.events + tuple(events))

    def to_dict(self) -> dict:
        return {"sites": [s.to_dict() for s in self.sites],
                "events": list(self.events)}

    @classmethod
    def from_dict(cls, d: dict) -> "PlanAudit":
        return cls(sites=tuple(SiteAudit.from_dict(s)
                               for s in d.get("sites", ())),
                   events=tuple(d.get("events", ())))

    def render(self) -> str:
        lines = []
        for ev in self.events:
            lines.append(f"[plan] {ev}")
        for s in self.sites:
            low = (f" (lowered from {s.native_bits}b)" if s.lowered else "")
            lines.append(f"{s.site}: chose {s.chosen} @{s.chosen_bits}b"
                         f"{low}, fraction {s.fraction:.3f}")
            for note in s.notes:
                lines.append(f"  - {note}")
            for c in s.candidates:
                if c.status == "chosen":
                    continue
                if c.status == "rejected":
                    lines.append(f"  x {c.member}@{c.bits}b rejected: "
                                 f"{c.reason}")
                else:
                    cost = ("" if c.cost is None
                            else f" (cost {c.cost:.3e})")
                    lines.append(f"  ~ {c.member}@{c.bits}b feasible but "
                                 f"outranked{cost}")
        return "\n".join(lines)


class SiteAuditRecorder:
    """Mutable scratch one ``_select_site`` call writes into; frozen
    into a ``SiteAudit`` once the partitioner settles the fraction.

    The recorder watches the ladder descend: when a site settles below
    its native width, a note names every rung that failed above it —
    the "precision-ladder descent" rejection reason the audit contract
    requires."""

    def __init__(self, site: str, family: str, native_bits: int):
        self.site = site
        self.family = family
        self.native_bits = native_bits
        self.records: List[CandidateRecord] = []
        self.notes: List[str] = []

    def candidate(self, member: str, bits: int, status: str,
                  reason: str = "", cost: Optional[float] = None) -> None:
        self.records.append(CandidateRecord(
            member=member, bits=bits, status=status, reason=reason,
            cost=cost))

    def chose(self, member: str, bits: int) -> None:
        """Promote the winning feasible record to "chosen"."""
        for i, r in enumerate(self.records):
            if (r.member == member and r.bits == bits
                    and r.status == "feasible"):
                self.records[i] = dataclasses.replace(r, status="chosen")
                return

    def note(self, text: str) -> None:
        self.notes.append(text)

    def finish(self, chosen: str, chosen_bits: int,
               fraction: float) -> SiteAudit:
        if chosen_bits < self.native_bits:
            failed = sorted({r.bits for r in self.records
                             if r.bits > chosen_bits}, reverse=True)
            if failed:
                self.notes.append(
                    "precision-ladder descent: no feasible member at "
                    + "/".join(f"{b}b" for b in failed)
                    + f"; settled at {chosen_bits}b")
        return SiteAudit(
            site=self.site, family=self.family, chosen=chosen,
            chosen_bits=chosen_bits, native_bits=self.native_bits,
            fraction=fraction, candidates=tuple(self.records),
            notes=tuple(self.notes))
