"""Graph-level network planner — whole-network resource mapping.

The paper selects one IP per op against the available resources; a CNN
is a *graph* of ops competing for the same envelope.  This module is
the single selection engine behind every family:

* ``select_ip(family, spec, budget)`` — the generic per-site selector.
  A family is plannable once it registers a site adapter on its
  ``IPFamily`` (``core/library.py``).
* ``plan_network(specs, budget)`` — maps a list of ``SiteSpec`` sites
  onto ONE budget by *partitioning* it: each site gets a slice
  proportional to its estimated cost, with a greedy repair pass that
  floors every site at the minimal slice its cheapest member needs.
  This replaces the "every op sees the full budget" fiction the
  per-call-site selectors lived with.
* The **precision ladder**: a ``SiteSpec`` may declare narrower operand
  widths it tolerates (``ladder=(16, 8)``).  When a site cannot fit at
  its current width — under the full budget or under its partitioned
  slice — the planner descends the ladder *before* declaring
  infeasibility, re-running selection at the lowered width so packed
  int8 members (conv2d.ip3_packed, int8 matmul) and shrunken footprints
  enter the race.  The chosen width lands in
  ``PlannedSite.precision_bits``, and the op wrappers execute a lowered
  site through ``quant/`` (fake-quant at 16 bits, the int8 kernels at 8).
* Plans are memoized on ``(graph-key, budget)`` — repeated trace-time
  calls (e.g. re-tracing ``apply_cnn_block``) are O(1) dict hits with
  zero new footprint evaluations — and serialize to/from JSON for
  experiment artifacts.  The cache is LRU with observable statistics
  (``plan_cache_stats()``: hits, misses, evictions, occupancy) — the
  serving runtime surfaces these per tenant.
* **Fusion groups** (``fuse=True``): adjacent site runs a registered
  fused family absorbs (``IPFamily.fuses`` + ``fuse_sites``, e.g.
  conv->pool->act -> one ``cnn_fused`` site) are substituted when the
  fused member's combined footprint is feasible at the full budget and
  prices at or below the unfused chain, with per-group fallback to the
  three-site plan when the fused footprint breaks the partition
  (docs/adaptive_ips.md, "Fusion contract").
* ``replan(specs, new_budget)`` — the live re-planning fast path: when
  the serving arbiter shifts a tenant's budget slice, the graph is
  unchanged and only the envelope moved, so the expensive full-budget
  baseline (one ``_select_site`` per site) is skipped by reusing the
  graph's memoized *cost shares*; only slice assignment (and, on
  failure, the needs-floor repair) re-runs under the new budget.
  ``strict=True`` verifies the heuristic against a cold plan
  (``replan_strict_mismatch`` counts divergences caught).
* ``network_min_fraction(specs, budget)`` — the smallest fraction of a
  budget under which the graph still plans (ladder rungs included);
  the arbiter floors each tenant's share here.
* **Calibrated cost** (``calibration=``): every decision point that
  *ranks* — member selection, fusion-group substitution, the
  partitioner's cost shares — accepts a measurement-derived
  ``CalibrationTable`` (``core/calibrate_cost.py``) and prices
  footprints by predicted wall-clock instead of analytical
  ``est_cycles``.  Feasibility (fits, needs floors,
  ``network_min_fraction``) is deliberately untouched: calibration
  rescales cost, not resources.  Plans memoize on the table's
  ``key()`` (schema version + fits fingerprint), so a refitted table
  never serves stale cached plans.
* ``mesh=`` (a ``MeshSpec`` of more than one device): mesh-sharded
  planning (``core/shard.py``), each device priced against the full
  per-device budget, each split's collectives in cycles at the mesh's
  link rate; ``distributed/shard_exec.py`` runs the plans.

Everything here is pure Python over shapes: no tensors.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

from repro_torch.core.calibrate_cost import calibration_key, member_key
from repro_torch.core.ip import IPFamily, KernelIP, SiteSpec
from repro_torch.core.resources import Footprint, MeshSpec, ResourceBudget
from repro_torch.obs.audit import PlanAudit, SiteAuditRecorder, unfit_reason
from repro_torch.obs.trace import NOOP_SPAN, TRACER, log_event

_PLAN_CACHE_MAX = 1024
_SHARE_CACHE_MAX = 1024


@dataclasses.dataclass
class PlannerStats:
    """Trace-time observability: how much selection work actually ran."""

    selector_evals: int = 0     # candidate footprints priced by _select
    plan_hits: int = 0
    plan_misses: int = 0
    plan_evictions: int = 0     # LRU entries displaced at capacity
    replan_fast: int = 0        # replan() misses served via cached shares
    replan_cold: int = 0        # replan() misses that fell to a cold plan
    replan_strict_mismatch: int = 0  # strict=True caught a divergent
                                     # fast-path assignment
    fused_sites: int = 0        # fusion groups substituted into plans
    fused_fallbacks: int = 0    # groups unfused because the fused
                                # footprint broke the partition

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class PartitionError(ValueError):
    """A graph's per-site minima jointly exceed the envelope — the
    partition (not any single site) is what failed.  Subclasses
    ValueError so callers keep catching the family-standard error; the
    fusion fallback keys on the type to know unfusing can help."""


STATS = PlannerStats()
# Insertion order is recency order: hits re-insert at the MRU end, and
# eviction pops the front — a plain dict is the LRU.
_PLAN_CACHE: Dict[tuple, "NetworkPlan"] = {}
# graph-key -> normalized full-budget cost shares (the replan fast path).
_SHARE_CACHE: Dict[tuple, Tuple[float, ...]] = {}
# original graph -> the fused/unfused site list the last cold plan
# settled on (the replan fast path re-uses it; a moved budget that
# breaks it falls back to a cold plan, which re-decides).
_FUSE_CACHE: Dict[tuple, Tuple[SiteSpec, ...]] = {}


def planner_stats() -> PlannerStats:
    return STATS


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _SHARE_CACHE.clear()
    _FUSE_CACHE.clear()


def _calkey_to_json(calkey):
    return list(calkey) if calkey is not None else None


def _calkey_from_json(raw):
    return tuple(raw) if raw is not None else None


def export_plan_cache() -> dict:
    """Serialize the planner's memo state — the plan-preserving-restart
    primitive (``runtime/recovery.py``); its JSON is byte-equal to the
    reference's for the same planning calls.

    ``plans`` round-trips every plan-cache entry with its full key
    exactly as ``plan_network`` builds it: the site specs
    (``SiteSpec.to_dict``), the budget, the fuse flag, the mesh, and
    the calibration-table identity — plus the plan itself
    (``NetworkPlan.to_json``).  ``shares`` and ``fuses`` carry the
    ``replan`` fast path's memoized cost shares and fused site lists,
    so a restored process keeps the fast path too (a drifted grant
    after restart re-assigns from shares instead of falling cold).  A
    process that imports these entries serves its first request off the
    cache instead of paying a cold re-plan storm.
    """
    plans = []
    for (specs, budget, fuse, mesh, calkey), plan in _PLAN_CACHE.items():
        plans.append({
            "specs": [s.to_dict() for s in specs],
            "budget": dataclasses.asdict(budget),
            "fuse": bool(fuse),
            "mesh": dataclasses.asdict(mesh) if mesh is not None else None,
            "calibration_key": _calkey_to_json(calkey),
            "plan": json.loads(plan.to_json()),
        })
    shares = [{
        "specs": [s.to_dict() for s in specs],
        "calibration_key": _calkey_to_json(calkey),
        "shares": list(sh),
    } for (specs, calkey), sh in _SHARE_CACHE.items()]
    fuses = [{
        "specs": [s.to_dict() for s in specs],
        "calibration_key": _calkey_to_json(calkey),
        "effective": [s.to_dict() for s in eff],
    } for (specs, calkey), eff in _FUSE_CACHE.items()]
    return {"plans": plans, "shares": shares, "fuses": fuses}


def import_plan_cache(state: dict) -> int:
    """Seed the planner memo state from ``export_plan_cache`` output
    (the restore half of plan-preserving restart).  Counts neither hits
    nor misses — importing is not planning.  Returns the number of
    plan-cache entries inserted."""
    def _specs(raw):
        return tuple(SiteSpec.from_dict(s) for s in raw)

    n = 0
    for e in state.get("plans", ()):
        budget = ResourceBudget(**e["budget"])
        mesh = MeshSpec(**e["mesh"]) if e.get("mesh") else None
        key = (_specs(e["specs"]), budget, bool(e["fuse"]), mesh,
               _calkey_from_json(e.get("calibration_key")))
        _cache_put(key, NetworkPlan.from_json(json.dumps(e["plan"])))
        n += 1
    for e in state.get("shares", ()):
        key = (_specs(e["specs"]),
               _calkey_from_json(e.get("calibration_key")))
        if key not in _SHARE_CACHE and len(_SHARE_CACHE) >= _SHARE_CACHE_MAX:
            _SHARE_CACHE.pop(next(iter(_SHARE_CACHE)))
        _SHARE_CACHE[key] = tuple(float(x) for x in e["shares"])
    for e in state.get("fuses", ()):
        key = (_specs(e["specs"]),
               _calkey_from_json(e.get("calibration_key")))
        if key not in _FUSE_CACHE and len(_FUSE_CACHE) >= _SHARE_CACHE_MAX:
            _FUSE_CACHE.pop(next(iter(_FUSE_CACHE)))
        _FUSE_CACHE[key] = _specs(e["effective"])
    return n


def plan_cache_stats() -> dict:
    """Cache observability for serving telemetry: occupancy + counters.

    Counters accumulate since process start (or the last manual reset of
    ``STATS``); callers wanting a window take two snapshots and diff.
    """
    lookups = STATS.plan_hits + STATS.plan_misses
    return {
        "size": len(_PLAN_CACHE),
        "capacity": _PLAN_CACHE_MAX,
        "hits": STATS.plan_hits,
        "misses": STATS.plan_misses,
        "evictions": STATS.plan_evictions,
        "replan_fast": STATS.replan_fast,
        "hit_rate": (STATS.plan_hits / lookups) if lookups else 0.0,
    }


def plan_cache_contains(specs, budget: Optional[ResourceBudget] = None, *,
                        fuse: bool = True, calibration=None,
                        mesh: Optional[MeshSpec] = None) -> bool:
    """True when the exact ``plan_network`` cache key is already warm.

    A pure membership probe — neither a hit nor a miss is counted and
    recency is untouched — so spare-plan pre-warming
    (``AdaptiveServer.prewarm_spares``) and the chaos gate can assert
    "this degraded-mesh key will serve hot" without perturbing the very
    statistics the zero-cold-replan claim is judged on."""
    budget = budget or ResourceBudget()
    key = (tuple(specs), budget, fuse, mesh, calibration_key(calibration))
    return key in _PLAN_CACHE


def _cache_get(key) -> Optional["NetworkPlan"]:
    plan = _PLAN_CACHE.pop(key, None)
    if plan is not None:
        _PLAN_CACHE[key] = plan        # refresh recency
    return plan


def _cache_put(key, plan: "NetworkPlan") -> None:
    if key not in _PLAN_CACHE and len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
        evicted = next(iter(_PLAN_CACHE))
        _PLAN_CACHE.pop(evicted)
        STATS.plan_evictions += 1
        log_event("plan_cache.evict", capacity=_PLAN_CACHE_MAX,
                  sites=len(evicted[0]), total=STATS.plan_evictions)
    _PLAN_CACHE[key] = plan


def _get_family(family: Union[str, IPFamily]) -> IPFamily:
    if isinstance(family, IPFamily):
        return family
    from repro_torch.core.library import get_family
    return get_family(family)


# ---------------------------------------------------------------------------
# The selection engine.
# ---------------------------------------------------------------------------
def _rank(ip: KernelIP, fp: Footprint, budget: ResourceBudget,
          calibration=None, cal_suffix: str = ""):
    """Ranking key: (primary cost, tie-breaks). Lower is better.
    With a ``calibration`` table the primary cost is the measured-model
    prediction for this member's executed variant (``ip.name`` plus the
    lowered-rung suffix); the pressure multipliers and VMEM tie-break
    are unchanged — they steer *which* resources are spent, calibration
    corrects *how much* the spend costs."""
    parallel_bonus = 0
    if budget.prefer_parallel_streams:
        parallel_bonus = 0 if fp.outputs_per_pass >= 2 else 1
    mxu_pressure = 0.0
    if budget.mxu_passes_budget is not None and budget.mxu_passes_budget > 0:
        mxu_pressure = fp.mxu_passes / budget.mxu_passes_budget
    vpu_pressure = 0.0
    if budget.vpu_ops_budget is not None and budget.vpu_ops_budget > 0:
        vpu_pressure = fp.vpu_ops / budget.vpu_ops_budget
    # Normalize per produced output so dual-stream members aren't
    # penalized for doing two ops' work.
    cycles = (fp.calibrated_cycles(calibration, ip.name + cal_suffix)
              / max(fp.outputs_per_pass, 1))
    return (parallel_bonus, cycles * (1.0 + mxu_pressure + vpu_pressure),
            fp.vmem_bytes)


def _select(candidates: Sequence[KernelIP], budget: ResourceBudget,
            fp_args: tuple, fp_kwargs: dict, op_bits: int,
            calibration=None, cal_suffix: str = "", recorder=None,
            bits: int = 32):
    """Returns the winning (KernelIP, Footprint) pair.  With a
    ``recorder`` (``obs.audit.SiteAuditRecorder``) every candidate's
    verdict is recorded — rejections with the concrete budget axis that
    failed (``unfit_reason``), feasible losers with their ranking cost
    — the raw material of ``NetworkPlan.explain()``."""
    feasible = []
    for ip in candidates:
        STATS.selector_evals += 1
        fp = ip.footprint(*fp_args, **fp_kwargs)
        if op_bits > fp.max_operand_bits:
            if recorder is not None:
                recorder.candidate(
                    ip.name, bits, "rejected",
                    f"{op_bits}-bit operands exceed member ceiling "
                    f"int{fp.max_operand_bits}")
            continue
        if not fp.fits(budget):
            if recorder is not None:
                recorder.candidate(ip.name, bits, "rejected",
                                   unfit_reason(fp, budget))
            continue
        rank = _rank(ip, fp, budget, calibration, cal_suffix)
        if recorder is not None:
            recorder.candidate(ip.name, bits, "feasible", cost=rank[1])
        feasible.append((rank, ip.name, ip, fp))
    if not feasible:
        raise ValueError(
            "no feasible IP under budget "
            f"{budget} for shape args {fp_args} (operand bits {op_bits}); "
            f"candidates: {[c.name for c in candidates]}")
    feasible.sort(key=lambda t: t[:2])
    return feasible[0][2], feasible[0][3]


def _width_budget(budget: ResourceBudget, spec: SiteSpec,
                  bits: int) -> ResourceBudget:
    """The budget a site sees when planned at ``bits``.  A ladder entry
    is the site's explicit waiver of the deployment-wide precision
    floor: lowering to 8 bits caps ``precision_bits`` at 8 so 8-bit
    members (the LUT activation, the packed conv) become legal."""
    if bits >= spec.native_bits or budget.precision_bits <= bits:
        return budget
    return dataclasses.replace(budget, precision_bits=bits)


def _select_site(spec: SiteSpec, budget: ResourceBudget, calibration=None,
                 recorder=None):
    """Select for one site, descending its precision ladder on failure.

    Widths are tried native-first (precision is only sacrificed when the
    current width genuinely does not fit); each rung re-enters the full
    selection race at the lowered operand width, which both shrinks
    footprints (narrower itemsize) and unlocks width-capped members.
    Returns ``(KernelIP, Footprint, bits)``; raises the family-standard
    error only after the narrowest rung fails.  A ``recorder`` collects
    every rung's candidate verdicts for the plan decision audit.
    """
    fam = _get_family(spec.family)
    widths = spec.widths()
    if not fam.quantizable:
        widths = widths[:1]
    span = (TRACER.span("select", "plan", {"site": spec.name})
            if TRACER.enabled else NOOP_SPAN)
    err = None
    with span:
        for bits in widths:
            req = fam.plan_site(spec.at_precision(bits))
            suffix = f"@int{bits}" if bits < spec.native_bits else ""
            try:
                ip, fp = _select(req.candidates,
                                 _width_budget(budget, spec, bits),
                                 req.fp_args, dict(req.fp_kwargs),
                                 req.op_bits, calibration, suffix,
                                 recorder=recorder, bits=bits)
                if recorder is not None:
                    recorder.chose(ip.name, bits)
                return ip, fp, bits
            except ValueError as e:
                err = err or e      # surface the native-width failure
    raise err


def _site_cost(ip: KernelIP, fp: Footprint, bits: int, spec: SiteSpec,
               calibration=None) -> float:
    """One selected site's ranking cost: calibrated (or analytical)
    cycles per produced output."""
    key = member_key(ip.name, bits, spec.native_bits)
    return fp.calibrated_cycles(calibration, key) / max(fp.outputs_per_pass, 1)


def select_ip(family: Union[str, IPFamily], spec: SiteSpec,
              budget: Optional[ResourceBudget] = None,
              with_footprint: bool = False, calibration=None):
    """Generic resource-driven selection for one site of any family.

    The family's registered site adapter turns ``spec`` into candidates
    + footprint arguments; feasibility and ranking are identical for
    every family (docs/adaptive_ips.md#selection-semantics).  Sites with
    a precision ladder descend it on failure exactly as ``plan_network``
    does (use ``plan_single`` when the chosen width matters).
    """
    fam = _get_family(family)
    if spec.family != fam.name:
        raise ValueError(f"site {spec.name!r} is a {spec.family!r} site, "
                         f"not {fam.name!r}")
    budget = budget or ResourceBudget()
    ip, fp, _ = _select_site(spec, budget, calibration)
    return (ip, fp) if with_footprint else ip


# ---------------------------------------------------------------------------
# Network plans
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlannedSite:
    """One site's resolved decision: the member, its price, the fraction
    of the network budget the partitioner granted it, the operand
    width the precision ladder settled on (== the spec's native width
    when no lowering was needed), and the sharding the mesh pass chose
    (``shard_axis``/``shard_degree``; degree 1 means replicated).

    ``spec`` stays the GLOBAL site — what the caller's shapes validate
    against; the per-device shard is recoverable via
    ``NetworkPlan.device_plan()``.  A sharded site's ``footprint`` is
    its per-device footprint with the collective traffic folded in:
    ``comm_cycles`` carries the collective term and ``est_cycles``
    already includes it."""

    spec: SiteSpec
    ip: KernelIP
    footprint: Footprint
    fraction: float
    precision_bits: int = 32
    shard_axis: str = "none"
    shard_degree: int = 1

    @property
    def lowered(self) -> bool:
        return self.precision_bits < self.spec.native_bits

    @property
    def sharded(self) -> bool:
        return self.shard_degree > 1


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """A whole network mapped onto one ResourceBudget.

    Mapping-like: ``plan["layer0.conv"]`` returns the ``(KernelIP,
    Footprint)`` pair (the same shape the ad-hoc plan dicts used, so
    ``describe_plan`` renders either).
    """

    budget: ResourceBudget
    sites: Tuple[PlannedSite, ...]
    # The mesh this plan was priced against (None = single device).  A
    # plan with mesh devices > 1 may carry sharded sites; execution runs
    # them device by device (distributed/shard_exec.py).
    mesh: Optional[MeshSpec] = None
    # The decision audit the planner recorded while building this plan:
    # per-site candidate sets with rejection reasons, ladder-descent
    # notes, and plan-level events (fusion/shard/repair).  Excluded from
    # equality — two plans that map identically ARE the same plan even
    # if one was deserialized without its audit.  Rendered by
    # ``explain()`` (docs/adaptive_ips.md, "Observability contract").
    audit: Optional[PlanAudit] = dataclasses.field(
        default=None, compare=False, repr=False)

    def site(self, name: str) -> PlannedSite:
        for s in self.sites:
            if s.spec.name == name:
                return s
        raise KeyError(f"no site {name!r} in plan; "
                       f"have {[s.spec.name for s in self.sites]}")

    def __getitem__(self, name: str):
        s = self.site(name)
        return s.ip, s.footprint

    def __contains__(self, name: str) -> bool:
        return any(s.spec.name == name for s in self.sites)

    def __len__(self) -> int:
        return len(self.sites)

    def __iter__(self):
        return (s.spec.name for s in self.sites)

    def items(self):
        return [(s.spec.name, (s.ip, s.footprint)) for s in self.sites]

    @property
    def total_cycles(self) -> float:
        return sum(s.footprint.est_cycles / max(s.footprint.outputs_per_pass, 1)
                   for s in self.sites)

    def calibrated_cycles(self, calibration) -> float:
        """Total cost under a measurement-derived ``CalibrationTable``
        (``core/calibrate_cost.py``): each site's footprint priced by
        the fit of its executed variant (lowered rungs keyed
        ``@int<bits>``).  ``calibration=None`` degrades to
        ``total_cycles`` — the analytical model."""
        return sum(_site_cost(s.ip, s.footprint, s.precision_bits, s.spec,
                              calibration)
                   for s in self.sites)

    @property
    def total_launches(self) -> int:
        """Kernel launches one execution of this plan issues — the
        number fusion collapses (3 -> 1 per fused CNN block)."""
        return sum(s.footprint.launches for s in self.sites)

    def precision_of(self, name: str) -> int:
        """The operand width the ladder settled on for one site."""
        return self.site(name).precision_bits

    def lowered_sites(self) -> Tuple[PlannedSite, ...]:
        """Sites the precision ladder actually lowered below native."""
        return tuple(s for s in self.sites if s.lowered)

    def sharded_sites(self) -> Tuple[PlannedSite, ...]:
        """Sites the mesh pass actually split past one device."""
        return tuple(s for s in self.sites if s.sharded)

    def device_plan(self) -> "NetworkPlan":
        """The per-device view of a sharded plan: each sharded site's
        GLOBAL spec replaced by its per-device shard — the shapes each
        device's execution sees, and what the apply-path plan/site
        validation must match against.  A plan with no sharded sites
        returns itself."""
        if not any(s.sharded for s in self.sites):
            return self
        from repro_torch.core.shard import shard_site_spec
        sites = tuple(
            dataclasses.replace(s, spec=shard_site_spec(
                s.spec, s.shard_axis, s.shard_degree))
            if s.sharded else s
            for s in self.sites)
        return dataclasses.replace(self, sites=sites)

    def describe(self) -> str:
        lines = []
        for s in self.sites:
            fp = s.footprint
            prec = (f"int{s.precision_bits}*" if s.lowered
                    else f"{s.precision_bits}b")
            shard = (f" {s.shard_axis}x{s.shard_degree}"
                     if s.sharded else "")
            lines.append(
                f"{s.spec.name:<40s} -> {s.ip.name:<28s} "
                f"p={prec:<6s} frac={s.fraction:5.3f} "
                f"vmem={fp.vmem_bytes/2**20:7.2f}MiB "
                f"mxu={fp.mxu_passes:<8d} vpu={fp.vpu_ops:.2e} "
                f"cyc={fp.est_cycles:.3e}{shard}")
        lines.append(f"{'TOTAL':<40s}    {'':<28s} "
                     f"cyc={self.total_cycles:.3e}")
        return "\n".join(lines)

    def explain(self) -> str:
        """Why this plan: per-site chosen member, every rejected
        candidate with the concrete budget axis that failed, ladder-
        descent notes, and the plan-level fusion/shard/repair events —
        the decision audit rendered for humans.  A plan that carries no
        audit (deserialized from pre-audit JSON) says so instead of
        pretending."""
        if self.audit is None:
            return "no audit recorded for this plan"
        return self.audit.render()

    # -- serialization ------------------------------------------------------
    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps({
            "budget": dataclasses.asdict(self.budget),
            "mesh": (dataclasses.asdict(self.mesh)
                     if self.mesh is not None else None),
            "audit": (self.audit.to_dict()
                      if self.audit is not None else None),
            "sites": [{
                "spec": s.spec.to_dict(),
                "ip": s.ip.name,
                "fraction": s.fraction,
                "precision_bits": s.precision_bits,
                "shard_axis": s.shard_axis,
                "shard_degree": s.shard_degree,
                "footprint": dataclasses.asdict(s.footprint),
            } for s in self.sites],
        }, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "NetworkPlan":
        from repro_torch.core.library import get_ip
        d = json.loads(text)
        sites = []
        for r in d["sites"]:
            spec = SiteSpec.from_dict(r["spec"])
            sites.append(PlannedSite(
                spec=spec,
                ip=get_ip(r["ip"]),
                fraction=float(r["fraction"]),
                precision_bits=int(r.get("precision_bits",
                                         spec.native_bits)),
                shard_axis=r.get("shard_axis", "none"),
                shard_degree=int(r.get("shard_degree", 1)),
                footprint=Footprint(**r["footprint"]),
            ))
        mesh = d.get("mesh")
        audit = d.get("audit")
        return cls(budget=ResourceBudget(**d["budget"]),
                   sites=tuple(sites),
                   mesh=MeshSpec(**mesh) if mesh else None,
                   audit=PlanAudit.from_dict(audit) if audit else None)


# ---------------------------------------------------------------------------
# Budget partitioning
# ---------------------------------------------------------------------------
def _min_fraction(fp: Footprint, budget: ResourceBudget) -> float:
    """Smallest budget fraction under which ``fp`` still fits, given the
    integer truncation in ``ResourceBudget.scaled`` (the +1 keeps the
    truncated slice strictly above the requirement)."""
    ratios = [0.0]
    if fp.vmem_bytes > 0 and budget.vmem_bytes > 0:
        ratios.append((fp.vmem_bytes + 1) / budget.vmem_bytes)
    if fp.hbm_bytes > 0 and budget.hbm_bytes > 0:
        ratios.append((fp.hbm_bytes + 1) / budget.hbm_bytes)
    if budget.mxu_passes_budget is not None and fp.mxu_passes > 0:
        ratios.append((fp.mxu_passes + 1) / budget.mxu_passes_budget)
    if budget.vpu_ops_budget is not None and fp.vpu_ops > 0:
        ratios.append((fp.vpu_ops + 1) / budget.vpu_ops_budget)
    return max(ratios)


def _site_need(spec: SiteSpec, budget: ResourceBudget) -> float:
    """Minimal fraction at which *some* candidate of this site is
    feasible — at its native width or any ladder rung (capped at 1.0;
    full-budget feasibility is checked separately)."""
    fam = _get_family(spec.family)
    widths = spec.widths() if fam.quantizable else spec.widths()[:1]
    best = None
    for bits in widths:
        req = fam.plan_site(spec.at_precision(bits))
        wb = _width_budget(budget, spec, bits)
        for ip in req.candidates:
            STATS.selector_evals += 1
            fp = ip.footprint(*req.fp_args, **dict(req.fp_kwargs))
            if req.op_bits > fp.max_operand_bits:
                continue
            if not fp.fits(wb):        # full budget: non-scalable gates too
                continue
            f = min(_min_fraction(fp, wb), 1.0)
            best = f if best is None else min(best, f)
    return 1.0 if best is None else best


def plan_network(specs: Iterable[SiteSpec],
                 budget: Optional[ResourceBudget] = None, *,
                 fuse: bool = True, calibration=None,
                 mesh: Optional[MeshSpec] = None) -> "NetworkPlan":
    """Map a network of sites onto one partitioned budget (memoized).

    Partitioning: fractions proportional to each site's cheapest
    full-budget cost; if any site has no feasible member under its
    slice, a greedy repair pass floors every site at its minimal
    feasible fraction and redistributes only the surplus.  Raises the
    family-standard ``ValueError`` when a site is infeasible even under
    the full budget, or when the sites' minimal needs exceed the
    envelope.

    ``fuse=True`` (the default since the calibration benchmarks showed
    the calibrated fused-vs-unfused ranking matches measured wall-clock
    on every budget; pass ``fuse=False`` to opt out) turns on
    **fusion-aware planning**: adjacent runs a
    registered fused family absorbs (e.g. conv->pool->act, declared via
    ``IPFamily.fuses``) are substituted by the single fused site when
    the fused member is feasible at the full budget and its combined
    footprint prices at or below the unfused chain's; groups whose
    fused footprint then breaks the partition are unfused again one at
    a time (largest minimal need first) until the plan closes — the
    fused plan can only ever *gain* feasibility over the unfused one.

    ``calibration=`` re-ranks every cost comparison (member selection,
    the fused-vs-unfused decision, the partition shares) by the table's
    measured-model predictions; feasibility and floors are unchanged.
    The plan cache keys on the table's identity
    (``CalibrationTable.key()``), so plans under different — or
    refitted — tables never collide.

    ``mesh=`` (a ``MeshSpec`` with devices > 1) turns on **mesh-sharded
    planning**: per site the planner chooses between replicating on one
    device and splitting across all of them (batch- or channel-
    parallel, ``core/shard.py``), pricing each split's collective
    traffic — psum for channel-split convs, boundary/egress all-gathers
    — in cycles at the mesh's link bandwidth via
    ``Footprint.comm_cycles``.  Each device sees the FULL ``budget``
    (that is what an N-device grant means); a site infeasible on one
    device but feasible split is rescued by the shard.  Sharded sites
    keep their GLOBAL spec (``NetworkPlan.device_plan()`` recovers the
    per-device view); ``distributed/shard_exec.py`` runs them.
    """
    budget = budget or ResourceBudget()
    key = (tuple(specs), budget, fuse, mesh, calibration_key(calibration))
    cached = _cache_get(key)
    if cached is not None:
        STATS.plan_hits += 1
        return cached
    STATS.plan_misses += 1
    with (TRACER.span("plan_network", "plan",
                      {"sites": len(key[0]), "fuse": fuse,
                       "mesh_devices": mesh.devices if mesh else 1})
          if TRACER.enabled else NOOP_SPAN):
        plan = _plan_uncached(key[0], budget, fuse=fuse,
                              calibration=calibration, mesh=mesh)
    _cache_put(key, plan)
    return plan


def replan(specs: Iterable[SiteSpec],
           budget: Optional[ResourceBudget] = None, *,
           fuse: bool = True, strict: bool = False,
           calibration=None,
           mesh: Optional[MeshSpec] = None) -> "NetworkPlan":
    """Re-plan a known graph under a moved budget — the serving fast path.

    Exact ``(graph, budget)`` repeats are cache hits like
    ``plan_network``.  On a miss for a graph planned before, the
    full-budget baseline (one ladder-descending selection per site —
    the bulk of a cold plan's footprint evaluations) is skipped by
    reusing the graph's memoized cost shares (and, with ``fuse=True``,
    its memoized fused/unfused site list); only slice assignment runs
    under the new budget, with the needs-floor repair on failure.  A
    graph never planned before falls through to ``plan_network``; so do
    fast-path failures, to surface the canonical errors (or rescue a
    plan the stale shares missed).  ``planner_stats()`` counts the
    split: ``replan_fast`` misses served off cached shares vs
    ``replan_cold`` misses that fell to a cold plan.

    **The fast path is a heuristic**: stale shares can settle on a
    different (still feasible, possibly less lowered) assignment than a
    cold plan of the same ``(graph, budget)`` would.  ``strict=True`` is
    the escape hatch: the fast-path result is verified against the cold
    plan and silently replaced by it on divergence
    (``replan_strict_mismatch`` counts the catches) — tests and audits
    run strict; the serving loop accepts the heuristic.

    With ``calibration=`` the fast path reuses only shares memoized
    under the *same* table identity — a refreshed (refitted) table
    finds no shares and falls cold, re-deriving the assignment from the
    new predictions instead of serving a stale-calibration split.

    With ``mesh=`` (devices > 1) the share heuristic does not apply —
    the sharding decisions depend on mesh geometry, not just the moved
    envelope — so the call goes through the full (memoized)
    ``plan_network`` path; exact repeats are still O(1) cache hits.
    """
    budget = budget or ResourceBudget()
    if mesh is not None and mesh.devices > 1:
        return plan_network(specs, budget, fuse=fuse, mesh=mesh,
                            calibration=calibration)
    specs = tuple(specs)
    calkey = calibration_key(calibration)
    # same key shape as plan_network (mesh slot None here) so no-mesh
    # replans and plans share cache entries
    key = (specs, budget, fuse, None, calkey)
    cached = None if strict else _cache_get(key)
    if cached is not None:
        STATS.plan_hits += 1
        return cached
    eff = _FUSE_CACHE.get((specs, calkey)) if fuse else specs
    shares = (_SHARE_CACHE.get((eff, calkey))
              if eff is not None else None)
    if shares is None:
        STATS.replan_cold += 1
        if not strict:
            return plan_network(specs, budget, fuse=fuse,
                                calibration=calibration)
        # strict must not trust plan_network's cache: a prior NON-strict
        # replan may have stored its heuristic plan under this very key.
        STATS.plan_misses += 1
        plan = _plan_uncached(specs, budget, fuse=fuse,
                              calibration=calibration)
        _cache_put(key, plan)
        return plan
    STATS.plan_misses += 1
    fell_cold = False
    try:
        with (TRACER.span("replan", "plan", {"sites": len(eff)})
              if TRACER.enabled else NOOP_SPAN):
            plan = _assign_with_repair(
                eff, budget, shares, calibration=calibration,
                events=["replan fast path: assignment from memoized "
                        "cost shares (no full-budget baseline)"])
        STATS.replan_fast += 1
    except ValueError:
        STATS.replan_cold += 1
        fell_cold = True
        plan = _plan_uncached(specs, budget, fuse=fuse,
                              calibration=calibration)
    if strict and not fell_cold:   # a fallen-cold plan IS the cold plan
        cold = _plan_uncached(specs, budget, fuse=fuse,
                              calibration=calibration)
        if _assignment(plan) != _assignment(cold):
            STATS.replan_strict_mismatch += 1
            plan = cold
    _cache_put(key, plan)
    return plan


def _assignment(plan: "NetworkPlan") -> tuple:
    """What 'same decision' means for strict replan verification: the
    member and operand width chosen per site (fractions may wiggle)."""
    return tuple((s.spec.name, s.ip.name, s.precision_bits)
                 for s in plan.sites)


def network_min_fraction(specs: Iterable[SiteSpec],
                         budget: Optional[ResourceBudget] = None) -> float:
    """Smallest fraction of ``budget`` under which ``specs`` still plans.

    The budget partitioner grants every site at least the minimal slice
    its cheapest member (at its cheapest legal ladder width) needs, so a
    scaled-down envelope is feasible exactly while those per-site minima
    still sum within it.  The serving arbiter floors each tenant's share
    here — with a ladder, the floor already reflects the narrowest rung
    the tenant tolerates (degrade-before-fail).
    """
    budget = budget or ResourceBudget()
    return min(1.0, sum(_site_need(s, budget) for s in specs))


def plan_single(spec: SiteSpec,
                budget: Optional[ResourceBudget] = None,
                calibration=None) -> "PlannedSite":
    """One-site plan (the kernels' ``budget=`` path): full budget, same
    engine, same memoization.  Returns the ``PlannedSite`` — callers
    needing only the member read ``.ip``; the quantized wrappers also
    read ``.precision_bits`` to decide whether to lower execution."""
    return plan_network((spec,), budget,
                        calibration=calibration).site(spec.name)


def _try_assign(specs: Tuple[SiteSpec, ...], budget: ResourceBudget,
                fractions: Sequence[float], calibration=None):
    """One assignment pass; returns (planned, failed, audits) where
    ``audits`` carries one ``SiteAudit`` per *planned* site (None for
    failed ones — a failed pass's audits die with it; the repair pass
    records the audits the final plan ships)."""
    planned, failed, audits = [], [], []
    for spec, frac in zip(specs, fractions):
        rec = SiteAuditRecorder(spec.name, spec.family, spec.native_bits)
        try:
            ip, fp, bits = _select_site(spec, budget.scaled(frac),
                                        calibration, recorder=rec)
            planned.append(PlannedSite(spec=spec, ip=ip, footprint=fp,
                                       fraction=frac,
                                       precision_bits=bits))
            audits.append(rec.finish(ip.name, bits, frac))
        except ValueError:
            planned.append(None)
            audits.append(None)
            failed.append(spec.name)
    return planned, failed, audits


def _assign_with_repair(specs: Tuple[SiteSpec, ...], budget: ResourceBudget,
                        shares: Sequence[float],
                        calibration=None, events=None) -> NetworkPlan:
    """Slice assignment under cost ``shares``, with the greedy repair:
    if any site has no feasible member under its proportional slice,
    every site is floored at the minimal slice its cheapest member (at
    its cheapest legal width) needs and only the surplus follows the
    shares.  ``events`` (a list) accumulates plan-level audit events;
    the built plan carries the full ``PlanAudit``."""
    events = events if events is not None else []
    planned, failed, audits = _try_assign(specs, budget, shares, calibration)
    if failed:
        needs = [_site_need(s, budget) for s in specs]
        total_need = sum(needs)
        if total_need > 1.0 + 1e-9:
            raise PartitionError(
                f"no feasible network plan under budget {budget}: sites "
                f"{[s.name for s in specs]} jointly need {total_need:.3f}x "
                f"the envelope "
                f"(per-site minima {['%.3f' % n for n in needs]})")
        surplus = 1.0 - total_need
        fractions = [need + surplus * share
                     for need, share in zip(needs, shares)]
        events.append(
            f"partition repair: sites {failed} infeasible at proportional "
            f"shares; floored every site at its minimal need "
            f"(total {total_need:.3f}) and redistributed the surplus")
        planned, failed, audits = _try_assign(specs, budget, fractions,
                                              calibration)
        if failed:  # pragma: no cover — needs floor guarantees feasibility
            raise ValueError(
                f"budget partition repair failed for sites {failed} under "
                f"{budget}")
    audit = PlanAudit(sites=tuple(audits), events=tuple(events))
    return NetworkPlan(budget=budget, sites=tuple(planned), audit=audit)


# ---------------------------------------------------------------------------
# Fusion groups — substitute a registered fused family's single site for
# the adjacent run of op sites it absorbs (docs/adaptive_ips.md,
# "Fusion contract").
# ---------------------------------------------------------------------------
def _fusion_groups(specs: Tuple[SiteSpec, ...]):
    """Adjacent runs some fused family absorbs: [(start, length,
    fused_spec)], non-overlapping, left-to-right greedy."""
    from repro_torch.core.library import FAMILIES
    fusers = [f for f in FAMILIES.values() if f.fuses and f.fuse_sites]
    groups = []
    i = 0
    while i < len(specs):
        step = 1
        for fam in fusers:
            ln = len(fam.fuses)
            run = specs[i:i + ln]
            if (len(run) == ln
                    and tuple(s.family for s in run) == fam.fuses):
                fspec = fam.fuse_sites(tuple(run))
                if fspec is not None:
                    groups.append((i, ln, fspec))
                    step = ln
                    break
        i += step
    return groups


def _substitute(specs: Tuple[SiteSpec, ...], groups) -> Tuple[SiteSpec, ...]:
    out = list(specs)
    for start, length, fspec in sorted(groups, reverse=True):
        out[start:start + length] = [fspec]
    return tuple(out)


def _fused_specs(specs: Tuple[SiteSpec, ...], select, calibration=None,
                 events=None):
    """The fusion decision at full budget: substitute a group's fused
    site when the fused member is feasible AND its combined footprint
    prices at or below the unfused chain's cheapest members (or the
    chain is outright infeasible — fusion can rescue it).  Returns
    ``(effective_specs, chosen_groups)``.

    This comparison is where the analytical model was most wrong
    (ROADMAP: fused modeled cheaper everywhere, measured slower on half
    the budgets), so with ``calibration`` both sides re-rank by the
    measured-model cost of their selected members — groups unfuse when
    the measurements say the one-launch member is the slower path."""
    chosen = []
    for start, length, fspec in _fusion_groups(specs):
        chain = [s.name for s in specs[start:start + length]]
        try:
            fip, ffp, fbits = select(fspec)
        except ValueError:
            if events is not None:
                events.append(
                    f"fusion rejected: {fspec.name} has no feasible "
                    f"member at the full budget; chain {chain} "
                    f"stays unfused")
            continue
        fcost = _site_cost(fip, ffp, fbits, fspec, calibration)
        try:
            ucost = 0.0
            for s in specs[start:start + length]:
                uip, ufp, ubits = select(s)
                ucost += _site_cost(uip, ufp, ubits, s, calibration)
        except ValueError:
            ucost = None
        if ucost is None or fcost <= ucost:
            chosen.append((start, length, fspec))
            if events is not None:
                why = ("unfused chain infeasible" if ucost is None else
                       f"cost {fcost:.3e} <= unfused chain {ucost:.3e}")
                events.append(
                    f"fusion: {fspec.name} replaces {chain} ({why})")
        elif events is not None:
            events.append(
                f"fusion rejected: {fspec.name} costs {fcost:.3e} > "
                f"unfused chain {ucost:.3e}; chain {chain} stays unfused")
    return _substitute(specs, chosen), chosen


def _plan_uncached(specs: Tuple[SiteSpec, ...], budget: ResourceBudget,
                   fuse: bool = False, calibration=None,
                   mesh: Optional[MeshSpec] = None) -> NetworkPlan:
    if not specs:
        return NetworkPlan(budget=budget, sites=(), mesh=mesh)
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate site names in network: {dupes}")
    calkey = calibration_key(calibration)

    # One full-budget selection per distinct site for this whole call:
    # the fusion decision and the baseline price the same specs, and the
    # fallback retries re-price surviving sites.
    memo: Dict[SiteSpec, tuple] = {}

    def select_full(spec: SiteSpec):
        if spec not in memo:
            memo[spec] = _select_site(spec, budget, calibration)
        return memo[spec]

    events: list = []
    eff, chosen = (_fused_specs(specs, select_full, calibration,
                                events=events) if fuse
                   else (specs, []))
    while True:
        try:
            if mesh is not None and mesh.devices > 1:
                # The sharding pass runs INSIDE the fallback loop: when
                # a fused group later unfuses, the new chain re-decides
                # its splits (the fused site's batch-only rule no
                # longer binds).
                from repro_torch.core.shard import plan_shard_decisions
                shardings = plan_shard_decisions(
                    eff, budget, mesh, select_full, calibration,
                    events=events)
                plan = _plan_effective(
                    tuple(sh.spec for sh in shardings), budget,
                    select_full, calibration=calibration, calkey=calkey,
                    events=events)
                plan = _apply_shardings(plan, eff, shardings, budget,
                                        mesh)
            else:
                plan = _plan_effective(eff, budget, select_full,
                                       calibration=calibration,
                                       calkey=calkey, events=events)
                if mesh is not None:
                    plan = dataclasses.replace(plan, mesh=mesh)
            break
        except ValueError as e:
            # Only a broken partition is fusion's fault (every chosen
            # fused member was verified feasible at the full budget); a
            # per-site "no feasible IP" cannot be fixed by unfusing.
            if not chosen or not isinstance(e, PartitionError):
                raise
            # The fused VMEM need broke the partition: unfuse the group
            # with the largest minimal slice and retry — the fully
            # unfused list is the guaranteed-no-worse floor.
            STATS.fused_fallbacks += 1
            needs = [(_site_need(f, budget), idx)
                     for idx, (_, _, f) in enumerate(chosen)]
            _, drop = max(needs)
            events.append(
                f"fusion fallback: unfused {chosen[drop][2].name} after "
                f"partition failure (largest minimal slice "
                f"{needs[drop][0]:.3f})")
            chosen = chosen[:drop] + chosen[drop + 1:]
            eff = _substitute(specs, chosen)
    if fuse:
        STATS.fused_sites += len(chosen)
        _FUSE_CACHE[(specs, calkey)] = eff
        if len(_FUSE_CACHE) > _SHARE_CACHE_MAX:
            _FUSE_CACHE.pop(next(iter(_FUSE_CACHE)))
    return plan


def _plan_effective(specs: Tuple[SiteSpec, ...], budget: ResourceBudget,
                    select=None, calibration=None, calkey=None,
                    events=None) -> NetworkPlan:
    # 1) Full-budget baseline: cost shares (raises "no feasible IP" for a
    #    site that cannot run even with everything — after descending its
    #    precision ladder, when it has one).
    if select is None:
        select = lambda s: _select_site(s, budget, calibration)  # noqa: E731
    if calkey is None:
        calkey = calibration_key(calibration)
    base = [select(s) for s in specs]
    costs = [_site_cost(ip, fp, bits, s, calibration)
             for s, (ip, fp, bits) in zip(specs, base)]
    total_cost = sum(costs) or 1.0
    shares = tuple(c / total_cost for c in costs)
    # Memoize the shares for replan(): they shift a little across
    # budgets (the baseline winners may differ), but stay a sound
    # starting assignment — the repair pass recomputes exact needs
    # under whatever budget replan() is handed.  Keyed on the
    # calibration fingerprint too: a refitted table changes the shares.
    if ((specs, calkey) not in _SHARE_CACHE
            and len(_SHARE_CACHE) >= _SHARE_CACHE_MAX):
        _SHARE_CACHE.pop(next(iter(_SHARE_CACHE)))
    _SHARE_CACHE[(specs, calkey)] = shares
    return _assign_with_repair(specs, budget, shares, calibration,
                               events=events)


def _apply_shardings(plan: NetworkPlan, eff: Tuple[SiteSpec, ...],
                     shardings, budget: ResourceBudget,
                     mesh: MeshSpec) -> NetworkPlan:
    """Map a plan built on per-device shard specs back to the GLOBAL
    specs, folding each site's collective cycles into its footprint:
    ``comm_cycles`` carries the collective term and ``est_cycles``
    grows by it, so ``total_cycles``/``calibrated_cycles`` price the
    traffic and the calibration layer can regress on the comm axis."""
    sites = []
    for ps, sh, gspec in zip(plan.sites, shardings, eff):
        if sh.degree > 1 or sh.comm_cycles:
            fp = dataclasses.replace(
                ps.footprint,
                est_cycles=ps.footprint.est_cycles + sh.comm_cycles,
                comm_cycles=sh.comm_cycles)
            sites.append(dataclasses.replace(
                ps, spec=gspec, footprint=fp, shard_axis=sh.axis,
                shard_degree=sh.degree))
        else:
            sites.append(ps)
    # dataclasses.replace keeps the audit the assignment pass recorded.
    return dataclasses.replace(plan, sites=tuple(sites), mesh=mesh)


# ---------------------------------------------------------------------------
# Fixed-IP baselines (the reference's benchmarks/table3): price a fixed
# family->member assignment over the same sites the planner maps.
# ---------------------------------------------------------------------------
def fixed_network_cost(specs: Iterable[SiteSpec],
                       members: Dict[str, str],
                       budget: Optional[ResourceBudget] = None,
                       calibration=None) -> Optional[float]:
    """Total est-cycles of a fixed assignment, or None if any site is
    infeasible.  Each site is generously priced against the FULL budget
    (no partitioning) — the planner has to win despite that handicap.

    ``members`` maps family name -> member name (short or qualified).
    ``calibration`` prices with measured scale factors when given, so the
    baseline and the planner are compared under the same cost model.
    """
    budget = budget or ResourceBudget()
    total = 0.0
    for spec in specs:
        fam = _get_family(spec.family)
        req = fam.plan_site(spec)
        want = members[spec.family]
        cands = {c.name: c for c in req.candidates}
        qual = want if "." in want else f"{spec.family}.{want}"
        ip = cands.get(qual)
        if ip is None:      # member not even a candidate for this site
            return None
        fp = ip.footprint(*req.fp_args, **dict(req.fp_kwargs))
        if req.op_bits > fp.max_operand_bits or not fp.fits(budget):
            return None
        total += _site_cost(ip, fp, spec.native_bits, spec, calibration)
    return total
