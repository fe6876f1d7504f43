"""Measurement-calibrated cost model — close the loop the paper leaves open.

Replaces ``repro/core/calibrate_cost.py``.

``Footprint.est_cycles`` is an *analytical* cost: compute cycles plus DMA
cycles from first principles (``core/resources.py::cost_cycles``), in the
reference's cost units.  It ranks members well within a family, but
across execution paths it can be provably wrong: the reference measured
fused plans modeled strictly cheaper on all 6 of its fusion budgets
while measured wall-clock was *slower* on 3 of them.  A planner
optimizing a wrong objective caps the whole system, so this module adds
the hardware-measured feedback loop:

1. **Record** ``(family, member, footprint, measured us)`` samples — the
   timing substrate is one median-of-N harness (``timeit_us``), and
   ``measure_planned_site`` / ``collect_plan_samples`` execute exactly
   the members a ``NetworkPlan`` chose, lowered rungs included, through
   the op wrappers the served path calls.
2. **Fit** a per-(family, member) affine model over the footprint's
   analytical axes::

       predicted_us = a * compute_cycles + b * hbm_bytes + c

   by least squares with coefficients clamped nonnegative (so calibrated
   cost is nondecreasing in compute and traffic, and never negative).  A
   member with fewer than ``min_samples`` (default 3) observations falls
   back to one *global* fit over every sample — a coarse scale is sounder
   than an unconstrained plane through two points.
3. **Predict**: ``CalibrationTable.calibrated_cycles(footprint, member)``
   converts the predicted wall-clock back into cycle units
   (``us * CLOCK_HZ``) so calibrated and analytical costs stay mutually
   comparable; a member no fit covers (empty table) keeps its
   ``est_cycles`` — the identity calibration.

The planner consumes the table through ``calibration=`` parameters
(``core/plan.py``): member ranking, fusion-group substitution, and the
partitioner's cost shares all re-rank by calibrated cost, while
*feasibility* (``Footprint.fits``, needs floors, ``network_min_fraction``)
is untouched — calibration rescales cost, it does not change what fits.
Plan memoization keys on ``CalibrationTable.key()`` (schema version +
fits fingerprint), so a refitted table invalidates stale plans.

**Lowered rungs are distinct members.**  A site the precision ladder
lowered executes a different code path (``repro_torch.quant.ops``
wrappers), so its samples and fits key as ``"<ip.name>@int<bits>"``
(``member_key``) — per-(family, member) granularity where "member" is
the executed variant.

**Same samples, same table, in both packages.**  Fits run on numpy's
``lstsq`` in float64 and the JSON is written with sorted keys and floats
by repr, so the same samples give bitwise the same fits, ``fingerprint()``
and plan-cache keys as the reference; a table either package writes
loads in the other with an equal ``key()``.

Persistence: ``save``/``load`` round-trip the table as versioned JSON
bit-exactly; ``load`` rejects unknown schema versions.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ip import dtype_name, is_integer_dtype
from repro_torch.core.resources import CLOCK_HZ, Footprint
from repro_torch.obs.trace import NOOP_SPAN, TRACER

# v2 adds the collective axis (``comm_cycles`` on samples,
# ``us_per_comm_cycle`` on fits) for mesh-sharded sites; v1 tables load
# with the new axis defaulted to zero — their predictions are unchanged.
CALIBRATION_SCHEMA_VERSION = 2
_ACCEPTED_SCHEMA_VERSIONS = (1, 2)

# Defaults for the measurement harness: one discarded warmup call, then
# the median of this many timed calls.
MEASURE_REPEAT = 3


def _block(result) -> None:
    """Wait for ``result``: synchronize the card when any tensor in it
    lives there (CPU results are ready when the call returns)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _block(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _block(v)


def timeit_us(fn, *args, warmup: int = 1, repeat: int = MEASURE_REPEAT,
              **kwargs) -> float:
    """us/call: ``warmup`` discarded calls, then the median of ``repeat``
    timed calls — the shared wall-clock substrate of the autotuner's
    measure mode and calibration sampling.

    The time is the host clock around one *blocking* call: the call,
    then ``torch.cuda.synchronize()`` when its result lies on the card.
    That is the reference's contract (``block_until_ready`` after each
    call), and it is what the fits must price: on a card the host's time
    to issue a site is part of what serving it costs, so device-only
    event times would leave most of a served site's cost out.  Nothing
    here moves work to another device: ``fn`` runs where its operands
    are."""
    for _ in range(warmup):
        _block(fn(*args, **kwargs))
    times = []
    for _ in range(max(1, repeat)):
        t0 = time.perf_counter()
        _block(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def member_key(ip_name: str, bits: Optional[int] = None,
               native_bits: int = 32) -> str:
    """The calibration key for one executed variant of a member: the
    qualified IP name, suffixed with ``@int<bits>`` when the precision
    ladder lowered the site below its native width (the quantized
    execution path is a different code path, hence a different fit)."""
    if bits is not None and bits < native_bits:
        return f"{ip_name}@int{bits}"
    return ip_name


@dataclasses.dataclass(frozen=True)
class CalibrationSample:
    """One measured observation: what a member's launch actually cost at
    one footprint point.  ``compute_cycles``/``hbm_bytes`` are the
    analytical axes the affine fit regresses over."""

    family: str
    member: str
    compute_cycles: float
    hbm_bytes: float
    measured_us: float
    comm_cycles: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationSample":
        return cls(family=d["family"], member=d["member"],
                   compute_cycles=float(d["compute_cycles"]),
                   hbm_bytes=float(d["hbm_bytes"]),
                   measured_us=float(d["measured_us"]),
                   comm_cycles=float(d.get("comm_cycles", 0.0)))


@dataclasses.dataclass(frozen=True)
class AffineFit:
    """``predicted_us = us_per_compute_cycle * compute
    + us_per_hbm_byte * hbm_bytes + us_per_comm_cycle * comm
    + overhead_us`` with every coefficient >= 0 (enforced at fit time),
    so predictions are nonnegative and nondecreasing in every axis.
    ``us_per_comm_cycle`` calibrates collective traffic exactly like
    compute and HBM; schema-v1 tables carry an implicit zero."""

    us_per_compute_cycle: float
    us_per_hbm_byte: float
    overhead_us: float
    n_samples: int
    us_per_comm_cycle: float = 0.0

    def predict_us(self, compute_cycles: float, hbm_bytes: float,
                   comm_cycles: float = 0.0) -> float:
        return (self.us_per_compute_cycle * compute_cycles
                + self.us_per_hbm_byte * hbm_bytes
                + self.us_per_comm_cycle * comm_cycles + self.overhead_us)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AffineFit":
        return cls(us_per_compute_cycle=float(d["us_per_compute_cycle"]),
                   us_per_hbm_byte=float(d["us_per_hbm_byte"]),
                   overhead_us=float(d["overhead_us"]),
                   n_samples=int(d["n_samples"]),
                   us_per_comm_cycle=float(d.get("us_per_comm_cycle", 0.0)))


def _affine_fit(
        rows: Sequence[Tuple[float, float, float, float]]) -> AffineFit:
    """Least-squares affine fit of (compute, hbm, comm) -> us with
    coefficients clamped nonnegative: solve, drop the most negative
    coefficient's column, re-solve — a small active-set NNLS sufficient
    for 4 columns.  (An all-zero comm column — every single-device
    sample — is rank-deficient; lstsq's min-norm solution leaves its
    coefficient at zero, the correct no-information answer.)  numpy in
    float64, as the reference, so both packages fit bitwise alike.
    """
    X = np.array([[c, h, m, 1.0] for c, h, m, _ in rows], dtype=np.float64)
    y = np.array([us for _, _, _, us in rows], dtype=np.float64)
    active = [0, 1, 2, 3]
    coef = np.zeros(4)
    while active:
        sol, *_ = np.linalg.lstsq(X[:, active], y, rcond=None)
        if all(s >= 0.0 for s in sol):
            for col, s in zip(active, sol):
                coef[col] = float(s)
            break
        worst = min(range(len(sol)), key=lambda i: sol[i])
        active.pop(worst)
    return AffineFit(us_per_compute_cycle=float(coef[0]),
                     us_per_hbm_byte=float(coef[1]),
                     us_per_comm_cycle=float(coef[2]),
                     overhead_us=float(coef[3]), n_samples=len(rows))


class CalibrationTable:
    """Samples + fits + persistence; see module docstring.

    Mutable by design — a serving process records samples as it runs and
    ``fit()`` refreshes the model.  Identity for cache keying is
    ``key()``: predictions only change when the *fits* change, so
    recording samples alone leaves memoized plans valid, while ``fit()``
    moves the fingerprint and invalidates them.
    """

    def __init__(self, samples: Iterable[CalibrationSample] = (),
                 fits: Optional[Dict[str, AffineFit]] = None,
                 global_fit: Optional[AffineFit] = None,
                 min_samples: int = 3):
        self.samples: List[CalibrationSample] = list(samples)
        self.fits: Dict[str, AffineFit] = dict(fits or {})
        self.global_fit: Optional[AffineFit] = global_fit
        self.min_samples = int(min_samples)
        self._fingerprint: Optional[str] = None

    # -- sampling -----------------------------------------------------------
    def record(self, member: str, footprint: Footprint, measured_us: float,
               *, family: Optional[str] = None,
               bits: Optional[int] = None, native_bits: int = 32) -> None:
        """Append one observation.  ``member`` is the qualified IP name
        (``"conv2d.ip1_vpu"``); pass ``bits``/``native_bits`` to key a
        ladder-lowered execution under its ``@int<bits>`` variant.  The
        fit axes come from the footprint's analytical split
        (``Footprint.compute_cycles`` / ``hbm_bytes``)."""
        key = member_key(member, bits, native_bits)
        self.samples.append(CalibrationSample(
            family=family or member.partition(".")[0],
            member=key,
            compute_cycles=float(footprint.compute_cycles),
            hbm_bytes=float(footprint.hbm_bytes),
            measured_us=float(measured_us),
            comm_cycles=float(footprint.comm_cycles)))

    def sample_count(self, member: Optional[str] = None) -> int:
        if member is None:
            return len(self.samples)
        return sum(1 for s in self.samples if s.member == member)

    # -- fitting ------------------------------------------------------------
    def fit(self, min_samples: Optional[int] = None) -> "CalibrationTable":
        """(Re)fit per-member models; members with fewer than
        ``min_samples`` observations get no dedicated fit and fall back
        to the global fit over every sample.  Returns self (chainable).
        """
        if min_samples is not None:
            self.min_samples = int(min_samples)
        with (TRACER.span("calibration.fit", "calibrate",
                          {"samples": len(self.samples)})
              if TRACER.enabled else NOOP_SPAN):
            by_member: Dict[str, List[Tuple[float, float, float,
                                            float]]] = {}
            for s in self.samples:
                by_member.setdefault(s.member, []).append(
                    (s.compute_cycles, s.hbm_bytes, s.comm_cycles,
                     s.measured_us))
            self.fits = {m: _affine_fit(rows)
                         for m, rows in by_member.items()
                         if len(rows) >= self.min_samples}
            all_rows = [(s.compute_cycles, s.hbm_bytes, s.comm_cycles,
                         s.measured_us)
                        for s in self.samples]
            self.global_fit = _affine_fit(all_rows) if all_rows else None
            self._fingerprint = None
        return self

    # -- prediction ---------------------------------------------------------
    def fit_for(self, member: str) -> Optional[AffineFit]:
        """The fit predictions for ``member`` use: its dedicated fit, or
        the global fallback, or None when the table has never been fit
        on any sample (identity calibration)."""
        return self.fits.get(member, self.global_fit)

    def predict_us(self, member: str, compute_cycles: float,
                   hbm_bytes: float,
                   comm_cycles: float = 0.0) -> Optional[float]:
        f = self.fit_for(member)
        if f is None:
            return None
        return max(f.predict_us(compute_cycles, hbm_bytes, comm_cycles),
                   0.0)

    def calibrated_cycles(self, footprint: Footprint, member: str) -> float:
        """The footprint's cost under this table, in cycle units: the
        predicted wall-clock scaled by ``CLOCK_HZ``, so calibrated
        costs rank against each other exactly as the measurements do.
        Falls back to ``est_cycles`` when no fit covers the member.

        A member with no fitted comm coefficient (all its samples were
        single-device) still pays its ``comm_cycles`` at the analytical
        rate — collective traffic never becomes free just because it
        was not measured yet."""
        us = self.predict_us(member, footprint.compute_cycles,
                             footprint.hbm_bytes, footprint.comm_cycles)
        if us is None:
            return footprint.est_cycles
        cycles = us * 1e-6 * CLOCK_HZ
        f = self.fit_for(member)
        if footprint.comm_cycles and f is not None \
                and f.us_per_comm_cycle == 0.0:
            cycles += footprint.comm_cycles
        return cycles

    # -- identity -----------------------------------------------------------
    def fingerprint(self) -> str:
        """Digest of the *fits* (not the raw samples): two tables that
        predict identically share a fingerprint, and refitting moves it
        — the planner's cache-keying rule."""
        if self._fingerprint is None:
            payload = json.dumps(
                {"fits": {m: f.to_dict() for m, f in sorted(self.fits.items())},
                 "global_fit": (self.global_fit.to_dict()
                                if self.global_fit else None)},
                sort_keys=True)
            self._fingerprint = hashlib.sha256(
                payload.encode()).hexdigest()[:16]
        return self._fingerprint

    def key(self) -> tuple:
        """Hashable identity for plan memoization: (schema version,
        fits fingerprint)."""
        return (CALIBRATION_SCHEMA_VERSION, self.fingerprint())

    # -- persistence --------------------------------------------------------
    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps({
            "version": CALIBRATION_SCHEMA_VERSION,
            "min_samples": self.min_samples,
            "samples": [s.to_dict() for s in self.samples],
            "fits": {m: f.to_dict() for m, f in sorted(self.fits.items())},
            "global_fit": (self.global_fit.to_dict()
                           if self.global_fit else None),
        }, indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CalibrationTable":
        d = json.loads(text)
        version = d.get("version")
        if version not in _ACCEPTED_SCHEMA_VERSIONS:
            raise ValueError(
                f"calibration table schema version {version!r} is not "
                f"supported (accepted {_ACCEPTED_SCHEMA_VERSIONS}); "
                "re-collect samples and refit")
        return cls(
            samples=[CalibrationSample.from_dict(s) for s in d["samples"]],
            fits={m: AffineFit.from_dict(f) for m, f in d["fits"].items()},
            global_fit=(AffineFit.from_dict(d["global_fit"])
                        if d.get("global_fit") else None),
            min_samples=int(d.get("min_samples", 3)))

    def save(self, path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "CalibrationTable":
        return cls.from_json(Path(path).read_text())

    def __eq__(self, other) -> bool:
        return (isinstance(other, CalibrationTable)
                and self.samples == other.samples
                and self.fits == other.fits
                and self.global_fit == other.global_fit
                and self.min_samples == other.min_samples)


def calibration_key(calibration: Optional[CalibrationTable]) -> Optional[tuple]:
    """The cache-key component for an optional table (None stays None —
    the uncalibrated planner's keys are unchanged)."""
    return None if calibration is None else calibration.key()


# ---------------------------------------------------------------------------
# Measurement: execute exactly what a plan chose, one site at a time.
# ---------------------------------------------------------------------------
def _synthetic(shape, dtype, rng, device):
    """An input tensor of the site's declared shape/dtype (seeded) on
    ``device``.  The values are the reference's: integers from the same
    ``rng.integers`` call clamped to [-128, 127], floats from the same
    ``rng.normal`` call in float32, then cast (bf16 included: no numpy
    bf16 dtype is needed)."""
    name = dtype_name(dtype)
    if is_integer_dtype(name):
        info = np.iinfo(np.dtype(name))
        lo, hi = max(info.min, -128), min(info.max, 127)
        arr = rng.integers(lo, hi + 1, size=shape, dtype=np.dtype(name))
        return torch.from_numpy(arr).to(device)
    arr = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(arr).to(device=device,
                                    dtype=getattr(torch, name))


def _site_runner(site, *, device=None, seed: int = 0):
    """A zero-arg callable executing one planned site's member on
    synthetic operands on ``device`` (``None`` = ``cuda``; no card
    raises ``CudaUnavailableError``) — the same dispatch
    ``models/blocks.py`` performs, lowered rungs (quantized wrappers)
    included."""
    from repro_torch.models.frontends import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    spec, ip, bits = site.spec, site.ip, site.precision_bits
    lowered = site.lowered
    fam = spec.family
    if fam == "conv2d":
        x = _synthetic(spec.shapes[0], spec.dtype, rng, dev)
        w = _synthetic(spec.shapes[1], spec.dtype, rng, dev)
        if lowered:
            from repro_torch.quant.ops import quantized_conv2d
            return lambda: quantized_conv2d(x, w, bits=bits, ip=ip.name)
        if ip.outputs_per_pass >= 2:
            from repro_torch.kernels.conv2d.ops import conv2d_dual
            x2 = _synthetic(spec.shapes[0], spec.dtype, rng, dev)
            return lambda: conv2d_dual(x, x2, w, ip=ip.name)
        from repro_torch.kernels.conv2d.ops import conv2d
        return lambda: conv2d(x, w, ip=ip.name)
    if fam == "pool2d":
        x = _synthetic(spec.shapes[0], spec.dtype, rng, dev)
        kw = dict(window=spec.knob("window", (2, 2)),
                  stride=spec.knob("stride"),
                  mode=spec.knob("mode", "max"))
        if lowered:
            from repro_torch.quant.ops import quantized_pool2d
            return lambda: quantized_pool2d(x, bits=bits, ip=ip.name, **kw)
        from repro_torch.kernels.pool2d.ops import pool2d
        return lambda: pool2d(x, ip=ip.name, **kw)
    if fam == "activation":
        x = _synthetic(spec.shapes[0], spec.dtype, rng, dev)
        kind = spec.knob("kind", "relu")
        if lowered:
            from repro_torch.quant.ops import quantized_activation
            return lambda: quantized_activation(x, kind=kind, bits=bits,
                                                ip=ip.name)
        from repro_torch.kernels.activation.ops import activation
        return lambda: activation(x, kind=kind, ip=ip.name)
    if fam == "cnn_fused":
        x = _synthetic(spec.shapes[0], spec.dtype, rng, dev)
        w = _synthetic(spec.shapes[1], spec.dtype, rng, dev)
        kw = dict(pool_window=spec.knob("window", (2, 2)),
                  pool_stride=spec.knob("stride"),
                  pool_mode=spec.knob("mode", "max"),
                  activation=spec.knob("kind", "relu"))
        if lowered:
            from repro_torch.quant.ops import quantized_fused_cnn_block
            return lambda: quantized_fused_cnn_block(
                x, w, bits=bits, ip=ip.name, **kw)
        from repro_torch.kernels.fused.ops import fused_cnn_block
        return lambda: fused_cnn_block(x, w, ip=ip.name, **kw)
    if fam == "matmul":
        a = _synthetic(spec.shapes[0], spec.dtype, rng, dev)
        b = _synthetic(spec.shapes[1], spec.dtype, rng, dev)
        if lowered:
            from repro_torch.quant.ops import quantized_matmul
            return lambda: quantized_matmul(a, b, bits=bits, ip=ip.name)
        from repro_torch.kernels.matmul.ops import matmul
        return lambda: matmul(a, b, ip=ip.name)
    raise ValueError(f"no calibration runner for family {fam!r} "
                     f"(site {spec.name!r})")


def measure_planned_site(site, *, device=None,
                         warmup: int = 1, repeat: int = MEASURE_REPEAT,
                         seed: int = 0) -> float:
    """Measured us/call for one ``PlannedSite``: the planned member runs
    standalone on synthetic operands of the site's declared shapes on
    ``device`` (``None`` = ``cuda``), via the exact dispatch the
    execution layer uses (quantized wrappers for lowered rungs)."""
    with (TRACER.span("calibration.measure", "calibrate",
                      {"site": site.spec.name, "member": site.ip.name,
                       "bits": site.precision_bits})
          if TRACER.enabled else NOOP_SPAN):
        return timeit_us(
            _site_runner(site, device=device, seed=seed),
            warmup=warmup, repeat=repeat)


def collect_plan_samples(plans, table: Optional[CalibrationTable] = None, *,
                         device=None, warmup: int = 1,
                         repeat: int = MEASURE_REPEAT,
                         seed: int = 0) -> CalibrationTable:
    """Measure every distinct (member, width, site) a set of plans chose
    and record the samples — the warmup pass of a calibration loop.

    Distinctness is per executed variant: the same member at two layer
    shapes yields two samples (different footprint points — exactly what
    the affine fit needs), while re-planning the same site under another
    budget does not re-measure.  ``None`` entries (infeasible plans) are
    skipped.  Returns the (new or given) table; call ``fit()`` on it
    when sampling is done.

    Sharded sites are skipped: their footprint is the per-device shard
    plus collective cycles, which a standalone single-process runner
    cannot reproduce.
    """
    table = table if table is not None else CalibrationTable()
    seen = set()
    for plan in plans:
        if plan is None:
            continue
        for site in plan.sites:
            if getattr(site, "shard_degree", 1) > 1:
                continue
            dkey = (site.ip.name, site.precision_bits, site.spec)
            if dkey in seen:
                continue
            seen.add(dkey)
            us = measure_planned_site(site, device=device,
                                      warmup=warmup, repeat=repeat,
                                      seed=seed)
            table.record(site.ip.name, site.footprint, us,
                         family=site.spec.family,
                         bits=site.precision_bits,
                         native_bits=site.spec.native_bits)
    return table
