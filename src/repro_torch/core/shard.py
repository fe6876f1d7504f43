"""Mesh sharding rules — how one plan spreads across devices.

The paper sizes a network against ONE fabric.  The scale-out story
(multi-FPGA boards, several cards joined by NVLink) offers several
identical devices joined by links of finite bandwidth, and the honest
way to use them is the same resource-driven bargain the paper strikes on
a single chip: a split shrinks every per-device footprint column, but
the collective traffic it induces is a *cost* — priced in cycles at the
mesh's link bandwidth (``MeshSpec``), never waved away.

This module owns the three ingredients ``plan_network(mesh=...)`` needs:

* **Shard rules** (``shard_site_spec``): for each plannable family, the
  per-device ``SiteSpec`` a split produces — batch-parallel (every
  family that has a batch dim) or channel-parallel (conv splits its
  input channels and psums partial outputs; pool/activation split their
  channel dim communication-free).  ``None`` means "this site does not
  shard this way" (non-divisible dims, dual-stream convs, fused blocks
  on the channel axis — pooling partial sums is wrong math).
* **Layout algebra** (``required_input_layout`` / ``output_layout`` /
  ``boundary_comm_cycles``): what layout a sharded site consumes and
  produces, and what an adjacent pair of sites pays when their layouts
  disagree (an all-gather of the producer's output; slicing replicated
  data is free).
* **The decision pass** (``plan_shard_decisions``): a shortest-path DP
  over the site chain.  Per site the options are degree=1 (replicated),
  a batch split, and a channel split — each priced as its selected
  member's per-device cost plus its collective cycles — and the DP
  threads layout transitions so a mixed chain pays its boundary
  all-gathers where they occur.  The network's input arrives replicated
  and its output must leave replicated (egress gather charged to the
  last site).  A site infeasible at degree=1 but feasible sharded is
  *rescued* by the split — resource-driven adaptation past one device.

Everything here is pure Python on specs and budgets (the reference's
``repro/core/shard.py``, decision for decision: plans stay byte-equal);
execution of a sharded plan lives in ``distributed/shard_exec.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from repro_torch.core.ip import SiteSpec, dtype_itemsize
from repro_torch.core.resources import MeshSpec, ResourceBudget
from repro_torch.obs.trace import NOOP_SPAN, TRACER

# A tensor layout as the planner sees it: ("full", 1) replicated on every
# device, ("batch", d) split on the leading dim, ("chan", d) split on the
# trailing (channel) dim.
FULL = ("full", 1)

AXES = ("batch", "chan")


def degree_ladder(degree: int, *,
                  survivors: Optional[int] = None) -> Tuple[int, ...]:
    """The shard-degree degradation ladder of a plan serving at
    ``degree``: every divisor of ``degree``, descending.

    Divisors are the rungs because any batch that tiled evenly at
    ``degree`` still tiles at each of them — descending the ladder
    changes *parallelism*, never feasibility of the shapes already in
    flight.  ``survivors=`` caps the ladder at the devices actually
    left, so ``degree_ladder(d, survivors=s)[0]`` is the widest degree
    a degraded grant of ``s`` devices can still serve.  This is the
    rung order the runtime's device-loss path walks — the degree ladder
    descends *before* the precision ladder does (the shrunk sub-mesh
    still plans each device against the full per-device budget)."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    rungs = tuple(k for k in range(degree, 0, -1) if degree % k == 0)
    if survivors is not None:
        if survivors < 1:
            raise ValueError("survivors must be >= 1")
        rungs = tuple(k for k in rungs if k <= survivors)
    return rungs


@dataclasses.dataclass(frozen=True)
class SiteSharding:
    """One site's resolved sharding: the axis and degree the DP chose,
    the per-device spec the planner prices under the full per-device
    budget (== the global spec when degree is 1), and the collective
    cycles charged to this site — its own psum/halo traffic plus the
    ingress boundary gather its layout transition costs (the last site
    also carries the egress gather back to replicated)."""

    axis: str                 # "none" | "batch" | "chan"
    degree: int
    spec: SiteSpec            # the spec selection/partitioning runs on
    comm_cycles: float = 0.0

    @property
    def sharded(self) -> bool:
        return self.degree > 1


# ---------------------------------------------------------------------------
# Shapes — the global output of each plannable family (what crosses a
# site boundary, and what a channel-split conv psums).
# ---------------------------------------------------------------------------
def site_output_shape(spec: SiteSpec) -> Tuple[int, ...]:
    """The (global) output shape of one site, from its spec alone."""
    if spec.family == "conv2d":
        (n, h, w, _), (kh, kw, _, cout) = spec.shapes
        return (n, h - kh + 1, w - kw + 1, cout)
    if spec.family == "pool2d":
        from repro_torch.kernels.pool2d.ref import (check_pool_geometry,
                                              pool2d_out_shape)
        (xs,) = spec.shapes
        window, stride = check_pool_geometry(
            xs, spec.knob("window", (2, 2)), spec.knob("stride"))
        return pool2d_out_shape(xs, window, stride)
    if spec.family == "activation":
        return tuple(spec.shapes[0])
    if spec.family == "cnn_fused":
        from repro_torch.kernels.pool2d.ref import (check_pool_geometry,
                                              pool2d_out_shape)
        (n, h, w, _), (kh, kw, _, cout) = spec.shapes
        conv_out = (n, h - kh + 1, w - kw + 1, cout)
        window, stride = check_pool_geometry(
            conv_out, spec.knob("window", (2, 2)), spec.knob("stride"))
        return pool2d_out_shape(conv_out, window, stride)
    if spec.family == "matmul":
        a_shape, b_shape = spec.shapes
        return tuple(a_shape[:-1]) + (b_shape[-1],)
    raise ValueError(f"family {spec.family!r} has no output-shape rule; "
                     "it cannot participate in a sharded chain")


def site_output_bytes(spec: SiteSpec) -> int:
    """Bytes of the site's global output at its native dtype — the
    tensor a boundary all-gather or a channel-split psum moves."""
    shape = site_output_shape(spec)
    return int(math.prod(shape)) * dtype_itemsize(spec.dtype)


def _split_dim(shape: Sequence[int], dim: int, degree: int):
    """``shape`` with ``shape[dim] // degree``, or None if not divisible
    into non-empty blocks."""
    shape = tuple(int(d) for d in shape)
    if degree <= 1:
        return shape
    if shape[dim] % degree != 0 or shape[dim] < degree:
        return None
    out = list(shape)
    out[dim] = shape[dim] // degree
    return tuple(out)


# ---------------------------------------------------------------------------
# Shard rules — the per-device spec each (family, axis) split produces.
# ---------------------------------------------------------------------------
def shard_site_spec(spec: SiteSpec, axis: str,
                    degree: int) -> Optional[SiteSpec]:
    """The per-device ``SiteSpec`` of ``spec`` split ``degree`` ways on
    ``axis``, or ``None`` when the site does not shard that way.

    The name is kept (sharded plans map sites back to their global specs
    positionally; execution looks sites up by name either way).  Rules:

    * ``batch``: every conv/pool/act/fused/matmul site with a divisible
      leading dim — communication-free along the chain (each device owns
      a batch slab end to end).
    * ``chan``: conv splits its *input* channels — each device computes
      a partial sum over the full output, made whole by an all-reduce
      (priced by the caller via ``site_comm_cycles``).  Pool and
      activation split their channel dim with no communication at all.
      Dual-stream convs and fused conv->pool->act blocks refuse: pooling
      or activating a partial sum is not the math the oracle defines.
    """
    if degree <= 1:
        return spec
    if axis not in AXES:
        raise ValueError(f"unknown shard axis {axis!r}; have {AXES}")
    fam = spec.family
    if fam == "conv2d":
        x_shape, w_shape = spec.shapes
        if axis == "batch":
            xs = _split_dim(x_shape, 0, degree)
            if xs is None:
                return None
            return dataclasses.replace(spec, shapes=(xs, tuple(w_shape)))
        # channel: split cin on both operands; partial-sum semantics
        # don't compose with the dual-stream members' packing.
        if spec.knob("dual", False):
            return None
        xs = _split_dim(x_shape, 3, degree)
        ws = _split_dim(w_shape, 2, degree)
        if xs is None or ws is None:
            return None
        return dataclasses.replace(spec, shapes=(xs, ws))
    if fam in ("pool2d", "activation"):
        (x_shape,) = spec.shapes
        dim = 0 if axis == "batch" else len(x_shape) - 1
        xs = _split_dim(x_shape, dim, degree)
        if xs is None:
            return None
        return dataclasses.replace(spec, shapes=(xs,))
    if fam == "cnn_fused":
        if axis != "batch":
            return None     # pool/act of a partial sum is wrong math
        x_shape, w_shape = spec.shapes
        xs = _split_dim(x_shape, 0, degree)
        if xs is None:
            return None
        return dataclasses.replace(spec, shapes=(xs, tuple(w_shape)))
    if fam == "matmul":
        if axis != "batch":
            return None
        a_shape, b_shape = spec.shapes
        a = _split_dim(a_shape, 0, degree)
        if a is None:
            return None
        return dataclasses.replace(spec, shapes=(a, tuple(b_shape)))
    return None             # attention / ssm_scan: no shard rule yet


def required_input_layout(spec: SiteSpec, axis: str,
                          degree: int) -> Tuple[str, int]:
    """The layout a site sharded (axis, degree) consumes."""
    if degree <= 1:
        return FULL
    return (axis, degree)


def output_layout(spec: SiteSpec, axis: str,
                  degree: int) -> Tuple[str, int]:
    """The layout a site sharded (axis, degree) produces.  A channel
    -split conv emerges *replicated*: its all-reduce (priced in
    ``site_comm_cycles``) leaves the full output on every device."""
    if degree <= 1:
        return FULL
    if axis == "chan" and spec.family == "conv2d":
        return FULL
    return (axis, degree)


def site_comm_cycles(spec: SiteSpec, axis: str, degree: int,
                     mesh: MeshSpec) -> float:
    """Collective cycles the split itself induces (boundary transitions
    are priced separately): the channel-split conv's all-reduce of its
    full output; batch and channel splits of pool/act are free."""
    if degree <= 1:
        return 0.0
    if axis == "chan" and spec.family == "conv2d":
        return mesh.all_reduce_cycles(site_output_bytes(spec))
    return 0.0


def boundary_comm_cycles(mesh: MeshSpec, produced: Tuple[str, int],
                         needed: Tuple[str, int], n_bytes: int) -> float:
    """Cycles to re-lay a tensor of global size ``n_bytes`` from the
    layout its producer left it in to the layout its consumer needs.
    Slicing replicated data is free; any sharded-to-different move is
    priced as the all-gather back to replicated (the slice after it is
    free again) — the conservative single-hop model."""
    if produced == needed or produced == FULL:
        return 0.0
    return mesh.all_gather_cycles(n_bytes)


# ---------------------------------------------------------------------------
# The decision pass.
# ---------------------------------------------------------------------------
def plan_shard_decisions(specs: Sequence[SiteSpec], budget: ResourceBudget,
                         mesh: MeshSpec, select=None,
                         calibration=None,
                         events=None) -> Tuple[SiteSharding, ...]:
    """Choose, per site, between replicating and sharding — the mesh
    pricing pass.

    A shortest-path DP over the chain: the state after site *i* is the
    layout its chosen option leaves the activation in; an option's cost
    is its selected member's per-device cycles (each device sees the
    FULL per-device ``budget`` — that is what an N-device grant means)
    plus its own collective traffic plus the boundary gather from the
    incoming state's layout.  The input arrives replicated; the output
    is gathered back to replicated (egress charged to the last site).

    Degrees considered are 1 and ``mesh.devices`` — the all-or-nothing
    split matches the arbiter's slice grants; partial degrees would
    strand devices.  A site with no feasible option at all raises the
    degree=1 selection error (sharding *widens* feasibility, it never
    narrows it).  Returns one ``SiteSharding`` per site, comm already
    apportioned; with ``mesh.devices == 1`` every decision is the
    trivial replicated one.

    ``events`` (a list, when given) receives one plan-audit line per
    non-trivial decision: a ``shard:`` line for every split taken and a
    ``shard refusal:`` line — with the per-option prices — for every
    site that had a split available and stayed replicated.
    """
    specs = tuple(specs)
    with (TRACER.span("plan_shard_decisions", "shard",
                      {"sites": len(specs), "devices": mesh.devices})
          if TRACER.enabled else NOOP_SPAN):
        return _plan_shard_decisions(specs, budget, mesh, select,
                                     calibration, events)


def _plan_shard_decisions(specs, budget, mesh, select, calibration,
                          events):
    if select is None:
        from repro_torch.core.plan import _select_site

        def select(s):
            return _select_site(s, budget, calibration)

    if mesh.devices <= 1:
        return tuple(SiteSharding("none", 1, s) for s in specs)

    from repro_torch.core.plan import _select_site, _site_cost
    d = mesh.devices

    def _cost_of(sspec, use_memo):
        sel = select(sspec) if use_memo else _select_site(
            sspec, budget, calibration)
        ip, fp, bits = sel
        return _site_cost(ip, fp, bits, sspec, calibration)

    # Per site: list of (axis, degree, sspec, need_layout, out_layout,
    # site_comm, compute_cost).
    options = []
    for spec in specs:
        opts = []
        base_err = None
        try:
            # degree=1 goes through the caller's memo — plan_network
            # prices the same full-budget selection for its baseline.
            opts.append(("none", 1, spec, FULL, FULL, 0.0,
                         _cost_of(spec, use_memo=True)))
        except ValueError as e:
            base_err = e
        for axis in AXES:
            sspec = shard_site_spec(spec, axis, d)
            if sspec is None:
                continue
            try:
                cost = _cost_of(sspec, use_memo=False)
            except ValueError:
                continue        # this split doesn't fit either; skip it
            opts.append((axis, d, sspec,
                         required_input_layout(spec, axis, d),
                         output_layout(spec, axis, d),
                         site_comm_cycles(spec, axis, d, mesh), cost))
        if not opts:
            raise base_err      # not even the splits rescue this site
        options.append(opts)

    # DP: layout -> (total cost, decisions so far).
    states = {FULL: (0.0, ())}
    for spec, opts in zip(specs, options):
        new_states = {}
        for in_layout, (cost, decs) in states.items():
            for axis, deg, sspec, need, out, scomm, ccost in opts:
                # Boundary bytes: the producer's output == this site's
                # input; the first site's input arrives replicated so
                # its transition is free by the FULL rule.
                prev_bytes = (site_output_bytes(specs[len(decs) - 1])
                              if decs else 0)
                bcomm = boundary_comm_cycles(mesh, in_layout, need,
                                             prev_bytes)
                comm = scomm + bcomm
                total = cost + ccost + comm
                dec = SiteSharding(axis, deg, sspec, comm)
                cur = new_states.get(out)
                if cur is None or total < cur[0]:
                    new_states[out] = (total, decs + (dec,))
        states = new_states

    # Egress: gather the network output back to replicated.
    best = None
    last_bytes = site_output_bytes(specs[-1])
    for out_layout, (cost, decs) in states.items():
        egress = boundary_comm_cycles(mesh, out_layout, FULL, last_bytes)
        total = cost + egress
        if best is None or total < best[0]:
            last = decs[-1]
            decs = decs[:-1] + (dataclasses.replace(
                last, comm_cycles=last.comm_cycles + egress),)
            best = (total, decs)
    if events is not None:
        for spec, opts, dec in zip(specs, options, best[1]):
            if dec.degree > 1:
                events.append(
                    f"shard: {spec.name} split {dec.axis}x{dec.degree} "
                    f"(comm {dec.comm_cycles:.3e} cycles)")
            elif len(opts) > 1:
                # A split was on the table and the DP kept the site
                # replicated — the refusal the audit must explain.
                priced = "; ".join(
                    f"{axis}x{deg} compute {ccost:.3e} + comm "
                    f"{scomm:.3e}"
                    for axis, deg, _, _, _, scomm, ccost in opts
                    if deg > 1)
                repl = next(ccost for axis, deg, *_, ccost in opts
                            if deg == 1)
                events.append(
                    f"shard refusal: {spec.name} stays replicated "
                    f"(compute {repl:.3e}) over {priced}")
    return best[1]


def force_shard_decisions(specs: Sequence[SiteSpec], mesh: MeshSpec,
                          axis: str = "batch") -> Tuple[SiteSharding, ...]:
    """Shard EVERY site on ``axis`` at the mesh's full degree — the
    measurement counterfactual (force the split the model rejected,
    measure it losing).  Raises when any site has no rule for
    ``axis`` at this degree; comm is priced exactly as the DP would."""
    specs = tuple(specs)
    d = mesh.devices
    if d <= 1:
        return tuple(SiteSharding("none", 1, s) for s in specs)
    out = []
    in_layout = FULL
    for i, spec in enumerate(specs):
        sspec = shard_site_spec(spec, axis, d)
        if sspec is None:
            raise ValueError(
                f"site {spec.name!r} ({spec.family}) cannot shard on "
                f"{axis!r} x{d}")
        need = required_input_layout(spec, axis, d)
        prev_bytes = site_output_bytes(specs[i - 1]) if i else 0
        comm = (site_comm_cycles(spec, axis, d, mesh)
                + boundary_comm_cycles(mesh, in_layout, need, prev_bytes))
        in_layout = output_layout(spec, axis, d)
        out.append(SiteSharding(axis, d, sspec, comm))
    egress = boundary_comm_cycles(mesh, in_layout, FULL,
                                  site_output_bytes(specs[-1]))
    last = out[-1]
    out[-1] = dataclasses.replace(last,
                                  comm_cycles=last.comm_cycles + egress)
    return tuple(out)
