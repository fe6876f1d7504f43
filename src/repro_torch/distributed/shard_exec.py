"""Execute a mesh-sharded NetworkPlan under a single controller.

Replaces ``repro/distributed/shard_exec.py``.  ``core/shard.py`` decides
*whether* each site splits; this module makes the split real.  The
reference runs one ``shard_map`` over the site chain; here one Python
process owns every device of the mesh, as ``shard_map`` does, and runs
the same per-device loop for each rank on that rank's block, on that
rank's device:

* slice its block of the activation when the incoming layout is
  replicated and the site wants a batch/channel shard (free — the data
  is already everywhere),
* all-gather when a sharded layout must change (the priced boundary
  transitions; ``distributed/collectives.py``),
* run the site's planned member on its block through the family's ops
  entry — the same CUDA kernel the replicated walk launches, one launch
  a rank (the plan picked the member; sharding must not change the
  math), and
* for a channel-split conv, split the weights' input-channel dim with
  the data and reduce the ranks' partial outputs (``psum``, or the
  reference's ring schedule with ``use_ring=True``).

The network's input arrives replicated and its output returns
replicated, on the input's device, so the caller sees exactly the
replicated path's contract: an f32 batch split is bitwise the replicated
walk, a channel split differs only by float summation order.  Lowered
(quantized) sites are refused — the sharded executor is a
float-precision path.

The mesh's devices: ``devices=`` (one ``torch.device`` a rank, in rank
order; a card may appear more than once, which runs that many logical
devices on it), else ``cuda:0 .. d-1`` for CUDA inputs when ``d`` cards
exist, ``d`` CPU entries for CPU inputs, and otherwise the reference's
``ValueError``: a missing card is never replaced by ``cuda:0``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.plan import NetworkPlan, PlannedSite
from repro_torch.core.shard import FULL, output_layout, required_input_layout
from repro_torch.distributed.collectives import all_gather
from repro_torch.obs.trace import NOOP_SPAN, TRACER
from repro_torch.runtime.faults import INJECTOR

_CHAIN_FAMILIES = ("conv2d", "pool2d", "activation", "cnn_fused")


def _check_chain(plan: NetworkPlan) -> None:
    for s in plan.sites:
        if s.spec.family not in _CHAIN_FAMILIES:
            raise ValueError(
                f"site {s.spec.name!r} ({s.spec.family}) is not part of a "
                f"conv/pool/act chain; sharded execution handles "
                f"{_CHAIN_FAMILIES}")
        if s.lowered:
            raise ValueError(
                f"site {s.spec.name!r} was lowered to int"
                f"{s.precision_bits}; sharded execution is float-only — "
                "plan without a ladder or without a mesh")


def _run_site(site: PlannedSite, x: torch.Tensor,
              w: Optional[torch.Tensor], *,
              reduce_axis: Optional[str] = None,
              use_ring: bool = False) -> torch.Tensor:
    """One site through its planned member's ops entry — shared by the
    replicated and the per-device walks (the per-device walk passes
    ``reduce_axis`` for channel-split convs, whose result is then a
    partial sum)."""
    spec = site.spec
    if spec.family == "conv2d":
        from repro_torch.kernels.conv2d.ops import conv2d
        return conv2d(x, w, ip=site.ip.name, reduce_axis=reduce_axis,
                      reduce="ring" if use_ring else "psum")
    if spec.family == "pool2d":
        from repro_torch.kernels.pool2d.ops import pool2d
        return pool2d(x, window=spec.knob("window", (2, 2)),
                      stride=spec.knob("stride"),
                      mode=spec.knob("mode", "max"), ip=site.ip.name)
    if spec.family == "activation":
        from repro_torch.kernels.activation.ops import activation
        return activation(x, kind=spec.knob("kind", "relu"),
                          ip=site.ip.name)
    # cnn_fused (gated by _check_chain)
    from repro_torch.kernels.fused.ops import fused_cnn_block
    return fused_cnn_block(
        x, w, pool_window=spec.knob("window", (2, 2)),
        pool_stride=spec.knob("stride"), pool_mode=spec.knob("mode", "max"),
        activation=spec.knob("kind", "relu"), ip=site.ip.name)


def apply_plan_replicated(plan: NetworkPlan, x: torch.Tensor,
                          weights: Optional[Dict[str, torch.Tensor]] = None
                          ) -> torch.Tensor:
    """The single-device reference walk: every site's planned member on
    the full tensors, no mesh.  ``weights`` maps conv/fused site name ->
    its weight tensor."""
    _check_chain(plan)
    weights = weights or {}
    cur = x
    for site in plan.sites:
        cur = _run_site(site, cur, weights.get(site.spec.name))
    return cur


def mesh_devices(d: int, like: torch.Tensor,
                 devices: Optional[Sequence] = None) -> List[torch.device]:
    """The ``d`` devices of a mesh, rank order: ``devices`` when given
    (at least ``d`` of them), else one card each for CUDA tensors
    (``cuda:0 .. d-1``) and ``d`` CPU entries for CPU tensors; raises the
    reference's ``ValueError`` when there are too few."""
    if devices is not None:
        devs = [torch.device(v) for v in devices]
    elif like.is_cuda:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device("cpu")] * d
    if len(devs) < d:
        raise ValueError(
            f"plan wants {d} devices but only {len(devs)} are available "
            "(pass devices= to run several logical devices on one card)")
    return devs[:d]


def _block(x: torch.Tensor, dim: int, degree: int,
           index: int) -> torch.Tensor:
    size = x.shape[dim] // degree
    return x.narrow(dim, index * size, size).contiguous()


def _relay(blocks: List[torch.Tensor], have, want) -> List[torch.Tensor]:
    """Move the ranks' blocks from layout ``have`` to ``want``.  Layouts
    are ``core.shard`` tuples; a sharded source is gathered back to
    replicated first (the priced single-hop model), then slicing is
    free."""
    if have == want:
        return blocks
    if have != FULL:
        # tiled all-gather along the shard dim restores the global tensor
        dim = 0 if have[0] == "batch" else blocks[0].dim() - 1
        blocks = all_gather(blocks, dim)
    if want == FULL:
        return blocks
    dim = 0 if want[0] == "batch" else blocks[0].dim() - 1
    return [_block(x, dim, want[1], r) for r, x in enumerate(blocks)]


def apply_plan_sharded(plan: NetworkPlan, x: torch.Tensor,
                       weights: Optional[Dict[str, torch.Tensor]] = None,
                       *, use_ring: bool = False,
                       devices=None) -> torch.Tensor:
    """Execute ``plan`` under its mesh: every rank walks the chain on its
    own device, layouts threaded exactly as the planner priced them.

    ``x`` and every weight enter replicated (a copy on each rank's
    device) and the result leaves replicated on ``x``'s device —
    identical contract to ``apply_plan_replicated``; a plan with no
    sharded sites (or no mesh) simply runs the replicated walk.
    ``use_ring=True`` reduces a channel-split conv's partials through
    the reference's ring schedule instead of ``psum``.
    """
    _check_chain(plan)
    if (plan.mesh is None or plan.mesh.devices <= 1
            or not plan.sharded_sites()):
        return apply_plan_replicated(plan, x, weights)
    from repro_torch.kernels.conv2d.ops import reduce_partials
    weights = weights or {}
    d = plan.mesh.devices
    axis = plan.mesh.axis
    devs = mesh_devices(d, x, devices)
    dplan = plan.device_plan()
    reduce = "ring" if use_ring else "psum"
    with (TRACER.span("shard_exec.apply", "collective",
                      {"devices": d, "axis": axis,
                       "comm_cycles": sum(s.footprint.comm_cycles
                                          for s in plan.sites)})
          if TRACER.enabled else NOOP_SPAN):
        cur = [x.to(dev) for dev in devs]
        have = FULL
        for gsite, dsite in zip(plan.sites, dplan.sites):
            need = required_input_layout(gsite.spec, gsite.shard_axis,
                                         gsite.shard_degree)
            cur = _relay(cur, have, need)
            w = weights.get(gsite.spec.name)
            ws = [None if w is None else w.to(dev) for dev in devs]
            reduce_axis = None
            if (gsite.sharded and gsite.shard_axis == "chan"
                    and gsite.spec.family == "conv2d"):
                # weights split their input-channel dim with the data
                ws = [_block(wr, 2, gsite.shard_degree, r)
                      for r, wr in enumerate(ws)]
                reduce_axis = axis
            run = dsite if gsite.sharded else gsite
            cur = [_run_site(run, xr, wr, reduce_axis=reduce_axis,
                             use_ring=use_ring)
                   for xr, wr in zip(cur, ws)]
            if reduce_axis is not None:
                cur = reduce_partials(cur, reduce)
            have = output_layout(gsite.spec, gsite.shard_axis,
                                 gsite.shard_degree)
        y = _relay(cur, have, FULL)[0].to(x.device)
    if INJECTOR.enabled:
        # injection seam "collective": corruption lands on the gathered
        # result, after the collectives
        y = INJECTOR.perturb_output("collective", y)
    return y
