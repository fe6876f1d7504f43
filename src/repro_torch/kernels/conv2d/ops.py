"""Public wrappers for the conv2d IP family.

``conv2d`` / ``conv2d_dual`` take an explicit ``ip=`` name or a
``budget=`` (ResourceBudget) and defer to the resource-driven selector —
the paper's "automatic adaptation to the available resources".
``ladder=`` (e.g. ``(16, 8)``) lets the planner lower the call's operand
width; a lowered plan executes through
``repro_torch.quant.ops.quantized_conv2d`` and still returns float.
``reduce_axis=`` / ``reduce=`` are the channel-split hook of mesh
execution (``distributed/shard_exec.py``): under the single controller
each call sees one device's block of input channels and returns its
partial sum, and the executor reduces the devices' partials with
``reduce_partials``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.resources import ResourceBudget
from repro_torch.kernels.conv2d.ip1_vpu import conv2d_ip1
from repro_torch.kernels.conv2d.ip2_mxu import conv2d_ip2
from repro_torch.kernels.conv2d.ip3_packed import conv2d_ip3
from repro_torch.kernels.conv2d.ip4_dual import conv2d_ip4

_SINGLE = {"ip1_vpu": conv2d_ip1, "ip2_mxu": conv2d_ip2}
_DUAL = {"ip3_packed": conv2d_ip3, "ip4_dual": conv2d_ip4}
REDUCES = ("psum", "ring")


def _check_reduce(reduce: str) -> None:
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}; have ('psum', 'ring')")


def reduce_partials(parts: Sequence[torch.Tensor],
                    reduce: str = "psum") -> List[torch.Tensor]:
    """The channel split's all-reduce: the devices' partial outputs (one
    per rank, on its device) summed into the full output on every rank.
    ``reduce="psum"`` sums in rank order; ``"ring"`` follows the
    reference's ring schedule (``distributed/collectives.py``)."""
    _check_reduce(reduce)
    from repro_torch.distributed.collectives import psum, ring_all_reduce
    return (ring_all_reduce if reduce == "ring" else psum)(parts)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, ip: Optional[str] = None,
           budget: Optional[ResourceBudget] = None, ladder=(),
           reduce_axis: Optional[str] = None, reduce: str = "psum",
           **tile_kwargs) -> torch.Tensor:
    """Single-stream convolution through a selected IP (Conv1/Conv2).

    ``tile_kwargs`` (``block_cout=``) forward to the member's kernel.

    ``reduce_axis=`` names the mesh axis this call's input channels are
    split across: the result is then this device's partial sum, which
    the caller reduces across the devices with ``reduce_partials(parts,
    reduce)`` (``reduce=`` is ``"psum"`` or ``"ring"``, checked here as
    the reference checks it).
    """
    if reduce_axis is not None:
        _check_reduce(reduce)
    if ip is None:
        from repro_torch.core.ip import SiteSpec
        from repro_torch.core.plan import plan_single
        spec = SiteSpec.make("conv2d", "conv2d", (x.shape, w.shape),
                             x.dtype, ladder=ladder, dual=False)
        planned = plan_single(spec, budget)
        if planned.lowered:
            from repro_torch.quant.ops import quantized_conv2d
            return quantized_conv2d(x, w, bits=planned.precision_bits,
                                    ip=planned.ip.name)
        ip = planned.ip.name
    ip = ip.split(".")[-1]
    if ip not in _SINGLE:
        raise KeyError(f"{ip!r} is not a single-stream conv IP "
                       f"(have {sorted(_SINGLE)})")
    return _SINGLE[ip](x, w, **tile_kwargs)


def conv2d_dual(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor, *,
                ip: Optional[str] = None,
                budget: Optional[ResourceBudget] = None):
    """Two parallel convolutions through a selected IP (Conv3/Conv4);
    returns the two streams' outputs.

    No ``ladder=``: dual-stream callers already commit to a concrete
    operand dtype per stream (Conv3 demands int8 inputs outright).
    """
    if ip is None:
        from repro_torch.core.ip import SiteSpec
        from repro_torch.core.plan import plan_single
        spec = SiteSpec.make("conv2d", "conv2d", (xa.shape, w.shape),
                             xa.dtype, dual=True)
        ip = plan_single(spec, budget).ip.name
    ip = ip.split(".")[-1]
    if ip not in _DUAL:
        raise KeyError(f"{ip!r} is not a dual-stream conv IP "
                       f"(have {sorted(_DUAL)})")
    return _DUAL[ip](xa, xb, w)
