"""Public wrappers for the conv2d IP family.

``conv2d`` takes an explicit ``ip=`` name or a ``budget=``
(ResourceBudget) and defers to the resource-driven selector — the
paper's "automatic adaptation to the available resources".
``ladder=`` (e.g. ``(16, 8)``) lets the planner lower the call's operand
width; a lowered plan executes through
``repro_torch.quant.ops.quantized_conv2d`` and still returns float.
``reduce_axis=`` (mesh execution) and the dual-stream ``conv2d_dual``
are later slices and raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.resources import ResourceBudget
from repro_torch.kernels.conv2d.ip1_vpu import conv2d_ip1
from repro_torch.kernels.conv2d.ip2_mxu import conv2d_ip2

_SINGLE = {"ip1_vpu": conv2d_ip1, "ip2_mxu": conv2d_ip2}


def conv2d(x: torch.Tensor, w: torch.Tensor, *, ip: Optional[str] = None,
           budget: Optional[ResourceBudget] = None, ladder=(),
           reduce_axis: Optional[str] = None,
           **tile_kwargs) -> torch.Tensor:
    """Single-stream convolution through a selected IP (Conv1/Conv2).

    ``tile_kwargs`` (``block_cout=``) forward to the member's kernel.
    """
    if reduce_axis is not None:
        raise NotImplementedError(
            "channel-split reduction is mesh execution (ROADMAP queue 1, "
            "item 9)")
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


def conv2d_dual(xa, xb, w, *, ip: Optional[str] = None,
                budget: Optional[ResourceBudget] = None):
    """Two parallel convolutions (Conv3/Conv4): not ported yet."""
    raise NotImplementedError(
        "dual-stream convolution (conv2d.ip3_packed / conv2d.ip4_dual) is "
        "not ported yet (ROADMAP queue 2, items 9-10)")
