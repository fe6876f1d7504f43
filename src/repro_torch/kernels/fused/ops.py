"""Public wrapper for the fused CNN-block IP family: an explicit ``ip=``
name or a ``budget=`` through the resource-driven selector, mirroring
``kernels/conv2d/ops.py``.  ``ladder=`` lets the planner lower the whole
block's operand width; a lowered plan executes through
``repro_torch.quant.ops.quantized_fused_cnn_block`` (int8: the integer
kernel with the in-register rescale) and returns float."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.resources import ResourceBudget
from repro_torch.kernels.fused.cnn_block import fused_cnn_mxu, fused_cnn_vpu

_MEMBERS = {"fused_vpu": fused_cnn_vpu, "fused_mxu": fused_cnn_mxu}


def resolve_member(ip: str):
    """Qualified-or-short member name -> kernel wrapper, with the
    family-standard error."""
    short = ip.split(".")[-1]
    if short not in _MEMBERS:
        raise KeyError(f"{short!r} is not a fused CNN-block IP "
                       f"(have {sorted(_MEMBERS)})")
    return _MEMBERS[short]


def fused_cnn_block(x: torch.Tensor, w: torch.Tensor, *,
                    pool_window=(2, 2), pool_stride=None,
                    pool_mode: str = "max", activation: str = "relu",
                    ip: Optional[str] = None,
                    budget: Optional[ResourceBudget] = None, ladder=(),
                    **tile_kwargs) -> torch.Tensor:
    """conv -> pool -> activation as ONE launch through a selected member.
    ``tile_kwargs`` (``block_cout=``) forward to the kernel."""
    if ip is None:
        from repro_torch.core.ip import SiteSpec
        from repro_torch.core.plan import plan_single
        spec = SiteSpec.make("cnn_fused", "cnn_fused", (x.shape, w.shape),
                             x.dtype, ladder=ladder, window=pool_window,
                             stride=pool_stride, mode=pool_mode,
                             kind=activation)
        planned = plan_single(spec, budget)
        if planned.lowered:
            from repro_torch.quant.ops import quantized_fused_cnn_block
            return quantized_fused_cnn_block(
                x, w, pool_window=pool_window, pool_stride=pool_stride,
                pool_mode=pool_mode, activation=activation,
                bits=planned.precision_bits, ip=planned.ip.name)
        ip = planned.ip.name
    return resolve_member(ip)(x, w, pool_window=tuple(pool_window),
                              pool_stride=pool_stride, pool_mode=pool_mode,
                              act_kind=activation, **tile_kwargs)
