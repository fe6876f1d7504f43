"""Public wrapper for the pool2d IP family: an explicit ``ip=`` name or
a ``budget=`` through the resource-driven selector, mirroring
``kernels/conv2d/ops.py``.  ``ladder=`` lets the planner lower the call's
operand width; a lowered plan executes through
``repro_torch.quant.ops.quantized_pool2d`` and returns float."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.resources import ResourceBudget
from repro_torch.kernels.pool2d.mxu_im2col import pool2d_im2col
from repro_torch.kernels.pool2d.ref import MODES, check_pool_geometry
from repro_torch.kernels.pool2d.vpu_window import pool2d_window

_MEMBERS = {"pool_vpu": pool2d_window, "pool_im2col": pool2d_im2col}


def pool2d(x: torch.Tensor, *, window=(2, 2), stride=None, mode: str = "max",
           ip: Optional[str] = None,
           budget: Optional[ResourceBudget] = None, ladder=(),
           **tile_kwargs) -> torch.Tensor:
    """Max/avg pooling through a selected IP (Pool1/Pool2).
    ``tile_kwargs`` (``block_c=``) forward to the member's kernel."""
    if mode not in MODES:
        raise ValueError(f"unknown pool mode {mode!r}; have {MODES}")
    window, stride = check_pool_geometry(x.shape, window, stride)
    if ip is None:
        from repro_torch.core.ip import SiteSpec
        from repro_torch.core.plan import plan_single
        spec = SiteSpec.make("pool2d", "pool2d", (x.shape,), x.dtype,
                             ladder=ladder, window=window, stride=stride,
                             mode=mode)
        planned = plan_single(spec, budget)
        if planned.lowered:
            from repro_torch.quant.ops import quantized_pool2d
            return quantized_pool2d(x, window=window, stride=stride,
                                    mode=mode, bits=planned.precision_bits,
                                    ip=planned.ip.name)
        ip = planned.ip.name
    ip = ip.split(".")[-1]
    if ip not in _MEMBERS:
        raise KeyError(f"{ip!r} is not a pool2d IP (have {sorted(_MEMBERS)})")
    return _MEMBERS[ip](x, window=window, stride=stride, mode=mode,
                        **tile_kwargs)
