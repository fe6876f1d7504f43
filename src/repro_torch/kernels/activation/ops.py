"""Public wrapper for the activation IP family: an explicit ``ip=``
name or a ``budget=`` through the resource-driven selector, mirroring
``kernels/conv2d/ops.py``.  ``ladder=`` lets the planner lower the call's
operand width; a lowered plan evaluates the nonlinearity on the
intN-quantized input grid (``repro_torch.quant.ops.quantized_activation``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.resources import ResourceBudget
from repro_torch.kernels.activation.lut_poly import activation_lut
from repro_torch.kernels.activation.vpu_exact import activation_exact

_MEMBERS = {"act_vpu": activation_exact, "act_lut": activation_lut}


def activation(x: torch.Tensor, *, kind: str = "relu",
               ip: Optional[str] = None,
               budget: Optional[ResourceBudget] = None, ladder=(),
               **tile_kwargs) -> torch.Tensor:
    """Elementwise activation through a selected IP (Act1/Act2).
    ``tile_kwargs`` (``block_rows=``) forward to the member's kernel."""
    if ip is None:
        from repro_torch.core.ip import SiteSpec
        from repro_torch.core.plan import plan_single
        spec = SiteSpec.make("activation", "activation", (x.shape,),
                             x.dtype, ladder=ladder, kind=kind)
        planned = plan_single(spec, budget)
        if planned.lowered:
            from repro_torch.quant.ops import quantized_activation
            return quantized_activation(x, kind=kind,
                                        bits=planned.precision_bits,
                                        ip=planned.ip.name)
        ip = planned.ip.name
    ip = ip.split(".")[-1]
    if ip not in _MEMBERS:
        raise KeyError(
            f"{ip!r} is not an activation IP (have {sorted(_MEMBERS)})")
    return _MEMBERS[ip](x, kind=kind, **tile_kwargs)
