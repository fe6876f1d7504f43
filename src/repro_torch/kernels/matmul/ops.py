"""Public wrappers for the matmul IP family (selector-aware).

``ladder=`` on ``matmul`` lets the planner lower the call's operand
width (w8a8 through the int8 kernel) when the native width does not
fit; lowered plans execute via ``repro_torch.quant.ops.quantized_matmul``
and still return float.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.resources import ResourceBudget
from repro_torch.kernels.matmul.dual import mm_dual_full, mm_dual_shared
from repro_torch.kernels.matmul.mxu import mm_mxu, mm_vpu

_SINGLE = {"mm_mxu": mm_mxu, "mm_vpu": mm_vpu}
_DUAL = {"mm_dual_shared": mm_dual_shared, "mm_dual_full": mm_dual_full}


def _member(table: dict, ip: str, what: str):
    ip = ip.split(".")[-1]
    if ip not in table:
        raise KeyError(f"{ip!r} is not a {what} matmul IP "
                       f"(have {sorted(table)})")
    return table[ip]


def matmul(a: torch.Tensor, b: torch.Tensor, *, ip: Optional[str] = None,
           budget: Optional[ResourceBudget] = None, ladder=(),
           **tile_kwargs) -> torch.Tensor:
    """a @ b through a selected IP (``mm_mxu`` / ``mm_vpu``).
    ``tile_kwargs`` (``bm=``, ``bn=``, ``bk=``) forward to the member."""
    if ip is None:
        from repro_torch.core.ip import SiteSpec
        from repro_torch.core.plan import plan_single
        spec = SiteSpec.make("matmul", "matmul", (a.shape, b.shape),
                             a.dtype, ladder=ladder, dual=False)
        planned = plan_single(spec, budget)
        if planned.lowered:
            from repro_torch.quant.ops import quantized_matmul
            return quantized_matmul(a, b, bits=planned.precision_bits,
                                    ip=planned.ip.name, **tile_kwargs)
        ip = planned.ip.name
    return _member(_SINGLE, ip, "single-stream")(a, b, **tile_kwargs)


def matmul_dual(a1: torch.Tensor, a2: torch.Tensor, b: torch.Tensor, *,
                ip: Optional[str] = None,
                budget: Optional[ResourceBudget] = None, **tile_kwargs):
    """(a1 @ b, a2 @ b) through a selected dual-stream IP
    (``mm_dual_shared``: int8 only; ``mm_dual_full``): both streams in
    one launch sharing each weight tile.  Outputs keep the accumulator
    dtype (int32 for int8 operands, f32 otherwise)."""
    if ip is None:
        from repro_torch.core.ip import SiteSpec
        from repro_torch.core.plan import plan_single
        spec = SiteSpec.make("matmul", "matmul", (a1.shape, b.shape),
                             a1.dtype, dual=True)
        ip = plan_single(spec, budget).ip.name
    return _member(_DUAL, ip, "dual-stream")(a1, a2, b, **tile_kwargs)
