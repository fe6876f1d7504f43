"""Resource-driven IP selection — compatibility shims over the engine
(``repro/core/selector.py``).

The selection engine (feasibility + the paper's tie-break ranking) is
``core/plan.py::select_ip(family, spec, budget)``, driven by the
per-family site adapters of ``core/library.py``.  The five per-family
entry points below build a ``SiteSpec`` and defer; anything mapping
more than one op should build a ``NetworkPlan``
(``core/plan.py::plan_network``) so the ops share a partitioned budget.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ip import SiteSpec
from repro_torch.core.plan import select_ip
from repro_torch.core.resources import ResourceBudget


def select_conv_ip(x_shape, w_shape, *, dual: bool, dtype=torch.int8,
                   budget: Optional[ResourceBudget] = None,
                   with_footprint: bool = False):
    spec = SiteSpec.make("conv2d", "conv2d", (x_shape, w_shape), dtype,
                         dual=dual)
    return select_ip("conv2d", spec, budget=budget,
                     with_footprint=with_footprint)


def select_pool_ip(x_shape, *, window=(2, 2), stride=None, mode: str = "max",
                   dtype=torch.int8,
                   budget: Optional[ResourceBudget] = None,
                   with_footprint: bool = False):
    spec = SiteSpec.make("pool2d", "pool2d", (x_shape,), dtype,
                         window=window, stride=stride, mode=mode)
    return select_ip("pool2d", spec, budget=budget,
                     with_footprint=with_footprint)


def select_activation_ip(x_shape, *, kind: str = "relu",
                         dtype=torch.float32,
                         budget: Optional[ResourceBudget] = None,
                         with_footprint: bool = False):
    spec = SiteSpec.make("activation", "activation", (x_shape,), dtype,
                         kind=kind)
    return select_ip("activation", spec, budget=budget,
                     with_footprint=with_footprint)


def select_matmul_ip(a_shape, b_shape, *, dual: bool, dtype=torch.bfloat16,
                     budget: Optional[ResourceBudget] = None,
                     with_footprint: bool = False):
    spec = SiteSpec.make("matmul", "matmul", (a_shape, b_shape), dtype,
                         dual=dual)
    return select_ip("matmul", spec, budget=budget,
                     with_footprint=with_footprint)


def select_attention_ip(q_shape, kv_shape, *,
                        budget: Optional[ResourceBudget] = None,
                        dtype=torch.bfloat16, with_footprint: bool = False):
    spec = SiteSpec.make("attention", "attention", (q_shape, kv_shape), dtype)
    return select_ip("attention", spec, budget=budget,
                     with_footprint=with_footprint)


def describe_plan(plan) -> str:
    """Render a layer->IP assignment map: an ad-hoc ``{site: (ip, fp)}``
    dict or a ``NetworkPlan`` (whose ``.describe()`` additionally shows
    the budget fraction each site was granted)."""
    lines = []
    for site, (ip, fp) in plan.items():
        lines.append(f"{site:<40s} -> {ip.name:<28s} "
                     f"vmem={fp.vmem_bytes/2**20:7.2f}MiB "
                     f"mxu={fp.mxu_passes:<8d} vpu={fp.vpu_ops:.2e} "
                     f"cyc={fp.est_cycles:.3e}")
    return "\n".join(lines)
