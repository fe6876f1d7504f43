"""Oracle for the activation IP family.

Contract shared by all activation IPs:
  x : any shape, float or integer fixed-point
  y : same shape; computed in float32

Float inputs are returned in their own dtype; integer inputs are
promoted to float32.  gelu is the tanh approximation (``jax.nn.gelu``'s
default, which ``F.gelu`` only gives with ``approximate="tanh"``); relu
and relu6 propagate NaN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

KINDS = ("relu", "relu6", "sigmoid", "tanh", "gelu")

_FNS = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def activation_out_dtype(x_dtype: torch.dtype) -> torch.dtype:
    return x_dtype if x_dtype.is_floating_point else torch.float32


def activation_ref(x: torch.Tensor, *, kind: str = "relu") -> torch.Tensor:
    if kind not in _FNS:
        raise ValueError(f"unknown activation {kind!r}; have {KINDS}")
    y = _FNS[kind](x.to(torch.float32))
    return y.to(activation_out_dtype(x.dtype))
