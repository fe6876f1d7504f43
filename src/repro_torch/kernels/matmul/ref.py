"""Oracle for the matmul IP family.

Contract:
  a : (M, K)   activations
  b : (K, N)   weights
  y : (M, N)   int32 accumulation for integer inputs, f32 otherwise

Dual-stream contract (the conv3/conv4 generalization):
  a1, a2 : (M, K) two activation streams sharing the weight b.

Integer products are summed in float64, which holds every int8 dot
product of depth below 2^38 exactly, on any device (the card has no
integer ``torch.matmul``), and then cast to int32.  Float inputs run one
f32 ``torch.matmul``; on the card that is full IEEE f32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's default.
"""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not a.is_floating_point() and not b.is_floating_point():
        return torch.matmul(a.to(torch.float64),
                            b.to(torch.float64)).to(torch.int32)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def matmul_dual_ref(a1: torch.Tensor, a2: torch.Tensor, b: torch.Tensor):
    return matmul_ref(a1, b), matmul_ref(a2, b)
