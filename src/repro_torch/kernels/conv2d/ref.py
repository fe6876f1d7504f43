"""Oracle for the conv2d IP family.

Contract shared by all four IPs:
  x : (N, H, W, Cin)            activations (int8 fixed-point or float)
  w : (KH, KW, Cin, Cout)       kernel coefficients
  y : (N, H-KH+1, W-KW+1, Cout) VALID padding, stride 1

Integer inputs accumulate exactly in int32 (the paper's fixed-point
contract); float inputs accumulate in float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.conv2d.inner import accumulate_vpu


def _acc_dtype(x_dtype, w_dtype) -> torch.dtype:
    if not x_dtype.is_floating_point and not w_dtype.is_floating_point:
        return torch.int32
    return torch.float32


def conv_out_shape(x_shape, w_shape):
    n, h, w, _ = x_shape
    kh, kw, _, cout = w_shape
    return (n, h - kh + 1, w - kw + 1, cout)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Reference convolution (cross-correlation, as in CNN frameworks),
    written as the explicit tap loop."""
    acc = _acc_dtype(x.dtype, w.dtype)
    _, ho, wo, _ = conv_out_shape(x.shape, w.shape)
    return accumulate_vpu(x.to(acc), w, ho=ho, wo=wo, acc_dtype=acc)


def conv2d_dual_ref(xa: torch.Tensor, xb: torch.Tensor, w: torch.Tensor):
    """Two parallel convolutions sharing one kernel (Conv3/Conv4
    contract)."""
    return conv2d_ref(xa, w), conv2d_ref(xb, w)
