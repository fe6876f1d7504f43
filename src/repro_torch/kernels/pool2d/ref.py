"""Oracle for the pool2d IP family.

Contract shared by all pool IPs:
  x      : (N, H, W, C)   activations (int8/int32 fixed-point or float)
  window : (KH, KW)       pooling window
  stride : (SH, SW)       defaults to the window (non-overlapping)
  y      : (N, (H-KH)//SH+1, (W-KW)//SW+1, C)   VALID padding

``mode="max"`` preserves the input dtype and propagates NaN.
``mode="avg"`` accumulates integers exactly in int32 and divides by the
window size with floor division (the paper's fixed-point contract);
float inputs accumulate in float32 and divide exactly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

MODES = ("max", "avg")


def norm_window_stride(window, stride) -> Tuple[Tuple[int, int],
                                                Tuple[int, int]]:
    """Single source of truth for window/stride normalization: scalars
    broadcast to both axes, stride defaults to the window."""
    kh, kw = (window, window) if isinstance(window, int) else window
    if stride is None:
        sh, sw = kh, kw
    else:
        sh, sw = (stride, stride) if isinstance(stride, int) else stride
    return (kh, kw), (sh, sw)


def pool_dtypes(x_dtype: torch.dtype, mode: str):
    """The family's dtype promotion rule: max preserves the input dtype
    (no accumulation); avg accumulates integers in int32 (floor
    division) and floats in float32.  Returns (acc, out)."""
    if mode == "max":
        return x_dtype, x_dtype
    acc = torch.float32 if x_dtype.is_floating_point else torch.int32
    return acc, acc


def check_pool_geometry(x_shape, window, stride):
    """Normalize and validate: raises if the window exceeds the plane."""
    (kh, kw), (sh, sw) = norm_window_stride(window, stride)
    _, h, w, _ = x_shape
    if kh > h or kw > w:
        raise ValueError(f"pool window {(kh, kw)} exceeds the input plane "
                         f"({h}, {w}) of {tuple(x_shape)}")
    return (kh, kw), (sh, sw)


def pool2d_out_shape(x_shape, window, stride=None):
    (kh, kw), (sh, sw) = norm_window_stride(window, stride)
    n, h, w, c = x_shape
    return (n, (h - kh) // sh + 1, (w - kw) // sw + 1, c)


def pool2d_ref(x: torch.Tensor, *, window=(2, 2),
               stride: Optional[Tuple[int, int]] = None,
               mode: str = "max") -> torch.Tensor:
    from repro_torch.kernels.pool2d.vpu_window import window_reduce
    if mode not in MODES:
        raise ValueError(f"unknown pool mode {mode!r}")
    (kh, kw), (sh, sw) = norm_window_stride(window, stride)
    _, ho, wo, _ = pool2d_out_shape(x.shape, (kh, kw), (sh, sw))
    acc, _ = pool_dtypes(x.dtype, mode)
    return window_reduce(x, ho=ho, wo=wo, kh=kh, kw=kw, sh=sh, sw=sw,
                         mode=mode, acc_dtype=acc)
