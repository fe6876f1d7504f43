"""Shared conv bodies — the single source of the per-tile convolution
math, in the two orders of the reference (``repro.kernels.conv2d.inner``).

On the card these are the ``__device__`` functions of
``csrc/cnn_device.cuh`` (``conv_taps_vpu`` / ``conv_part_vpu`` and
``conv_point_mxu``), which the standalone members (``ip1_vpu``,
``ip2_mxu``) and the fused members (``kernels/fused/cnn_block.py``) all
call; ``conv_output`` allocates the standalone members' output.  The functions below are their plain
PyTorch versions in the same order, which the CPU path runs and the
on-card checks compare against:

* vpu: for each tap (i, j), a partial that starts at 0 takes the shifted
  window's products with the tap over Cin in ascending order, then adds
  into the accumulator (the kernels' chain, with FMA there);
* mxu: im2col to (.., KH*KW*Cin) and one dot over that K.

The dual-stream members (``ip3_packed``, ``ip4_dual``) share
``launch_conv_dual``, one launch that writes both streams' outputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda

STYLE_CODE = {"vpu": 0, "mxu": 1}


def accumulate_vpu(x, w, *, ho: int, wo: int, acc_dtype):
    """Conv1-style: ``x`` (N, H, W, Cin) already in ``acc_dtype``,
    ``w`` (kh, kw, Cin, Cout).  Returns (N, Ho, Wo, Cout).  Every tap's
    partial takes the channels in ascending order from 0, then the taps'
    partials add into the accumulator in (i, j) order: the kernels'
    chain, all taps at once over a strided view of the windows."""
    kh, kw, cin, cout = w.shape
    n = x.shape[0]
    sn, sh, sw, sc = x.stride()
    windows = x.as_strided((n, ho, wo, kh, kw, cin), (sn, sh, sw, sh, sw, sc))
    taps = w.to(acc_dtype)
    part = torch.zeros((n, ho, wo, kh, kw, cout), dtype=acc_dtype,
                       device=x.device)
    for c in range(cin):
        part = part + windows[..., c, None] * taps[:, :, c]
    acc = torch.zeros((n, ho, wo, cout), dtype=acc_dtype, device=x.device)
    for i in range(kh):
        for j in range(kw):
            acc = acc + part[:, :, :, i, j]
    return acc


def im2col(x, kh: int, kw: int, *, ho: int, wo: int):
    """(N, H, W, Cin) -> (N, Ho, Wo, KH*KW*Cin) patches, K = (i, j, cin)."""
    return torch.cat([x[:, i:i + ho, j:j + wo, :] for i in range(kh)
                      for j in range(kw)], dim=-1)


def accumulate_mxu(x, w, *, ho: int, wo: int, acc_dtype):
    """Conv2-style: ``x`` (N, H, W, Cin) in the operand dtype, ``w``
    (kh, kw, Cin, Cout).  Returns (N, Ho, Wo, Cout)."""
    kh, kw, cin, cout = w.shape
    patches = im2col(x, kh, kw, ho=ho, wo=wo).to(acc_dtype)  # (N,Ho,Wo,K)
    wmat = w.reshape(kh * kw * cin, cout).to(acc_dtype)   # (K, Cout)
    return (patches[..., :, None] * wmat).sum(dim=-2, dtype=acc_dtype)


def check_conv_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d takes NHWC x and HWIO w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[-1] != w.shape[2]:
        raise ValueError(f"input channels {x.shape[-1]} != weight "
                         f"channels {w.shape[2]}")
    if w.shape[0] > x.shape[1] or w.shape[1] > x.shape[2]:
        raise ValueError(f"kernel {tuple(w.shape[:2])} exceeds the input "
                         f"plane {tuple(x.shape[1:3])}")


def check_dual_operands(xa: torch.Tensor, xb: torch.Tensor,
                        w: torch.Tensor) -> None:
    check_conv_operands(xa, w)
    if xa.shape != xb.shape or xa.dtype != xb.dtype:
        raise ValueError(f"the two streams must match: {tuple(xa.shape)} "
                         f"{xa.dtype} vs {tuple(xb.shape)} {xb.dtype}")


def check_block(name: str, value: int) -> None:
    if int(value) < 1:
        raise ValueError(f"{name} must be >= 1, got {value}")


def conv_output(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Check a standalone member's CUDA operands and allocate its output:
    f32 operands give f32, int8 operands give int32."""
    cuda.require(x, "x", (torch.float32, torch.int8))
    cuda.require(w, "w", (x.dtype,))
    n, h, w_, _ = x.shape
    kh, kw, _, cout = w.shape
    out_dtype = torch.int32 if x.dtype == torch.int8 else torch.float32
    return torch.empty((n, h - kh + 1, w_ - kw + 1, cout), dtype=out_dtype,
                       device=x.device)


def launch_conv_dual(counter: str, ip: int, xa: torch.Tensor,
                     xb: torch.Tensor, w: torch.Tensor, block_cout: int,
                     dtypes) -> tuple:
    """Launch ``conv2d_ip3_kernel`` (``ip=3``) or ``conv2d_ip4_kernel``
    (``ip=4``) of ``csrc/cnn_kernels.cu`` once for CUDA operands of one
    dtype among ``dtypes``: integers give int32, floats f32."""
    for t, what in ((xa, "xa"), (xb, "xb"), (w, "w")):
        cuda.require(t, what, dtypes)
    if xb.device != xa.device or w.device != xa.device or \
            w.dtype != xa.dtype:
        raise ValueError(f"xa, xb and w must share one device and dtype, "
                         f"got {xa.device}/{xa.dtype}, {xb.device}, "
                         f"{w.device}/{w.dtype}")
    n, h, w_, cin = xa.shape
    kh, kw, _, cout = w.shape
    out_dtype = torch.float32 if xa.is_floating_point() else torch.int32
    ya, yb = (torch.empty((n, h - kh + 1, w_ - kw + 1, cout),
                          dtype=out_dtype, device=xa.device)
              for _ in range(2))
    if ya.numel() == 0:
        return ya, yb
    cuda.launch(counter, "cnn_conv2d_dual", xa.device, ip,
                cuda.DTYPE_CODE[xa.dtype], xa.data_ptr(), xb.data_ptr(),
                w.data_ptr(), ya.data_ptr(), yb.data_ptr(), n, h, w_, cin,
                kh, kw, cout, min(int(block_cout), cout))
    return ya, yb
