"""Plain reference of the adaptive-IP CNN frontend, frozen for the benchmark.

Written from the frontend's stated semantics, independent of the program:
it imports nothing of the program and takes none of its tables.  Layout is
NHWC, the conv is a VALID, stride-1 cross-correlation, pooling is a
non-overlapping max window, and the pooled map is flattened and projected
to ``d_model``.

Precision.  Every conv and the projection accumulate in float64 and are
rounded to float32 once, so a float32 site is judged against its exact
value and an integer site (int8 codes, |sum| < 2**24) exactly.  TF32 is
switched off for the call.  The precision ladder's rungs follow the
quantizer's stated rules:

* activations per tensor, weights per output channel (last axis);
  ``scale = max(amax, 1e-8) / (2**(bits-1) - 1)``, ``code = clamp(round(x
  / scale))`` with round half to even, all in float32;
* 8 bits: integer codes, exact accumulation, float32 rescale by
  ``x_scale * w_scale``; 16 bits: operands snapped to the grid, float
  arithmetic;
* a lowered pool quantizes its input per tensor and pools the codes; an
  int8 conv feeding an int8 pool requantizes its rescaled accumulator;
  an int8 relu after an int8 pool runs on the codes;
* the LUT activation rounds ``(x + r) * 255 / (2r)`` onto a 256-entry
  table of the exact function over ``[-r, r]`` (r = 4 for tanh, 8 for
  sigmoid and relu6).

``control=True`` computes every site one rung lower than stated: float32
sites with TF32 on, 16-bit rungs at 8 bits, 8-bit rungs at 4 bits.  It is
the benchmark's control and never a served result.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

LUT_SIZE = 256
LUT_RANGE = {"tanh": 4.0, "sigmoid": 8.0, "relu6": 8.0}
EXACT = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}
MIN_SCALE = 1e-8
# control: the rung below each stated one
LOWER = {32: 32, 16: 8, 8: 4}


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for float32 convs and matmuls inside, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def quant_acts(x: torch.Tensor, bits: int):
    """Per-tensor symmetric codes (float32 holding integers) and scale."""
    x = x.to(torch.float32)
    scale = torch.clamp_min(x.abs().amax(), MIN_SCALE) / qmax(bits)
    m = qmax(bits)
    return torch.clamp(torch.round(x / scale), -m, m), scale


def quant_weights(w: torch.Tensor, bits: int):
    """Per-output-channel (last axis) symmetric codes and scales."""
    w = w.to(torch.float32)
    dims = tuple(range(w.dim() - 1))
    scale = torch.clamp_min(w.abs().amax(dim=dims, keepdim=True),
                            MIN_SCALE) / qmax(bits)
    m = qmax(bits)
    return torch.clamp(torch.round(w / scale), -m, m), scale


def snap_acts(x, bits):
    q, s = quant_acts(x, bits)
    return q * s


def snap_weights(w, bits):
    q, s = quant_weights(w, bits)
    return q * s


def conv(x: torch.Tensor, w: torch.Tensor, *, fast: bool = False):
    """VALID stride-1 cross-correlation, NHWC x (KH, KW, Cin, Cout)."""
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1)
    if fast:      # the control's float32 rung: TF32 on
        with tf32(True):
            y = F.conv2d(xc.to(torch.float32), wc.to(torch.float32))
    else:
        y = F.conv2d(xc.to(torch.float64), wc.to(torch.float64))
    return y.to(torch.float32).permute(0, 2, 3, 1).contiguous()


def max_pool(x: torch.Tensor, window) -> torch.Tensor:
    kh, kw = window
    y = F.max_pool2d(x.to(torch.float32).permute(0, 3, 1, 2), (kh, kw))
    return y.permute(0, 2, 3, 1).contiguous()


def lut(x: torch.Tensor, kind: str) -> torch.Tensor:
    r = LUT_RANGE[kind]
    grid = torch.linspace(-r, r, LUT_SIZE, dtype=torch.float32)
    table = EXACT[kind](grid).to(x.device)
    q = torch.round((x.to(torch.float32) + r)
                    * ((LUT_SIZE - 1) / (2.0 * r)))
    q = torch.nan_to_num(torch.clamp(q, 0, LUT_SIZE - 1), nan=0.0)
    return table[q.to(torch.int64)]


def activate(x, kind: str, lut_member: bool):
    return lut(x, kind) if lut_member else EXACT[kind](x.to(torch.float32))


def _bits(site: dict, control: bool) -> int:
    b = int(site["bits"])
    return LOWER[b] if control else b


def fused_block(x, w, site: dict, *, window, kind: str, control: bool):
    """conv -> pool -> act as one site at the site's rung."""
    bits = _bits(site, control)
    fast = control and bits == 32
    if bits == 32:
        acc = conv(x, w, fast=fast)
    elif bits <= 8:
        xq, xs = quant_acts(x, bits)
        wq, ws = quant_weights(w, bits)
        acc = conv(xq, wq) * (xs * ws).reshape(-1)
    else:
        acc = conv(snap_acts(x, bits), snap_weights(w, bits))
    return activate(max_pool(acc, window), kind, False)


def chain_block(x, w, sites: Sequence[dict], *, window, kind: str,
                control: bool):
    """conv, pool and act as three sites, each at its own rung, with the
    quantizer boundaries the ladder's rules put between them."""
    conv_s, pool_s, act_s = sites
    cb, pb, ab = (_bits(s, control) for s in sites)
    qscale: Optional[torch.Tensor] = None
    # conv
    if cb == 32:
        y = conv(x, w, fast=control)
    elif cb <= 8:
        xq, xs = quant_acts(x, cb)
        wq, ws = quant_weights(w, cb)
        y = conv(xq, wq)
        qscale = xs * ws.reshape(1, 1, 1, -1)
    else:
        y = conv(snap_acts(x, cb), snap_weights(w, cb))
    # pool
    if qscale is not None and pb <= 8:
        q, s = quant_acts(y * qscale, pb)
        y, qscale = max_pool(q, window), s
    else:
        if qscale is not None:
            y, qscale = y * qscale, None
        if pb == 32:
            y = max_pool(y, window)
        elif pb <= 8:
            q, s = quant_acts(y, pb)
            y = max_pool(q, window) * s
        else:
            y = max_pool(snap_acts(y, pb), window)
    # act
    lut_member = act_s["member"].endswith("act_lut")
    if qscale is not None and ab < 32 and kind == "relu" and ab == pb:
        return torch.relu(y) * qscale
    if qscale is not None:
        y = y * qscale
    if ab < 32:
        y = snap_acts(y, ab)
    return activate(y, kind, lut_member)


def frontend(params: Dict, images: torch.Tensor, plan: List[dict], *,
             window=(2, 2), kind: str = "relu",
             control: bool = False) -> torch.Tensor:
    """images (B, H, W, C) -> (B, S, d_model) under ``plan``: one entry a
    block, ``{"fused": {...}}`` or ``{"conv": {...}, "pool": {...},
    "act": {...}}``, each site ``{"member": name, "bits": n}``.  With TF32
    off unless ``control`` asks for the float32 rung below."""
    with tf32(False):
        x = images.to(torch.float32)
        for bp, block in zip(params["blocks"], plan):
            if "fused" in block:
                x = fused_block(x, bp["w"], block["fused"], window=window,
                                kind=kind, control=control)
            else:
                x = chain_block(x, bp["w"], [block[k] for k in
                                             ("conv", "pool", "act")],
                                window=window, kind=kind, control=control)
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        proj = params["proj"]
        if control:
            with tf32(True):
                return torch.matmul(tokens, proj.to(torch.float32))
        return torch.matmul(tokens.to(torch.float64),
                            proj.to(torch.float64)).to(torch.float32)
