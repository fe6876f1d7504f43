"""Per-family quantized execution paths (``repro/quant/ops.py``): conv2d,
pool2d, activation, the fused CNN block and matmul at a planned operand
width.

Each function takes float operands, quantizes them to ``bits``, runs the
family's selected member, and returns a float result:

* ``bits == 8`` — the true integer path: int8 codes into the kernel,
  int32 accumulation, f32 rescale (per-channel weight scales for conv);
* ``8 < bits < 32`` — fake-quant: operands snapped to the intN grid,
  float arithmetic (int32 lanes cannot accumulate int16 products
  without overflow).

``models/blocks.py`` composes these into mixed-precision networks, and
the ``kernels/<family>/ops.py`` wrappers call them when the planner
lowers a ``budget=`` call.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.quant.quantize import (dequantize, fake_quant,
                                        quantize_acts, quantize_weights)


def _check_bits(bits: int) -> None:
    if not 2 <= bits < 32:
        raise ValueError(f"quantized execution expects a lowered width "
                         f"(2..31 bits); got {bits}")


def quantized_conv2d(x: torch.Tensor, w: torch.Tensor, *, bits: int = 8,
                     ip: Optional[str] = None, act_scale=None,
                     return_scale: bool = False):
    """conv2d with operands quantized to ``bits``; f32 result.

    Weights are quantized per output channel (last axis of the
    (KH, KW, Cin, Cout) tensor), activations per tensor, optionally at a
    calibrated ``act_scale``.  ``return_scale=True`` returns
    ``(result, scale)``: at 8 bits the raw int32 accumulator and its
    (1, 1, 1, Cout) scale, so a caller can fuse the dequantize into the
    next fixed-point stage; at wider widths ``(float result, None)``.
    """
    _check_bits(bits)
    from repro_torch.kernels.conv2d.ops import conv2d
    if bits == 8:
        xq = quantize_acts(x, bits=8, scale=act_scale)
        wq = quantize_weights(w, axis=-1, bits=8)
        acc = conv2d(xq.q, wq.q, ip=ip)
        scale = xq.scale * wq.scale.reshape(1, 1, 1, -1)
        if return_scale:
            return acc, scale
        return acc.to(torch.float32) * scale
    y = conv2d(fake_quant(x, bits=bits), fake_quant(w, bits=bits, axis=-1),
               ip=ip)
    return (y, None) if return_scale else y


def quantized_pool2d(x: torch.Tensor, *, window=(2, 2), stride=None,
                     mode: str = "max", bits: int = 8,
                     ip: Optional[str] = None,
                     act_scale=None) -> torch.Tensor:
    """pool2d over intN codes; f32 result.  Pooling is scale-equivariant
    (max exactly, avg up to the family's floor division), so the input's
    scale carries through the pooled codes."""
    _check_bits(bits)
    from repro_torch.kernels.pool2d.ops import pool2d
    if bits == 8:
        xq = quantize_acts(x, bits=8, scale=act_scale)
        y = pool2d(xq.q, window=window, stride=stride, mode=mode, ip=ip)
        return y.to(torch.float32) * xq.scale
    return pool2d(fake_quant(x, bits=bits), window=window, stride=stride,
                  mode=mode, ip=ip)


def quantized_activation(x: torch.Tensor, *, kind: str = "relu",
                         bits: int = 8, ip: Optional[str] = None,
                         act_scale=None) -> torch.Tensor:
    """Activation evaluated on the intN-quantized input grid; f32 result.
    The nonlinearity runs on the dequantized values; the LUT member
    re-quantizes them to its own 256-level grid."""
    _check_bits(bits)
    from repro_torch.kernels.activation.ops import activation
    xq = quantize_acts(x, bits=bits, scale=act_scale)
    return activation(dequantize(xq), kind=kind, ip=ip)


def quantized_fused_cnn_block(x: torch.Tensor, w: torch.Tensor, *,
                              pool_window=(2, 2), pool_stride=None,
                              pool_mode: str = "max",
                              activation: str = "relu", bits: int = 8,
                              ip: Optional[str] = None,
                              act_scale=None) -> torch.Tensor:
    """Fused conv->pool->act with operands quantized to ``bits``; f32
    result.  At 8 bits int8 codes enter the one launch and the fused
    kernel rescales its int32 accumulator by the combined (activation x
    per-channel weight) scale in register; wider widths fake-quant the
    operands and run the float kernel."""
    _check_bits(bits)
    from repro_torch.kernels.fused.ops import fused_cnn_block, resolve_member
    if bits == 8:
        xq = quantize_acts(x, bits=8, scale=act_scale)
        wq = quantize_weights(w, axis=-1, bits=8)
        scale = (xq.scale * wq.scale).reshape(1, 1, 1, -1)
        member = resolve_member(ip or "fused_vpu")
        return member(xq.q, wq.q, scale, pool_window=tuple(pool_window),
                      pool_stride=pool_stride, pool_mode=pool_mode,
                      act_kind=activation)
    return fused_cnn_block(fake_quant(x, bits=bits),
                           fake_quant(w, bits=bits, axis=-1),
                           pool_window=pool_window, pool_stride=pool_stride,
                           pool_mode=pool_mode, activation=activation,
                           ip=ip)


def quantized_matmul(a: torch.Tensor, b: torch.Tensor, *, bits: int = 8,
                     ip: Optional[str] = None, act_scale=None,
                     **tile_kwargs) -> torch.Tensor:
    """a @ b with operands quantized to ``bits``; f32 result.

    ``b`` (the weight side) is quantized per output column; int8 runs the
    integer kernel (int32 accumulate), wider lowered widths fake-quant.
    """
    _check_bits(bits)
    from repro_torch.kernels.matmul.ops import matmul
    if bits == 8:
        aq = quantize_acts(a, bits=8, scale=act_scale)
        bq = quantize_weights(b, axis=-1, bits=8)
        acc = matmul(aq.q, bq.q, ip=ip, **tile_kwargs)
        scale = aq.scale * bq.scale.reshape(1, -1)
        return acc.to(torch.float32) * scale
    return matmul(fake_quant(a, bits=bits), fake_quant(b, bits=bits, axis=-1),
                  ip=ip, **tile_kwargs)
