"""Symmetric fixed-point quantization — the numeric core of the
precision ladder (``repro/quant/quantize.py`` in PyTorch).

* ``quantize_weights`` — symmetric per-output-channel intN quantization;
* ``quantize_acts`` — symmetric per-tensor intN quantization, optionally
  against a calibrated scale (``quant/calibrate.py``);
* ``dequantize`` / ``fake_quant`` — the inverse map and the
  quantize-then-dequantize round trip (how 16-bit sites execute: int32
  lanes cannot accumulate true int16 products without overflow, so
  they run fake-quant — quantized operands, float arithmetic — while
  8-bit sites run the true integer kernels);
* ``quantization_error`` — relative round-trip error.

Codes are ``round(x / scale)``: a division, as in the reference, never a
multiplication by the reciprocal (that moves codes at ties), and
``torch.round`` rounds half to even as ``jnp.round`` does.  Scales stay
float32 tensors on the operand's device (no ``.item()``, so no host
sync).  All scales are floored at ``MIN_SCALE``: an all-zero tensor
quantizes to zero codes with a finite scale.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Floor for every quantization scale: without it an all-zero tensor gives
# scale 0 and 0 * inf = NaN on the dequantize side.
MIN_SCALE = 1e-8

_CODE_DTYPES = {8: torch.int8, 16: torch.int16}


def qmax(bits: int) -> int:
    """Largest symmetric code at ``bits`` width (127 for int8)."""
    return (1 << (bits - 1)) - 1


def code_dtype(bits: int) -> torch.dtype:
    if bits not in _CODE_DTYPES:
        raise ValueError(f"unsupported quantization width {bits}; "
                         f"have {sorted(_CODE_DTYPES)}")
    return _CODE_DTYPES[bits]


class QuantizedTensor(NamedTuple):
    q: torch.Tensor          # intN payload
    scale: torch.Tensor      # f32; () per-tensor or keepdims per-channel


def _codes(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """round(x / scale) in f32, as the reference's promotion computes it:
    a 0-dim f32 scale would leave a bf16 ``x`` in bf16 under PyTorch's
    promotion and round the quotient there."""
    m = qmax(bits)
    q = torch.round(x.to(torch.float32) / scale)
    return torch.clamp(q, -m, m).to(code_dtype(bits))


def quantize_weights(w: torch.Tensor, *, axis: int = -1,
                     bits: int = 8) -> QuantizedTensor:
    """Symmetric per-output-channel intN quantization."""
    m = qmax(bits)
    keep = axis % w.dim()
    dims = tuple(i for i in range(w.dim()) if i != keep)
    amax = w.to(torch.float32).abs()
    if dims:                  # amax(dim=()) would reduce every axis
        amax = amax.amax(dim=dims, keepdim=True)
    scale = torch.clamp_min(amax, MIN_SCALE) / m
    return QuantizedTensor(_codes(w, scale, bits), scale)


def quantize_acts(x: torch.Tensor, *, bits: int = 8,
                  scale=None) -> QuantizedTensor:
    """Symmetric per-tensor intN activation quantization.

    ``scale`` overrides the batch statistic with a calibrated value
    (``quant/calibrate.py``); codes saturate at the calibrated range.
    """
    m = qmax(bits)
    if scale is None:
        amax = x.to(torch.float32).abs().amax()
        scale = torch.clamp_min(amax, MIN_SCALE) / m
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return QuantizedTensor(_codes(x, scale, bits), scale)


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    return qt.q.to(torch.float32) * qt.scale


def fake_quant(x: torch.Tensor, *, bits: int = 8,
               axis: Optional[int] = None) -> torch.Tensor:
    """Quantize-then-dequantize: the float tensor snapped to the intN
    grid, per channel over ``axis`` when given, per tensor otherwise."""
    if axis is None:
        return dequantize(quantize_acts(x, bits=bits))
    return dequantize(quantize_weights(x, axis=axis, bits=bits))


def int8_matmul(x: torch.Tensor, wq: QuantizedTensor, *,
                use_kernel: bool = False) -> torch.Tensor:
    """y = x @ dequant(wq): int8 x int8 products accumulated exactly,
    f32 rescale.

    ``use_kernel=True`` routes the contraction through ``mm_mxu``'s
    int8 kernel (on a CPU tensor its plain version); otherwise it runs
    in float64, which holds every int8 dot product of depth below 2^38
    exactly, on any device.  Both give the same int32 accumulator."""
    xq = quantize_acts(x)
    if use_kernel:
        from repro_torch.kernels.matmul.mxu import mm_mxu
        acc = mm_mxu(xq.q.reshape(-1, xq.q.shape[-1]), wq.q)
        acc = acc.reshape(x.shape[:-1] + (wq.q.shape[-1],))
    else:
        acc = torch.matmul(xq.q.to(torch.float64),
                           wq.q.to(torch.float64)).to(torch.int32)
    out_scale = xq.scale * wq.scale.reshape((1,) * (acc.dim() - 1) + (-1,))
    return acc.to(torch.float32) * out_scale


def _frobenius(t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t.reshape(-1))


def quantization_error(x: torch.Tensor, *, axis: Optional[int] = -1,
                       bits: int = 8) -> float:
    """Relative Frobenius error of the intN round trip (diagnostic);
    ``axis=None`` uses a per-tensor scale."""
    deq = fake_quant(x, bits=bits, axis=axis)
    x = x.to(torch.float32)
    return float(_frobenius(deq - x) / (_frobenius(x) + 1e-12))
