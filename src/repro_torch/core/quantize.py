"""Compatibility path: the fixed-point subsystem lives in
``repro_torch.quant``, as ``repro.core.quantize`` re-exports
``repro.quant``."""
from repro_torch.quant.quantize import (MIN_SCALE, QuantizedTensor,
                                        dequantize, fake_quant, int8_matmul,
                                        quantization_error, quantize_acts,
                                        quantize_weights)

__all__ = [
    "MIN_SCALE", "QuantizedTensor", "dequantize", "fake_quant",
    "int8_matmul", "quantization_error", "quantize_acts",
    "quantize_weights",
]
