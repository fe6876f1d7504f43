"""Fixed-point precision subsystem (``repro/quant`` in PyTorch).

* ``quantize``  — symmetric intN quantize/dequantize core + error metric
* ``calibrate`` — activation ranges from sample batches
* ``ops``       — quantized execution per plannable family
* ``report``    — per-site quantization-error reports

The planning half (the precision ladder) lives in ``core/plan.py``.
"""
from repro_torch.quant.calibrate import Calibrator
from repro_torch.quant.ops import (quantized_activation, quantized_conv2d,
                                   quantized_matmul, quantized_pool2d)
from repro_torch.quant.quantize import (MIN_SCALE, QuantizedTensor,
                                        dequantize, fake_quant, int8_matmul,
                                        qmax, quantization_error,
                                        quantize_acts, quantize_weights)
from repro_torch.quant.report import (SiteQuantReport, max_rel_error,
                                      relative_error, summarize)

__all__ = [
    "Calibrator", "MIN_SCALE", "QuantizedTensor", "SiteQuantReport",
    "dequantize", "fake_quant", "int8_matmul", "max_rel_error", "qmax",
    "quantization_error", "quantize_acts", "quantize_weights",
    "quantized_activation", "quantized_conv2d", "quantized_matmul",
    "quantized_pool2d", "relative_error", "summarize",
]
