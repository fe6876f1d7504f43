"""The yardstick's arithmetic, frozen: peaks, each kernel's operations
and bytes, and the model FLOPs behind ``mfu``.

Peaks are NVIDIA's H100 data sheet (dense, without sparsity), at the
card's full power limit.  Every conv member here multiplies on the CUDA
cores, and no CUDA-core path retires more multiply-adds a clock than
FFMA does, so the FP32 rate (a multiply-add counted as 2 operations)
bounds the integer rungs too: the int8 Conv2 kernel beats the 64-lane
INT32 rate (33.5e12) by a third on the card.

A bound takes each input byte read once and each output byte written
once, whatever the kernel reads again, and the operations that the
kernel's function needs: a conv's multiply-adds, counted twice.
Pooling and activations are left out of the operations, so a bound is
never above the least time the card could take.
"""
from __future__ import annotations

from typing import Tuple

PEAKS = {
    "H100 SXM": {"bytes_per_s": 3.35e12, "fp32_flops": 67e12},
    "H100 PCIe": {"bytes_per_s": 2.0e12, "fp32_flops": 51e12},
}


def peaks_for(device_name: str) -> dict:
    """The data sheet's peaks of the card named ``device_name``."""
    part = "H100 PCIe" if "PCIe" in device_name else "H100 SXM"
    return PEAKS[part]


def conv_macs(n, h, w, cin, k, cout) -> int:
    """Multiply-adds of a VALID stride-1 k x k conv."""
    return n * (h - k + 1) * (w - k + 1) * cout * k * k * cin


def pooled(h, w, k, window) -> Tuple[int, int]:
    """Pooled plane of a k x k conv over (h, w) under a stride-window
    max pool."""
    ph, pw = window
    return (h - k + 1 - ph) // ph + 1, (w - k + 1 - pw) // pw + 1


def _operand_bytes(bits: int) -> int:
    # 8-bit rungs hand int8 codes to the kernel; 16-bit rungs hand it
    # float32 values snapped to the grid
    return 1 if bits <= 8 else 4


def fused_cnn_work(n, h, w, cin, k, cout, window, bits):
    """(operations, bytes, rate) of one fused conv->pool->act launch."""
    po, qo = pooled(h, w, k, window)
    b = _operand_bytes(bits)
    nbytes = (n * h * w * cin * b + k * k * cin * cout * b
              + n * po * qo * cout * 4 + (cout * 4 if bits <= 8 else 0))
    return 2 * conv_macs(n, h, w, cin, k, cout), nbytes, "fp32_flops"


def conv2d_work(n, h, w, cin, k, cout, bits):
    """(operations, bytes, rate) of one standalone conv launch; its
    output is float32 or an int32 accumulator, 4 bytes an element."""
    b = _operand_bytes(bits)
    nbytes = (n * h * w * cin * b + k * k * cin * cout * b
              + n * (h - k + 1) * (w - k + 1) * cout * 4)
    return 2 * conv_macs(n, h, w, cin, k, cout), nbytes, "fp32_flops"


def bound_s(peaks: dict, ops: float, nbytes: float, rate: str) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger."""
    return max(nbytes / peaks["bytes_per_s"], ops / peaks[rate])


def frontend_flops(image, channels, k, window, d_model) -> int:
    """Model FLOPs of one image through the frontend: 2 x the convs' and
    the projection's multiply-adds (pooling and activations not
    counted)."""
    h, w, _ = image
    macs = 0
    for cin, cout in zip(channels[:-1], channels[1:]):
        macs += conv_macs(1, h, w, cin, k, cout)
        h, w = pooled(h, w, k, window)
    macs += h * w * channels[-1] * d_model
    return 2 * macs
