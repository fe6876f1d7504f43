"""The frozen yardstick: model FLOPs, each byte counted once, the bound."""
from __future__ import annotations

import pytest

from perfbench.roofline import (PEAKS, bound_s, conv2d_work, frontend_flops,
                                fused_cnn_work, peaks_for)


def test_frontend_is_82010304_macs_an_image():
    # conv 3->16 at 222x222, conv 16->32 at 109x109, 32->64 over 2916
    macs = 222 * 222 * 16 * 27 + 109 * 109 * 32 * 144 + 2916 * 32 * 64
    assert macs == 82_010_304
    assert frontend_flops((224, 224, 3), (3, 16, 32), 3, (2, 2), 64) \
        == 2 * 82_010_304


@pytest.mark.parametrize("bits,item", [(32, 4), (16, 4), (8, 1)])
def test_fused_bytes_each_once(bits, item):
    ops, nbytes, rate = fused_cnn_work(64, 224, 224, 3, 3, 16, (2, 2), bits)
    want = (64 * 224 * 224 * 3 * item + 3 * 3 * 3 * 16 * item
            + 64 * 111 * 111 * 16 * 4 + (16 * 4 if bits == 8 else 0))
    assert nbytes == want
    assert ops == 2 * 64 * 222 * 222 * 16 * 27
    assert rate == "fp32_flops"


def test_conv_bytes_each_once():
    ops, nbytes, rate = conv2d_work(64, 111, 111, 16, 3, 32, 8)
    assert nbytes == 64 * 111 * 111 * 16 + 3 * 3 * 16 * 32 \
        + 64 * 109 * 109 * 32 * 4
    assert ops == 2 * 64 * 109 * 109 * 32 * 144 and rate == "fp32_flops"


def test_bound_is_the_larger_of_bytes_and_operations():
    p = PEAKS["H100 SXM"]
    assert bound_s(p, 67e12, 1.0, "fp32_flops") == pytest.approx(1.0)
    assert bound_s(p, 1.0, 3.35e12, "fp32_flops") == pytest.approx(1.0)
    assert peaks_for("NVIDIA H100 80GB HBM3") is p
    assert peaks_for("NVIDIA H100 PCIe") is PEAKS["H100 PCIe"]
