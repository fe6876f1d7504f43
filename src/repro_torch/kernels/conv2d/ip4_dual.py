"""Conv4 — dual parallel convolution (paper: 2 DSPs, two convs per pass,
full precision).  Footprint only in this slice.

The planner prices this member on every dual-stream conv site; the CNN
frontend builds no dual sites, so it is never chosen on the served path.
Its kernel (``repro/kernels/conv2d/ip4_dual.py::conv2d_ip4``) is ROADMAP
queue 2, item 10.
"""
from __future__ import annotations

from repro_torch.core.resources import Footprint, cost_cycles, mxu_pass_cycles


def conv2d_ip4(xa, xb, w, *, block_cout: int = 128):
    raise NotImplementedError(
        "conv2d.ip4_dual has no kernel in the port yet "
        "(ROADMAP queue 2, item 10)")


def footprint(n, h, w, cin, kh, kw, cout, *, itemsize=1,
              block_cout: int = 128) -> Footprint:
    ho, wo = h - kh + 1, w - kw + 1
    bc = min(block_cout, cout)
    k = kh * kw * cin
    vmem = (2 * h * w * cin * itemsize
            + 2 * ho * wo * k * itemsize
            + k * bc * itemsize
            + 2 * ho * wo * bc * 4)
    hbm = (2 * n * h * w * cin * itemsize
           + kh * kw * cin * cout * itemsize   # weights fetched ONCE
           + 2 * n * ho * wo * cout * 4)
    passes = 2 * n * ((cout + bc - 1) // bc)
    cyc = 2 * n * mxu_pass_cycles(ho * wo, k, cout)
    vpu = 2 * n * ho * wo * k
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=passes,
                     vpu_ops=vpu,
                     est_cycles=cost_cycles(cyc, hbm),
                     outputs_per_pass=2, max_operand_bits=32)
