"""Conv3 — operand-packed dual convolution (paper: 1 DSP, two convs per
pass, operands limited to 8 bits).  Footprint only in this slice.

The planner prices this member on every dual-stream conv site; the CNN
frontend builds no dual sites, so it is never chosen on the served path.
Its kernel (``repro/kernels/conv2d/ip3_packed.py::conv2d_ip3``) is ROADMAP
queue 2, item 9.
"""
from __future__ import annotations

from repro_torch.core.resources import Footprint, cost_cycles, vpu_op_cycles


def conv2d_ip3(xa, xb, w, *, block_cout: int = 128):
    raise NotImplementedError(
        "conv2d.ip3_packed has no kernel in the port yet "
        "(ROADMAP queue 2, item 9)")


def footprint(n, h, w, cin, kh, kw, cout, *, itemsize=1,
              block_cout: int = 128) -> Footprint:
    ho, wo = h - kh + 1, w - kw + 1
    bc = min(block_cout, cout)
    vmem = (2 * h * w * cin * itemsize
            + h * w * cin * 4                 # packed plane
            + kh * kw * cin * bc * itemsize
            + 2 * ho * wo * bc * 4)
    hbm = (2 * n * h * w * cin * itemsize
           + kh * kw * cin * cout * itemsize
           + 2 * n * ho * wo * cout * 4)
    taps = n * ho * wo * cout * kh * kw * cin
    # ONE multiply per tap-pair, ~5 cheap ops for unpack+acc.
    vpu = taps * 6
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=0,
                     vpu_ops=vpu,
                     est_cycles=cost_cycles(vpu_op_cycles(vpu), hbm),
                     outputs_per_pass=2, max_operand_bits=8)
