"""Dual-stream matmul members — Conv3/Conv4 generalized to the LM hot
path (``repro/kernels/matmul/dual.py``).  Footprint only in this slice.

``mm_dual_shared`` (Conv3 analogue): two int8 activation streams share
one weight-tile fetch and one pass; operands limited to 8 bits.
``mm_dual_full`` (Conv4 analogue): the same shared-weight structure at
full precision.  The planner prices both on every dual-stream matmul
site; their kernel (``_mm_dual``) is ROADMAP queue 2, item 13.
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import Footprint, cost_cycles, mxu_pass_cycles
from repro_torch.kernels.matmul.mxu import _cdiv


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name} has no kernel in the port yet (ROADMAP queue 2, item 13)")


def mm_dual_shared(a1, a2, b, *, bm: int = 256, bn: int = 256,
                   bk: int = 512):
    for t in (a1, a2, b):
        if t.dtype != torch.int8:
            raise TypeError("mm_dual_shared is limited to 8-bit operands "
                            f"(paper Conv3 contract); got {t.dtype}")
    _not_ported("matmul.mm_dual_shared")


def mm_dual_full(a1, a2, b, *, bm: int = 256, bn: int = 256,
                 bk: int = 512):
    _not_ported("matmul.mm_dual_full")


def footprint_dual(m, k, n, *, itemsize=1, bm=256, bn=256, bk=512,
                   int8: bool = True) -> Footprint:
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    vmem = 2 * bm * bk * itemsize + bk * bn * itemsize + 4 * bm * bn * 4
    hbm = 2 * m * k * itemsize + k * n * itemsize + 2 * m * n * 4
    # int8 MXU runs 2x: two streams cost one bf16-equivalent pass set.
    scale = 1.0 if int8 else 2.0
    cyc = scale * mxu_pass_cycles(m, k, n)
    passes = int(scale * _cdiv(m, bm) * _cdiv(n, bn) * _cdiv(k, bk))
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm,
                     mxu_passes=max(passes, 1), vpu_ops=0,
                     est_cycles=cost_cycles(cyc, hbm), outputs_per_pass=2,
                     max_operand_bits=8 if int8 else 32)


def footprint_shared(m, k, n, **kw) -> Footprint:
    """``mm_dual_shared``'s footprint: the int8 variant."""
    return footprint_dual(m, k, n, int8=True, **kw)


def footprint_full(m, k, n, itemsize=2, **kw) -> Footprint:
    """``mm_dual_full``'s footprint: full precision, bf16 by default."""
    return footprint_dual(m, k, n, int8=False, itemsize=itemsize, **kw)
