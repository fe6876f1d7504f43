"""Pool2 — im2col pooling (Conv2-style IP: stacked patch tensor).

The planner prices this member on every pool site, so its footprint is
ported now; at the default budget it never wins.  Its kernel
(``repro/kernels/pool2d/mxu_im2col.py::pool2d_im2col``) is ROADMAP
queue 2, item 7: on a CUDA tensor ``pool2d_im2col`` raises
``NotImplementedError``, on the CPU it runs the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import (Footprint, cost_cycles,
                                        mxu_pass_cycles, vpu_op_cycles)
from repro_torch.kernels.pool2d.ref import (MODES, check_pool_geometry,
                                            pool2d_out_shape, pool_dtypes)


def pool2d_im2col_plain(x, *, window=(2, 2), stride=None,
                        mode: str = "max") -> torch.Tensor:
    """Stack the KH*KW strided taps; max reduces over the tap axis, avg
    sums the taps (the reference's ones @ patches) then divides."""
    (kh, kw), (sh, sw) = check_pool_geometry(x.shape, window, stride)
    _, ho, wo, _ = pool2d_out_shape(x.shape, (kh, kw), (sh, sw))
    acc_dtype, _ = pool_dtypes(x.dtype, mode)
    patches = torch.stack([x[:, i:i + (ho - 1) * sh + 1:sh,
                             j:j + (wo - 1) * sw + 1:sw, :]
                           for i in range(kh) for j in range(kw)])
    if mode == "max":
        return patches.amax(dim=0)
    acc = patches.to(acc_dtype).sum(dim=0, dtype=acc_dtype)
    if acc_dtype.is_floating_point:
        return acc / (kh * kw)
    return torch.div(acc, kh * kw, rounding_mode="floor")


def pool2d_im2col(x: torch.Tensor, *, window=(2, 2), stride=None,
                  mode: str = "max", block_c: int = 128) -> torch.Tensor:
    if mode not in MODES:
        raise ValueError(f"unknown pool mode {mode!r}; have {MODES}")
    if x.is_cuda:
        raise NotImplementedError(
            "pool2d.pool_im2col has no CUDA kernel yet (ROADMAP queue 2, "
            "item 7)")
    return pool2d_im2col_plain(x, window=window, stride=stride, mode=mode)


def footprint(n, h, w, c, kh, kw, sh, sw, *, itemsize=1, mode="max",
              block_c: int = 128) -> Footprint:
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    bc = min(block_c, c)
    out_item = itemsize if mode == "max" else 4
    taps = kh * kw
    # avg materializes a second, 4-byte-accumulator copy of the patches.
    patch_item = itemsize if mode == "max" else itemsize + 4
    vmem = (h * w * bc * itemsize
            + taps * ho * wo * bc * patch_item    # stacked patch tensor
            + ho * wo * bc * out_item)
    hbm = n * h * w * c * itemsize + n * ho * wo * c * out_item
    grid_steps = n * ((c + bc - 1) // bc)
    # Patch construction is pure data movement: one op per tap element.
    move = n * ho * wo * c * taps
    if mode == "avg":
        passes = grid_steps
        cyc = grid_steps * mxu_pass_cycles(1, taps, ho * wo * bc)
        vpu = move
    else:
        passes = 0
        cyc = 0.0
        vpu = 2 * move          # movement + the vectorized max reduce
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=passes,
                     vpu_ops=vpu,
                     est_cycles=cost_cycles(max(cyc, vpu_op_cycles(vpu)), hbm),
                     outputs_per_pass=1, max_operand_bits=32)
