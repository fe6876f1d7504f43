"""Pool2 — im2col pooling (Conv2-style IP: stacked patch tensor).

Replaces ``repro/kernels/pool2d/mxu_im2col.py::pool2d_im2col``.  The
reference stacks the KH*KW strided taps into a patch tensor in VMEM and
reduces over the tap axis: max with one vectorized max, avg with one MXU
pass ``ones(1, KH*KW) @ patches`` and the count's division (integers
floor).  On the card a one-row product would waste the tensor cores and
TF32 would change f32 bits, so the member runs the window pool's body:
``pool2d_im2col_kernel`` in ``csrc/cnn_kernels.cu`` is ``pool2d_kernel``
under its own name, on ``vpu_window.pool_plan``'s cut (16-byte vectors
where C * itemsize is a multiple of 16 and both addresses are aligned,
else one element a thread; two outputs a thread; three 32-bit divisions
a thread).  The stacked (i-major) order from tap (0, 0) is
``window_reduce``'s, so the kernel, the plain version below and
``pool2d_window`` agree bitwise.  Max propagates NaN.  The ``block_c``
hint is validated as in the reference and priced by the footprint; it
does not shape the grid.
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import (Footprint, cost_cycles,
                                        mxu_pass_cycles, vpu_op_cycles)
from repro_torch.kernels.conv2d.inner import check_block
from repro_torch.kernels.pool2d.ref import (MODES, check_pool_geometry,
                                            pool2d_out_shape, pool_dtypes)
# CUDA_DTYPES: the window pool's, as the kernel is its body
from repro_torch.kernels.pool2d.vpu_window import CUDA_DTYPES, launch_pool


def pool2d_im2col_plain(x, *, window=(2, 2), stride=None,
                        mode: str = "max") -> torch.Tensor:
    """Stack the KH*KW strided taps, then reduce over the tap axis in
    stacked order: max, or the sum divided by the count (integers
    floor)."""
    (kh, kw), (sh, sw) = check_pool_geometry(x.shape, window, stride)
    _, ho, wo, _ = pool2d_out_shape(x.shape, (kh, kw), (sh, sw))
    acc_dtype, _ = pool_dtypes(x.dtype, mode)
    patches = torch.stack([x[:, i:i + (ho - 1) * sh + 1:sh,
                             j:j + (wo - 1) * sw + 1:sw, :]
                           for i in range(kh) for j in range(kw)])
    if mode == "avg":
        patches = patches.to(acc_dtype)
    acc = patches[0]
    for tap in patches[1:]:
        acc = torch.maximum(acc, tap) if mode == "max" else acc + tap
    if mode == "max":
        return acc.contiguous()
    if acc_dtype.is_floating_point:
        return acc / (kh * kw)
    return torch.div(acc, kh * kw, rounding_mode="floor")


def pool2d_im2col(x: torch.Tensor, *, window=(2, 2), stride=None,
                  mode: str = "max", block_c: int = 128) -> torch.Tensor:
    """Max/avg pooling, output dtype per ``pool_dtypes``.  CUDA tensors
    (``CUDA_DTYPES``) launch the kernel once, on ``pool_plan``'s cut;
    CPU tensors run the plain version."""
    if mode not in MODES:
        raise ValueError(f"unknown pool mode {mode!r}; have {MODES}")
    check_block("block_c", block_c)
    if not x.is_cuda:
        return pool2d_im2col_plain(x, window=window, stride=stride,
                                   mode=mode)
    return launch_pool("pool2d_im2col", "cnn_pool2d_im2col", x,
                       window=window, stride=stride, mode=mode)


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
