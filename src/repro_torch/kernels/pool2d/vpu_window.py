"""Pool1 — windowed-reduce pooling (Conv1-style logic-only IP).

Replaces ``repro/kernels/pool2d/vpu_window.py::pool2d_window``.  The
kernel (``pool2d_kernel`` in ``csrc/cnn_kernels.cu``) is bound by device
memory: each input is read once (L1 and L2 serve the overlap of windows
with a stride below the window) and each output written once.  It runs
on the cut of ``pool_plan``: a thread owns ``ve`` channels, one 16-byte
vector of input (4 f32 or int32, 8 bf16, 16 int8), of up to two
outputs of one output row, ``lanes`` apart, and issues the 16-byte loads
of a chunk of taps (a whole 2x2 window) for both before it reduces any;
its (image, row, lane, channel) split is three 32-bit divisions once a
thread.  Stores are 16-byte vectors of the output type (bf16 max stays
bf16; bf16 avg gives f32 and int8 avg int32, two and four stores a
vector).  Where C * itemsize is no multiple of 16 or the input or output
is not 16-byte aligned (a tensor at a storage offset), the same kernel
runs with ``ve = 1``, an element a thread lane.  Each element takes its
taps through the shared ``__device__`` ``window_step`` in
``window_reduce``'s order, the one the fused members pool in: start from
the window's first element, then i-major; max propagates NaN, float avg
divides by the count, integer avg floors.  No tensor-core instruction.
The ``block_c`` hint is validated as in the reference and priced by the
footprint; it does not shape the grid.  ``mxu_im2col.pool2d_im2col``
launches the same body under ``pool2d_im2col_kernel`` (``launch_pool``).
"""
from __future__ import annotations

import torch

from typing import NamedTuple

from repro_torch.core.resources import Footprint, cost_cycles, vpu_op_cycles
from repro_torch.kernels import cuda
from repro_torch.kernels.conv2d.inner import check_block
from repro_torch.kernels.pool2d.ref import (MODES, check_pool_geometry,
                                            pool2d_out_shape, pool_dtypes)

MODE_CODE = {"max": 0, "avg": 1}
# input dtypes the CUDA kernel takes (bf16 reduces in f32: max is exact
# and stays bf16, avg gives f32 as pool_dtypes says)
CUDA_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.int32)
# pool2d_kernel's CTA (kThreads), the outputs a thread covers at most
# (kPoolOuts) and the taps whose loads it issues before reducing them
# (kPoolTaps)
THREADS = 256
MAX_OUTS = 2
TAPS = 4


class WindowPlan(NamedTuple):
    """The cut of ``pool2d_kernel``: each thread owns ``ve`` channels
    (``16 // itemsize`` on the vector path, 1 on the scalar one) of
    ``outs`` outputs of one output row, ``lanes`` apart (ow = q, q +
    lanes); ``cv = C // ve`` threads cover a pixel's channels, ``lanes *
    cv`` an output row, and ``ctas`` CTAs of ``THREADS`` the N * Ho rows
    in order."""
    ve: int
    outs: int
    lanes: int
    cv: int
    ctas: int


def pool_plan(n: int, h: int, w: int, c: int, kh: int, kw: int, sh: int,
              sw: int, *, itemsize: int, x_addr: int = 0,
              y_addr: int = 0) -> WindowPlan:
    """The plan ``cnn_pool2d`` launches (and checks) for an (n, h, w, c)
    input of ``itemsize``-byte elements at address ``x_addr`` pooled into
    an output at ``y_addr``: 16-byte vectors along C where ``c *
    itemsize`` is a multiple of 16 and both addresses are 16-byte
    aligned, else one element a thread; two outputs a thread wherever
    the row has two."""
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    vec = (c * itemsize) % 16 == 0 and (x_addr | y_addr) % 16 == 0
    ve = 16 // itemsize if vec else 1
    outs = min(MAX_OUTS, wo)
    lanes = -(-wo // outs)
    cv = c // ve
    return WindowPlan(ve, outs, lanes, cv,
                      -(-(n * ho * lanes * cv) // THREADS))


def window_reduce(x, *, ho, wo, kh, kw, sh, sw, mode, acc_dtype):
    """The family's windowed reduce on (N, H, W, C), returning
    (N, Ho, Wo, C) — the plain version of the ``__device__``
    ``window_reduce`` the standalone and fused kernels share."""
    if mode == "avg":
        x = x.to(acc_dtype)
    acc = None
    for i in range(kh):
        for j in range(kw):
            win = x[:, i:i + (ho - 1) * sh + 1:sh,
                    j:j + (wo - 1) * sw + 1:sw, :]        # (N, Ho, Wo, C)
            if acc is None:
                acc = win
            elif mode == "max":
                acc = torch.maximum(acc, win)
            else:
                acc = acc + win
    if mode == "avg":
        count = kh * kw
        if acc_dtype.is_floating_point:
            acc = acc / count
        else:
            acc = torch.div(acc, count, rounding_mode="floor")
    return acc.contiguous()


def pool2d_window_plain(x, *, window=(2, 2), stride=None,
                        mode: str = "max") -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's order."""
    (kh, kw), (sh, sw) = check_pool_geometry(x.shape, window, stride)
    _, ho, wo, _ = pool2d_out_shape(x.shape, (kh, kw), (sh, sw))
    acc, _ = pool_dtypes(x.dtype, mode)
    return window_reduce(x, ho=ho, wo=wo, kh=kh, kw=kw, sh=sh, sw=sw,
                         mode=mode, acc_dtype=acc)


def launch_pool(counter: str, entry: str, x: torch.Tensor, *, window,
                stride, mode: str) -> torch.Tensor:
    """One launch of C entry ``entry`` (``cnn_pool2d`` or
    ``cnn_pool2d_im2col``: one body, two kernels) on ``pool_plan``'s cut
    of the CUDA tensor ``x``, counted under ``counter``."""
    cuda.require(x, "x", CUDA_DTYPES, ndim=4)
    (kh, kw), (sh, sw) = check_pool_geometry(x.shape, window, stride)
    n, h, w, c = x.shape
    _, ho, wo, _ = pool2d_out_shape(x.shape, (kh, kw), (sh, sw))
    _, out_dtype = pool_dtypes(x.dtype, mode)
    y = torch.empty((n, ho, wo, c), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    plan = pool_plan(n, h, w, c, kh, kw, sh, sw, itemsize=x.element_size(),
                     x_addr=x.data_ptr(), y_addr=y.data_ptr())
    cuda.launch(counter, entry, x.device, cuda.DTYPE_CODE[x.dtype],
                MODE_CODE[mode], x.data_ptr(), y.data_ptr(), n, h, w, c, kh,
                kw, sh, sw, plan.ve, plan.outs, plan.lanes, plan.ctas)
    return y


def pool2d_window(x: torch.Tensor, *, window=(2, 2), stride=None,
                  mode: str = "max", block_c: int = 128) -> torch.Tensor:
    """Max/avg pooling, output dtype per ``pool_dtypes``.  CUDA tensors
    (``CUDA_DTYPES``) launch the kernel once, on ``pool_plan``'s cut;
    CPU tensors run the plain version."""
    if mode not in MODES:
        raise ValueError(f"unknown pool mode {mode!r}; have {MODES}")
    check_block("block_c", block_c)
    if not x.is_cuda:
        return pool2d_window_plain(x, window=window, stride=stride,
                                   mode=mode)
    return launch_pool("pool2d_window", "cnn_pool2d", x, window=window,
                       stride=stride, mode=mode)


def footprint(n, h, w, c, kh, kw, sh, sw, *, itemsize=1, mode="max",
              block_c: int = 128) -> Footprint:
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    bc = min(block_c, c)
    out_item = itemsize if mode == "max" else 4
    # avg casts the plane to the 4-byte accumulator dtype on chip.
    cast_plane = 0 if mode == "max" else h * w * bc * 4
    vmem = (h * w * bc * itemsize                 # input plane
            + cast_plane
            + ho * wo * bc * out_item)            # output plane
    hbm = n * h * w * c * itemsize + n * ho * wo * c * out_item
    # One compare/add per tap, plus the strided gather for each window.
    vpu = 2 * n * ho * wo * c * kh * kw
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=0,
                     vpu_ops=vpu,
                     est_cycles=cost_cycles(vpu_op_cycles(vpu), hbm),
                     outputs_per_pass=1, max_operand_bits=32)
