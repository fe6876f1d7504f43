"""Fused conv->pool->activation CNN-block kernels — one launch per block,
the paper's stated future work ("integrate pooling and activation with
the convolution IPs").

Replaces ``repro/kernels/fused/cnn_block.py::_fused_call`` (members
``fused_cnn_vpu`` / ``fused_cnn_mxu``).  The unfused chain launches three
kernels and round-trips the conv output (the block's largest tensor) and
the pool output through device memory.  The fused kernel
(``fused_cnn_tiled_kernel<T, style, ...>`` in ``csrc/cnn_kernels.cu``)
cuts the block in pooled space (``inner.fused_plan``): a CTA owns a tile
of pooled outputs and a block of channels, fills the conv values their
windows read with the standalone member's own staging and conv body
(the tiled Conv1 or Conv2: halo and weights in shared memory, 8 pixels x
4 channels a thread), a conv tile at a time, passes them through shared
memory, reduces each window with the shared ``window_reduce`` steps in
its i-major order, applies the shared ``activate`` and writes once.  A
window taller or wider than a tile is walked in bands and its running
reduce carried across them in the same order.  Same functions, same
order: a float32 fused block is bitwise equal to its three-launch chain,
whatever ``block_cout``.

**int8 rung**: ``scale=`` (f32, one per output channel) rescales the
int32 accumulator to f32 in register before pooling, as the reference
does (cnn_block.py:71-75).  Integer operands without a scale pool in
int32 (floor average) and activate in f32.  On the card the kernel takes
the conv members' dtypes (``CUDA_DTYPES``: f32, bf16, int8, int16) and
gives f32.
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import (Footprint, cost_cycles,
                                        mxu_pass_cycles, vpu_op_cycles)
from repro_torch.kernels import cuda
from repro_torch.kernels.activation.ref import _FNS, KINDS
from repro_torch.kernels.activation.vpu_exact import OP_COST
from repro_torch.kernels.conv2d.inner import (CUDA_DTYPES,  # noqa: F401
                                              STYLE_CODE, accumulate_vpu,
                                              check_block,
                                              check_conv_operands, conv_mxu,
                                              fused_plan, kernel_operands)
from repro_torch.kernels.pool2d.ref import MODES, check_pool_geometry
from repro_torch.kernels.pool2d.vpu_window import MODE_CODE, window_reduce


def _geometry(h, w, kh, kw, ph, pw, sh, sw):
    """(conv Ho, conv Wo, pooled Ho, pooled Wo) of one fused block."""
    co_h, co_w = h - kh + 1, w - kw + 1
    return co_h, co_w, (co_h - ph) // sh + 1, (co_w - pw) // sw + 1


def fused_cnn_plain(style, x, w, scale=None, *, pool_window=(2, 2),
                    pool_stride=None, pool_mode: str = "max",
                    act_kind: str = "relu") -> torch.Tensor:
    """The fused kernel's function in plain PyTorch: the standalone
    members' plain bodies chained, so it is bitwise equal to the plain
    three-launch chain."""
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    (ph, pw), (sh, sw) = check_pool_geometry(
        (n, h - kh + 1, w_ - kw + 1, cout), pool_window, pool_stride)
    co_h, co_w, po, qo = _geometry(h, w_, kh, kw, ph, pw, sh, sw)
    acc_dtype = torch.float32 if x.is_floating_point() else torch.int32
    # The whole conv plane, as the standalone member computes it (rows
    # and columns no pool window reaches are computed and dropped).
    if style == "vpu":
        acc = accumulate_vpu(x.to(acc_dtype), w, ho=co_h, wo=co_w,
                             acc_dtype=acc_dtype)
    else:
        acc = conv_mxu(x, w)
    if scale is not None:
        acc = acc.to(torch.float32) * _scale_vector(scale, cout, acc.device)
    pool_acc = torch.float32 if acc.is_floating_point() else torch.int32
    pooled = window_reduce(acc, ho=po, wo=qo, kh=ph, kw=pw, sh=sh, sw=sw,
                           mode=pool_mode, acc_dtype=pool_acc)
    return _FNS[act_kind](pooled.to(torch.float32))


def _scale_vector(scale, cout: int, device) -> torch.Tensor:
    return torch.as_tensor(scale, dtype=torch.float32,
                           device=device).reshape(cout).contiguous()


def _fused_call(style, x, w, scale, pool_window, pool_stride, pool_mode,
                act_kind, block_cout):
    if act_kind not in KINDS:
        raise ValueError(f"unknown activation {act_kind!r}; have {KINDS}")
    if pool_mode not in MODES:
        raise ValueError(f"unknown pool mode {pool_mode!r}; have {MODES}")
    check_conv_operands(x, w)
    check_block("block_cout", block_cout)
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    (ph, pw), (sh, sw) = check_pool_geometry(
        (n, h - kh + 1, w_ - kw + 1, cout), pool_window, pool_stride)
    if not x.is_cuda:
        return fused_cnn_plain(style, x, w, scale, pool_window=(ph, pw),
                               pool_stride=(sh, sw), pool_mode=pool_mode,
                               act_kind=act_kind)
    x, w = kernel_operands(x, w)
    _, _, po, qo = _geometry(h, w_, kh, kw, ph, pw, sh, sw)
    sc = None if scale is None else _scale_vector(scale, cout, x.device)
    y = torch.empty((n, po, qo, cout), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    plan = fused_plan(h, w_, cin, kh, kw, cout, ph, pw, sh, sw,
                      itemsize=x.element_size(), block_cout=int(block_cout),
                      style=style)
    tile = plan.tile
    cuda.launch(f"fused_cnn_{style}", "cnn_fused", x.device,
                STYLE_CODE[style], cuda.DTYPE_CODE[x.dtype], x.data_ptr(),
                w.data_ptr(), None if sc is None else sc.data_ptr(),
                y.data_ptr(), n, h, w_, cin, kh, kw, cout, ph, pw, sh, sw,
                MODE_CODE[pool_mode], KINDS.index(act_kind), tile.glog,
                tile.twlog, tile.th, tile.cc, int(tile.whole), plan.tp,
                plan.tq)
    return y


def fused_cnn_vpu(x: torch.Tensor, w: torch.Tensor, scale=None, *,
                  pool_window=(2, 2), pool_stride=None,
                  pool_mode: str = "max", act_kind: str = "relu",
                  block_cout: int = 128) -> torch.Tensor:
    """Logic-only fused block: Conv1-order MAC, pool + act in register.

    ``scale`` (f32, one per output channel) switches on the int8 rung:
    integer operands, int32 accumulate, in-register rescale.
    """
    return _fused_call("vpu", x, w, scale, pool_window, pool_stride,
                       pool_mode, act_kind, block_cout)


def fused_cnn_mxu(x: torch.Tensor, w: torch.Tensor, scale=None, *,
                  pool_window=(2, 2), pool_stride=None,
                  pool_mode: str = "max", act_kind: str = "relu",
                  block_cout: int = 128) -> torch.Tensor:
    """Conv2-order fused block: im2col-order dot, pool + act in register."""
    return _fused_call("mxu", x, w, scale, pool_window, pool_stride,
                       pool_mode, act_kind, block_cout)


# ---------------------------------------------------------------------------
# Footprints — the combined block priced as ONE launch: the conv working
# set plus the pooled tile on chip, but ONLY input + weights + final
# output in the device-memory column.
# ---------------------------------------------------------------------------
def _pool_act_vpu_ops(n, cout, po, qo, ph, pw, kind):
    pool = 2 * n * po * qo * cout * ph * pw     # gather + compare/add per tap
    act = n * po * qo * cout * OP_COST.get(kind, 8)
    return pool + act


def footprint_vpu(n, h, w, cin, kh, kw, cout, ph, pw, sh, sw, *,
                  itemsize=1, mode="max", kind="relu",
                  block_cout: int = 128) -> Footprint:
    co_h, co_w, po, qo = _geometry(h, w, kh, kw, ph, pw, sh, sw)
    bc = min(block_cout, cout)
    vmem = (h * w * cin * itemsize            # x plane
            + kh * kw * cin * bc * itemsize   # weight tile
            + co_h * co_w * bc * 4            # resident conv accumulator
            + po * qo * bc * 4)               # pooled/activated tile
    hbm = (n * h * w * cin * itemsize
           + kh * kw * cin * cout * itemsize
           + n * po * qo * cout * 4)          # ONLY the final tensor
    vpu = (n * co_h * co_w * cout * kh * kw * cin * 2
           + _pool_act_vpu_ops(n, cout, po, qo, ph, pw, kind))
    if itemsize == 1:
        vpu += n * co_h * co_w * cout         # in-register rescale
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=0,
                     vpu_ops=vpu,
                     est_cycles=cost_cycles(vpu_op_cycles(vpu), hbm),
                     outputs_per_pass=1, max_operand_bits=32, launches=1)


def footprint_mxu(n, h, w, cin, kh, kw, cout, ph, pw, sh, sw, *,
                  itemsize=1, mode="max", kind="relu",
                  block_cout: int = 128) -> Footprint:
    co_h, co_w, po, qo = _geometry(h, w, kh, kw, ph, pw, sh, sw)
    bc = min(block_cout, cout)
    k = kh * kw * cin
    vmem = (h * w * cin * itemsize
            + co_h * co_w * k * itemsize      # im2col patches
            + k * bc * itemsize
            + co_h * co_w * bc * 4
            + po * qo * bc * 4)
    hbm = (n * h * w * cin * itemsize
           + kh * kw * cin * cout * itemsize
           + n * po * qo * cout * 4)
    passes = n * ((cout + bc - 1) // bc)
    cyc = n * mxu_pass_cycles(co_h * co_w, k, cout)
    vpu = (n * co_h * co_w * k                # im2col data movement
           + _pool_act_vpu_ops(n, cout, po, qo, ph, pw, kind))
    if itemsize == 1:
        vpu += n * co_h * co_w * cout
    return Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=passes,
                     vpu_ops=vpu,
                     est_cycles=cost_cycles(max(cyc, vpu_op_cycles(vpu)), hbm),
                     outputs_per_pass=1, max_operand_bits=32, launches=1)
