"""Flash decode — the attention IP's serving member: one new token
against a long KV cache.

Replaces ``repro/kernels/attention/decode.py::flash_decode``.  The
reference takes the whole GQA group of a kv head as its q tile
(group x d) and merges the online max/sum across kv blocks of ``bk``
keys in VMEM scratch, masking the padded tail with -1e30.

The kernel is split-KV (``flash_decode_split_kernel<T, D, GP>`` and
``decode_combine_kernel<T>`` in ``csrc/attn_kernels.cu``, one launch of
``attn_decode``): the grid is (b * Hkv x row blocks of up to 8 rows of
the group, splits), each CTA streams one chunk of the keys through a
cp.async ring in the cache's own dtype, its 8 warps each keep
an online softmax over their share of every stage's keys, and the warps
merge once per chunk into the split's partial (m, l, acc) in a
workspace (past head dim 384, padded to a multiple of 128, the chunked
instance: a grid axis over 128-column blocks of O, each stage's K
streamed in 128-column chunks and then its block of V, the query rows
whole in shared memory, at most 96 KB of them: ``decode_plan`` takes
fewer GQA rows a CTA at such head dims); a combine merges the splits in
ascending order, o = sum_s e_s acc_s / max(sum_s e_s l_s, 1e-30),
e_s = exp(m_s - max m)
— the partial-softmax merge of the reference's docstring.  The number
of splits comes from the launcher (``decode_plan``): enough that the
grid's last wave is nearly full, never an empty chunk.  It reads every
cache byte once: device memory bounds it.  ``bk`` is the reference's
VMEM block hint: validated, it does not shape the launch.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.resources import Footprint, hbm_cycles
from repro_torch.kernels import cuda
from repro_torch.kernels.attention.flash import (COL_BLOCK, HEAD_DIMS,
                                                 _cdiv, check_qkv,
                                                 pad_head_dim,
                                                 require_kernel_operands)
from repro_torch.kernels.attention.ref import decode_attention_ref
from repro_torch.kernels.conv2d.inner import check_block

WARPS = 8            # a CTA's warps, each with its own online softmax


def keys_per_warp(d: int, itemsize: int) -> int:
    """Keys a warp takes of each stage (``DecodeTile::kKeysPerWarp``;
    past head dim 384 the chunked instance's, whose units are rows of
    ``COL_BLOCK`` columns)."""
    row = (COL_BLOCK if d > HEAD_DIMS[-1] else d) * itemsize
    return 16 if row <= 128 else 8 if row <= 256 else 4


def split_chunk(skv: int, splits: int, tile: int) -> Tuple[int, int]:
    """(keys a split, splits) for ``splits`` asked: a whole number of
    ``tile``-key stages a split and no empty split (``decode_chunk`` /
    ``decode_splits`` of ``csrc/attn_kernels.cu``)."""
    chunk = _cdiv(_cdiv(skv, splits), tile) * tile
    return chunk, _cdiv(skv, chunk)


def _check_single(q: torch.Tensor) -> None:
    if q.dim() == 4 and q.shape[2] != 1:
        raise ValueError(f"flash_decode is the single-token member: q must "
                         f"be (B, Hq, 1, D), got {tuple(q.shape)}")


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the family oracle)."""
    check_qkv(q, k, v)
    _check_single(q)
    return decode_attention_ref(q, k, v)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 bk: int = 1024) -> torch.Tensor:
    """q (B, Hq, 1, D) against k/v (B, Hkv, Skv, D) -> (B, Hq, 1, D) in
    q's dtype.  CUDA tensors launch the kernel once; CPU tensors run
    ``flash_decode_plain``."""
    check_qkv(q, k, v)
    _check_single(q)
    check_block("bk", bk)
    if not q.is_cuda:
        return flash_decode_plain(q, k, v)
    require_kernel_operands(q, k, v, 15)
    q, k, v, d = pad_head_dim(q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :d]
    splits, _, ws_floats = decode_plan(q, k)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=q.device)
    b, hq, _, dp = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    cuda.launch("flash_decode", "attn_decode", q.device,
                cuda.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), ws.data_ptr(), b, hq, hkv, skv,
                dp, splits, d ** -0.5)
    return out if dp == d else out[..., :d].contiguous()


def decode_plan(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, int, int]:
    """The launcher's choice for CUDA operands q and k: (splits, resident
    CTAs an SM, workspace floats).  Launches nothing."""
    b, hq, _, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    splits, resident = ctypes.c_int(), ctypes.c_int()
    ws_floats = ctypes.c_longlong()
    cuda.call("flash_decode", "attn_decode_plan", q.device,
              cuda.DTYPE_CODE[q.dtype], b, hq, hkv, skv, d,
              ctypes.byref(splits), ctypes.byref(resident),
              ctypes.byref(ws_floats))
    return splits.value, resident.value, ws_floats.value


def footprint(b, hq, hkv, skv, d, *, itemsize=2, bk=1024) -> Footprint:
    group = hq // hkv
    bk_ = min(bk, skv)
    vmem = (group * d + 2 * bk_ * d) * itemsize + (group * d + 2 * group) * 4
    hbm = 2 * b * hkv * skv * d * itemsize + 2 * b * hq * d * itemsize
    # decode is HBM-bound by construction: est = cache sweep time.
    return Footprint(vmem_bytes=int(vmem), hbm_bytes=int(hbm),
                     mxu_passes=b * hkv * _cdiv(skv, bk_),
                     vpu_ops=int(4 * b * hq * skv),
                     est_cycles=hbm_cycles(hbm),
                     outputs_per_pass=1, max_operand_bits=32)
