"""Flash decode — the attention IP's serving member: one new token
against a long KV cache.

Replaces ``repro/kernels/attention/decode.py::flash_decode``.  The
reference takes the whole GQA group of a kv head as its q tile
(group x d) and merges the online max/sum across kv blocks of ``bk``
keys in VMEM scratch, masking the padded tail with -1e30.

The kernel (``flash_decode_kernel<T, D>`` in ``csrc/attn_kernels.cu``)
runs one CTA per (b, kv head) with the group's q tile, accumulators and
softmax state in shared memory, and streams the cache in blocks of 64
keys (16-byte loads, widened to f32 in shared memory), merging online
through the same ``__device__`` step as ``flash_attention_kernel``.  It
reads every cache byte once: device memory bounds it.  ``bk`` is the
reference's VMEM block hint: validated, it does not shape the launch.
Split-KV across CTAs is later work (ROADMAP queue 2).
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import Footprint, hbm_cycles
from repro_torch.kernels import cuda
from repro_torch.kernels.attention.flash import (_cdiv, check_qkv,
                                                 require_kernel_operands)
from repro_torch.kernels.attention.ref import decode_attention_ref
from repro_torch.kernels.conv2d.inner import check_block


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
    b, hq, _, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    cuda.launch("flash_decode", "attn_decode", q.device,
                cuda.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, hq, hkv, skv, d,
                d ** -0.5)
    return out


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
