"""Flash attention (tiled online softmax) — the attention IP's member for
training and prefill.

Replaces ``repro/kernels/attention/flash.py::flash_attention``.  The
reference walks a grid (B*Hq, Sq/bq, Skv/bk) with kv innermost, keeps
the running max ``m``, normalizer ``l`` and f32 accumulator in VMEM
scratch, maps q head h to kv head h // group, masks padded keys and
(bottom-right aligned) causal positions with -1e30, skips kv blocks
above the diagonal and clamps ``l`` at 1e-30.

Two kernels compute the same function, one per dtype, both launched
through ``attn_flash``:

* bf16: ``attn_tc_flash_kernel<DP>`` in ``csrc/attn_tc_kernels.cu``, on
  the tensor cores.  One CTA per (b*Hq + h, block of 128 query rows): a
  producer warpgroup stages K/V tiles in shared memory with cp.async,
  two consumer warpgroups (64 rows each) take turns on ``wgmma`` for
  S = Q.K^T (f32) and O += P.V, and run the online softmax in registers
  between turns.  P goes into P.V split in two bf16 terms, bf16(P) and
  bf16(P - bf16(P)), so P keeps about 2^-17 of its value: P rounded once
  to bf16 misses ``chip_smoke.ATTN_BF16_TOL`` at attn_train4k.
* f32: ``flash_attention_kernel<D>`` in ``csrc/attn_kernels.cu`` on CUDA
  cores (Hopper has no IEEE-f32 MMA, and TF32 misses the f32
  tolerance), a FlashAttention-2 schedule on the FP32 FMA pipe: one CTA
  of 128 threads per (b*Hq + h, block of ``F32_ROWS`` query rows), the
  scaled Q block in shared memory, K/V tiles (``f32_tile(D)``) through a
  two-stage cp.async ring, S = Q.K^T register-tiled (8 rows x 4 keys a
  thread) and O += P.V too (8 rows x 8 dims a thread over one of the
  tile's key splits, the splits' partial sums added at the end), one
  online-softmax step a tile in base 2 (each exponential one
  ``ex2.approx`` of s log2(e) - m log2(e)), masks only on tiles the
  causal diagonal or the end of Skv crosses.

Both check bounds instead of padding along the sequence.  They are
built for the head dims of ``HEAD_DIMS``; any other head dim up to 384
is zero-padded to the next one by ``pad_head_dim`` (padded columns add
exact zeros to q.k^T, and their output columns are dropped) and scaled
by the original ``D ** -0.5``.  At 256 and 384 the bf16 kernel gives
each CTA one ``COL_BLOCK``-wide column block of V and O (a grid axis): it
computes the whole S over every column of D and accumulates its own 128
columns, so O's registers and V's tile stay those of 128 and S is
computed ``D / 128`` times; the f32 kernel keeps all of O in a CTA of
256 threads (4 rows a thread), one CTA an SM.  Past 384 any head dim is
padded to the next multiple of ``COL_BLOCK`` and runs the chunked
instances (``<0, 128>`` and ``<0>``): D is a runtime count of 128-column
chunks, each CTA owns one column block of O, and S accumulates over the
chunks of Q and K as they come through the shared-memory ring (Q is not
held whole).  No head dim is refused.
``bq``/``bk`` are the reference's VMEM block hints: validated, they do
not shape the launch.

Rows that see no key (causal with Sq > Skv) are 0 in the kernel and in
``flash_attention_plain``; the reference's oracle gives NaN there and
its Pallas kernel a value that depends on ``bq``/``bk`` (ROADMAP
queue 3).  Every other row is independent of the blocking.
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import Footprint, cost_cycles
from repro_torch.kernels import cuda
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.conv2d.inner import check_block

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128, 256, 384)
# the columns of O a bf16 CTA accumulates past head dim 128 (DV of
# attn_tc_flash_kernel<DP, DV>)
COL_BLOCK = 128
# the f32 kernel's blocking (FlashTile in csrc/attn_kernels.cu): query
# rows a CTA; by head dim, the keys of a K/V tile and the key splits of
# its P.V (partial sums added at the end)
F32_ROWS = 64


def f32_tile(d: int) -> tuple:
    """(keys a K/V tile, key splits of P.V) of the f32 kernel at padded
    head dim ``d`` (past 384 the chunked instance's)."""
    if d > HEAD_DIMS[-1]:
        return (32, 1)
    return (64, 2) if d <= 64 else (32, 1) if d <= 256 else (16, 1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The attention contract's shapes: q (B, Hq, Sq, D), k and v
    (B, Hkv, Skv, D) with Hq a multiple of Hkv."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention takes q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Skv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if k.shape[1] == 0 or q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"Hq % Hkv != 0: {q.shape[1]} query heads cannot "
                         f"share {k.shape[1]} kv heads (GQA)")


def require_kernel_operands(q, k, v, item: int) -> None:
    """Dtype, device and alignment checks before a launch (any head dim
    runs); ``item`` is the kernel's ROADMAP queue 2 item."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in KERNEL_DTYPES or t.dtype != q.dtype:
            raise TypeError(
                f"{name} dtype {t.dtype} has no CUDA attention kernel (q "
                f"is {q.dtype}; have {list(KERNEL_DTYPES)}, one dtype for "
                f"q, k and v; ROADMAP queue 2, item {item})")
        cuda.require(t, name)
        if t.device != q.device:
            raise ValueError(f"q and {name} lie on {q.device} and "
                             f"{t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def padded_head_dim(d: int) -> int:
    """The head dim the kernels run for a head dim ``d``: the smallest
    of ``HEAD_DIMS`` at least ``d``, past the last the next multiple of
    ``COL_BLOCK`` (the chunked instances)."""
    for width in HEAD_DIMS:
        if d <= width:
            return width
    return _cdiv(d, COL_BLOCK) * COL_BLOCK


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``(q, k, v, d)``: the operands zero-padded along the head dim to
    ``padded_head_dim(d)`` (unchanged when ``d`` is one of
    ``HEAD_DIMS``), and ``d``, the original head dim, whose
    ``d ** -0.5`` the launch scales by and to which the caller slices
    the output back."""
    d = q.shape[3]
    pad = padded_head_dim(d) - d
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    return q, k, v, d


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the family oracle, with
    the rows that see no key set to 0 as the kernel sets them."""
    check_qkv(q, k, v)
    out = attention_ref(q, k, v, causal=causal)
    dead = q.shape[2] - k.shape[2]
    if causal and dead > 0:
        out[:, :, :dead] = 0
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """Softmax(q k^T * D^-0.5, masked) v -> (B, Hq, Sq, D) in q's dtype.
    CUDA tensors launch the kernel once; CPU tensors run
    ``flash_attention_plain``."""
    check_qkv(q, k, v)
    check_block("bq", bq)
    check_block("bk", bk)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal)
    require_kernel_operands(q, k, v, 14)
    q, k, v, d = pad_head_dim(q, k, v)
    b, hq, sq, dp = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :d]
    cuda.launch("flash_attention", "attn_flash", q.device,
                cuda.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, skv, dp,
                int(causal), d ** -0.5)
    return out if dp == d else out[..., :d].contiguous()


def footprint(b, hq, hkv, sq, skv, d, *, itemsize=2, bq=512, bk=512,
              causal=True) -> Footprint:
    bq_, bk_ = min(bq, sq), min(bk, skv)
    vmem = (bq_ * d + 2 * bk_ * d) * itemsize + (bq_ * d + 2 * bq_) * 4
    hbm = (b * hq * sq * d * 2 + 2 * b * hkv * skv * d) * itemsize
    frac = 0.5 if causal and sq == skv else 1.0
    flops = 4.0 * b * hq * sq * skv * d * frac
    cyc = flops / 2 / (128 * 128)  # MXU MACs/cycle
    passes = int(b * hq * _cdiv(sq, bq_) * _cdiv(skv, bk_) * frac) + 1
    return Footprint(vmem_bytes=int(vmem), hbm_bytes=int(hbm),
                     mxu_passes=passes,
                     vpu_ops=int(b * hq * sq * skv * frac * 4),
                     est_cycles=cost_cycles(cyc, hbm),
                     outputs_per_pass=1, max_operand_bits=32)
