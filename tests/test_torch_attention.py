"""The port's attention family (``repro_torch.kernels.attention``, its
library registration and ``select_attention_ip``) and the budget sweep's
LM sites against the reference (``repro``; Pallas in interpret mode on
CPU).

On a CPU tensor each port wrapper runs its plain PyTorch version, the
function the CUDA kernels are checked against on the card by
``chip_smoke.py``.  Inputs are made with numpy from a seed.

Tolerances are the reference's own (``tests/test_kernels_attention.py``):
f32 within ``rtol=2e-4, atol=2e-5`` (the Pallas kernel merges key blocks
online, the plain version takes one softmax), bf16 within
``rtol=5e-2, atol=5e-2`` (one bf16 rounding of the output, taken after
differently ordered f32 sums); plan JSON byte-equal.
"""
import dataclasses
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import library as j_library
from repro.core import plan as j_plan
from repro.core import selector as j_sel
from repro.core.ip import SiteSpec as JSpec
from repro.core.resources import ResourceBudget as JBudget
from repro.kernels.attention.decode import flash_decode as j_decode
from repro.kernels.attention.flash import flash_attention as j_flash
from repro.kernels.attention.ref import attention_ref as j_ref
from repro_torch.core import library as t_library
from repro_torch.core import plan as t_plan
from repro_torch.core import selector as t_sel
from repro_torch.core.ip import SiteSpec as TSpec
from repro_torch.core.resources import ResourceBudget as TBudget
from repro_torch.kernels.attention import flash as t_flash_mod
from repro_torch.kernels.attention import decode as t_decode_mod
from repro_torch.kernels.attention.decode import (flash_decode,
                                                  flash_decode_plain)
from repro_torch.kernels.attention.flash import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.attention.ops import attention
from repro_torch.kernels.attention.ref import (attention_ref,
                                               decode_attention_ref)

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)

# the reference's tests/test_kernels_attention.py::CASES:
# (B, Hq, Hkv, Sq, Skv, D)
CASES = [(1, 4, 4, 32, 32, 16), (2, 8, 2, 64, 64, 32), (1, 8, 1, 60, 60, 16),
         (2, 4, 4, 48, 96, 32)]
CASE_IDS = ["mha32", "gqa4x64", "mqa60", "cross48x96"]

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")


def _both(x, dtype=np.float32):
    """One numpy array as a JAX array and a torch tensor (bf16 through
    f32 on both sides, so both hold the same bf16 values)."""
    if dtype == "bfloat16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(np.array(x, copy=True))


def _qkv(rng, b, hq, hkv, sq, skv, d, dtype=np.float32):
    return [_both(rng.normal(size=s).astype(np.float32), dtype)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


# --------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_flash_plain_matches_reference_kernel(rng, case, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, *case)
    want = j_flash(jq, jk, jv, causal=causal, bq=16, bk=16)
    got = flash_attention(tq, tk, tv, causal=causal, bq=16, bk=16)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(
        _np(flash_attention_plain(tq, tk, tv, causal=causal)), _np(want),
        **F32)


@pytest.mark.parametrize("case", [(1, 4, 2, 64, 64, 32), (2, 8, 2, 48, 96, 16)],
                         ids=["reference", "cross"])
def test_flash_bf16_matches_reference_kernel(rng, case):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, *case, dtype="bfloat16")
    want = j_flash(jq, jk, jv, causal=True, bq=16, bk=16)
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def _split_p_flash(q, k, v, causal):
    """The arithmetic of the bf16 tensor-core kernel
    (``csrc/attn_tc_kernels.cu``), emulated on the CPU: 128-row query
    blocks against key tiles of 128 (D <= 64) or 64 (D = 128) keys, an
    online softmax tile by tile, S = Q.K^T of the bf16 values into f32
    (masked at -1e30), p = exp2(S c - m c) with c = D^-0.5 log2(e), O +=
    P_hi.V + P_lo.V with P_hi = bf16(P) and P_lo = bf16(P - P_hi) into
    f32, l summed from P in f32 and clamped at 1e-30, the output rounded
    to bf16, rows that see no key 0."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group, offs = hq // hkv, skv - sq
    bk = 128 if d <= 64 else 64
    c = (torch.tensor(d ** -0.5, dtype=torch.float32)
         * torch.tensor(1.4426950408889634, dtype=torch.float32))
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((b, hq, sq, d))
    for bi in range(b):
        for h in range(hq):
            for q0 in range(0, sq, 128):
                qb = qf[bi, h, q0:q0 + 128]
                rows = torch.arange(q0, q0 + qb.shape[0])[:, None]
                m = torch.full((qb.shape[0],), -1e30)
                l = torch.zeros(qb.shape[0])
                acc = torch.zeros(qb.shape[0], d)
                end = min(skv, q0 + qb.shape[0] + offs) if causal else skv
                for k0 in range(0, max(end, 0), bk):
                    kt = kf[bi, h // group, k0:k0 + bk]
                    vt = vf[bi, h // group, k0:k0 + bk]
                    s = qb @ kt.T
                    cols = torch.arange(k0, k0 + kt.shape[0])[None, :]
                    if causal:
                        s = s.masked_fill(cols > rows + offs, -1e30)
                    mx = torch.maximum(m, s.amax(dim=1))
                    alpha = torch.exp2((m - mx) * c)
                    m = mx
                    p = torch.exp2(s * c - (m * c)[:, None])
                    l = l * alpha + p.sum(dim=1)
                    hi = p.to(torch.bfloat16).float()
                    lo = (p - hi).to(torch.bfloat16).float()
                    acc = acc * alpha[:, None] + hi @ vt + lo @ vt
                o = acc / l.clamp(min=1e-30)[:, None]
                if causal:
                    o[(rows[:, 0] + offs) < 0] = 0
                out[bi, h, q0:q0 + 128] = o
    return out.to(q.dtype)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", [(1, 4, 2, 512, 512, 64),
                                  (1, 4, 2, 300, 200, 64),
                                  (1, 2, 1, 130, 400, 16),
                                  (1, 2, 2, 200, 333, 128)],
                         ids=["gqa512", "dead_rows", "cached16", "d128"])
def test_flash_split_p_emulation_holds_the_bound(rng, case, causal):
    """The precision scheme that the card's check depends on: the bf16
    kernel's arithmetic (``_split_p_flash``) stays within
    ``chip_smoke.ATTN_BF16_TOL`` of ``flash_attention_plain`` and within
    this file's bf16 bound of the reference's Pallas kernel (interpret
    mode; rows that see no key excepted, where the reference's value
    depends on its blocking)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, *case, dtype="bfloat16")
    got = _split_p_flash(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    torch.testing.assert_close(got, flash_attention_plain(tq, tk, tv,
                                                          causal=causal),
                               **chip_smoke.ATTN_BF16_TOL)
    live = max(0, case[3] - case[4]) if causal else 0
    want = j_flash(jq, jk, jv, causal=causal, bq=128, bk=128)
    np.testing.assert_allclose(_np(got)[:, :, live:],
                               _np(want)[:, :, live:], **BF16)
    if live:
        assert (got[:, :, :live] == 0).all()


def _f32_tile_flash(q, k, v, causal):
    """The arithmetic of the f32 CUDA-core kernel
    (``csrc/attn_kernels.cu::flash_attention_kernel``), emulated in f32
    on the CPU: blocks of ``F32_ROWS`` query rows against key tiles of
    ``f32_tile(D)`` keys, the loop ending at the last tile any row of the
    block sees; S = (q * D^-0.5) K^T, masked at -1e30 only in tiles that
    the causal diagonal or the end of Skv crosses (keys past Skv are left
    out: the kernel's zero-filled, masked keys add nothing to a row that
    sees a key); one online-softmax step a tile in base 2, m' = max(m,
    row max), alpha = 2^((m - m') log2 e), P = 2^(s log2 e - m' log2 e),
    l = l alpha + sum P; O += P.V in the tile's key splits, each split's
    partial sum rescaled by alpha and the partials added at the end;
    o = O / max(l, 1e-30); rows that see no key 0.  Past head dim 384
    (the chunked instance) S accumulates over 128-column chunks of q and
    k in order, as the kernel's FMA chains run through them."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group, offs = hq // hkv, skv - sq
    bq = t_flash_mod.F32_ROWS
    bk, splits = t_flash_mod.f32_tile(d)
    c = torch.tensor(1.4426950408889634, dtype=torch.float32)
    qf = q.float() * torch.tensor(d ** -0.5, dtype=torch.float32)
    kf, vf = k.float(), v.float()
    out = torch.zeros((b, hq, sq, d))
    for bi in range(b):
        for h in range(hq):
            for q0 in range(0, sq, bq):
                qb = qf[bi, h, q0:q0 + bq]
                rows = torch.arange(q0, q0 + qb.shape[0])[:, None]
                m = torch.full((qb.shape[0],), -1e30)
                l = torch.zeros(qb.shape[0])
                acc = torch.zeros(splits, qb.shape[0], d)
                end = min(skv, q0 + bq + offs) if causal else skv
                for k0 in range(0, max(end, 0), bk):
                    kt = kf[bi, h // group, k0:k0 + bk]
                    vt = vf[bi, h // group, k0:k0 + bk]
                    if d > t_flash_mod.HEAD_DIMS[-1]:
                        s = torch.zeros(qb.shape[0], kt.shape[0])
                        for c0 in range(0, d, t_flash_mod.COL_BLOCK):
                            cs = slice(c0, c0 + t_flash_mod.COL_BLOCK)
                            s = s + qb[:, cs] @ kt[:, cs].T
                    else:
                        s = qb @ kt.T
                    if causal and k0 + bk - 1 > q0 + offs:
                        cols = torch.arange(k0, k0 + kt.shape[0])[None, :]
                        s = s.masked_fill(cols > rows + offs, -1e30)
                    mx = torch.maximum(m, s.amax(dim=1))
                    alpha = torch.exp2((m - mx) * c)
                    m = mx
                    p = torch.exp2(s * c - (m * c)[:, None])
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None]
                    half = bk // splits
                    for sp in range(splits):
                        acc[sp] += (p[:, sp * half:(sp + 1) * half]
                                    @ vt[sp * half:(sp + 1) * half])
                o = acc.sum(dim=0) / l.clamp(min=1e-30)[:, None]
                if causal:
                    o[(rows[:, 0] + offs) < 0] = 0
                out[bi, h, q0:q0 + bq] = o
    return out


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", [(1, 4, 2, 512, 512, 64),
                                  (1, 4, 2, 300, 200, 64),
                                  (1, 2, 1, 130, 400, 16),
                                  (1, 2, 2, 200, 333, 128),
                                  (2, 4, 4, 97, 97, 16),
                                  (1, 4, 1, 150, 70, 128),
                                  (1, 4, 1, 100, 90, 256),
                                  (1, 2, 2, 70, 130, 320),
                                  (1, 4, 1, 100, 90, 400),
                                  (1, 2, 2, 70, 130, 512)],
                         ids=["gqa512", "dead_rows", "cached16", "d128",
                              "mha16", "mqa_dead128", "dead256", "d320",
                              "dead400", "d512"])
def test_flash_f32_tile_emulation_holds_the_bound(rng, case, causal):
    """The f32 kernel's arithmetic (``_f32_tile_flash``) stays within
    ``chip_smoke.ATTN_F32_TOL`` of ``flash_attention_plain`` and within
    the reference test's f32 bound of its Pallas kernel (interpret mode;
    rows that see no key excepted, where the reference's value depends
    on its blocking; those rows are 0)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, *case)
    got = _f32_tile_flash(tq, tk, tv, causal)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    torch.testing.assert_close(got, flash_attention_plain(tq, tk, tv,
                                                          causal=causal),
                               **chip_smoke.ATTN_F32_TOL)
    live = max(0, case[3] - case[4]) if causal else 0
    want = j_flash(jq, jk, jv, causal=causal, bq=128, bk=128)
    np.testing.assert_allclose(_np(got)[:, :, live:],
                               _np(want)[:, :, live:], **F32)
    if live:
        assert (got[:, :, :live] == 0).all()


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("skv", [17, 64, 100, 257])
def test_decode_plain_matches_reference_kernel(rng, skv, group):
    b, hkv, d = 2, 2, 32
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, b, hkv * group, hkv, 1, skv, d)
    want = j_decode(jq, jk, jv, bk=16)
    got = flash_decode(tq, tk, tv, bk=16)
    assert got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(flash_decode_plain(tq, tk, tv)),
                               _np(want), **F32)


def _split_kv_decode(q, k, v, splits_asked):
    """The split-KV decode kernel's arithmetic (``csrc/attn_kernels.cu``),
    emulated on the CPU: per (b, kv head) the keys cut into splits of
    whole stages (``split_chunk``); in each split every warp folds its
    share of each stage's keys (``keys_per_warp``) into its own online
    softmax (m, l, acc) of the group's rows, masked keys left out; the
    warps merge in ascending order into the split's partial, and the
    splits merge in ascending order, o = sum e_s acc_s / max(sum e_s l_s,
    1e-30), e_s = exp(m_s - max m), rounded once to q's dtype."""
    b, hq, _, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    kpw = t_decode_mod.keys_per_warp(d, q.element_size())
    tile = t_decode_mod.WARPS * kpw
    chunk, splits = t_decode_mod.split_chunk(skv, splits_asked, tile)
    assert (splits - 1) * chunk < skv <= splits * chunk   # none is empty
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    qf = q.float().reshape(b, hkv, group, d) * scale
    kf, vf = k.float(), v.float()
    out = torch.empty((b, hkv, group, d))

    def merge(states):
        mx = torch.stack([m for m, _, _ in states]).amax(dim=0)
        f = [torch.exp(m - mx) for m, _, _ in states]
        acc = sum(fi[:, None] * a for fi, (_, _, a) in zip(f, states))
        return mx, sum(fi * l for fi, (_, l, _) in zip(f, states)), acc

    for bi in range(b):
        for h in range(hkv):
            parts = []
            for s in range(splits):
                k0, k1 = s * chunk, min(s * chunk + chunk, skv)
                warps = []
                for w in range(t_decode_mod.WARPS):
                    m = torch.full((group,), -1e30)
                    l, acc = torch.zeros(group), torch.zeros(group, d)
                    for t0 in range(k0, k1, tile):
                        lo = t0 + w * kpw
                        hi = min(lo + kpw, k1)
                        sc = qf[bi, h] @ kf[bi, h, lo:hi].T   # (group, n)
                        tmax = (sc.amax(dim=1) if hi > lo
                                else torch.full((group,), -1e30))
                        m_new = torch.maximum(m, tmax)
                        alpha = torch.exp(m - m_new)
                        m = m_new
                        p = torch.exp(sc - m[:, None])
                        l = l * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None] + p @ vf[bi, h, lo:hi]
                    warps.append((m, l, acc))
                parts.append(merge(warps))
            _, l, acc = merge(parts)
            out[bi, h] = acc / l.clamp(min=1e-30)[:, None]
    return out.reshape(b, hq, 1, d).to(q.dtype)


# (Skv, GQA group, head dim): a single key, lengths no multiple of a
# stage, a long cache; groups 1, 4 and 8; the three stage widths
DECODE_SPLIT_CASES = [(1, 1, 32), (17, 4, 32), (17, 8, 64), (257, 8, 32),
                      (257, 4, 128), (4097, 4, 64), (4097, 1, 128),
                      (4097, 8, 32), (257, 4, 512), (97, 2, 640)]


@pytest.mark.parametrize("skv,group,d", DECODE_SPLIT_CASES,
                         ids=[f"skv{c[0]}-g{c[1]}-d{c[2]}"
                              for c in DECODE_SPLIT_CASES])
def test_decode_split_kv_emulation_holds_the_bound(rng, skv, group, d):
    """The split-KV decomposition of the decode kernel
    (``_split_kv_decode``), at one split, a few (a short last chunk),
    and more splits asked than there are keys, stays within
    ``chip_smoke``'s tolerances of ``flash_decode_plain`` and within this
    file's bounds of the reference's Pallas kernel (interpret mode)."""
    hkv = 2
    for dtype, tol, ref_tol in (("float32", chip_smoke.ATTN_F32_TOL, F32),
                                ("bfloat16", chip_smoke.ATTN_BF16_TOL,
                                 BF16)):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, hkv * group, hkv, 1,
                                            skv, d, dtype=dtype)
        plain = flash_decode_plain(tq, tk, tv)
        want = _np(j_decode(jq, jk, jv, bk=min(1024, skv)))
        for splits in (1, 2, 3, 7, skv + 5):
            got = _split_kv_decode(tq, tk, tv, splits)
            assert got.dtype == tq.dtype and got.shape == tq.shape
            torch.testing.assert_close(got, plain, **tol)
            np.testing.assert_allclose(_np(got), want, **ref_tol)


def test_decode_bf16_matches_reference_kernel(rng):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 8, 2, 1, 100, 64,
                                        dtype="bfloat16")
    want = j_decode(jq, jk, jv, bk=32)
    got = flash_decode(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", CASES + [(1, 4, 2, 24, 12, 16)],
                         ids=CASE_IDS + ["dead_rows"])
def test_oracle_matches_reference_oracle(rng, case, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, *case)
    np.testing.assert_allclose(_np(attention_ref(tq, tk, tv, causal=causal)),
                               _np(j_ref(jq, jk, jv, causal=causal)),
                               equal_nan=True, **F32)
    np.testing.assert_allclose(_np(decode_attention_ref(tq[:, :, :1], tk,
                                                        tv)),
                               _np(j_ref(jq[:, :, :1], jk, jv,
                                         causal=False)), **F32)


def test_rows_that_see_no_key(rng):
    """Causal with Sq > Skv: rows i < Sq - Skv see no key.  The reference
    oracle gives NaN.  Its Pallas kernel gives a value that depends on
    bq/bk: 0 where the row's whole q block is skipped (l clamped), else
    the mean of the v rows of the blocks that ran, padded rows counted.
    The port's kernel and plain version give 0.  Every other row agrees
    with the Pallas kernel at any blocking."""
    b, hq, hkv, sq, skv, d = 1, 2, 1, 40, 12, 16
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, b, hq, hkv, sq, skv, d)
    dead = sq - skv                                      # rows 0-27
    v = _np(jv)[0, 0]
    ref = _np(j_ref(jq, jk, jv, causal=True))
    assert np.isnan(ref[:, :, :dead]).all()
    assert not np.isnan(ref[:, :, dead:]).any()
    # bq=16, bk=8: q block 0 (rows 0-15) sees no key of any kv block and
    # skips them all -> 0; q block 1 (rows 16-31) runs kv block 0 (keys
    # 0-7), so its dead rows 16-27 get the mean of v rows 0-7
    small = _np(j_flash(jq, jk, jv, causal=True, bq=16, bk=8))
    assert (small[:, :, :16] == 0).all()
    np.testing.assert_allclose(
        small[0, :, 16:dead],
        np.broadcast_to(v[:8].mean(axis=0), (hq, dead - 16, d)), **F32)
    # bq=40: one q block runs both kv blocks, the second padded with 4
    # zero rows: every dead row gets sum(v) / 16
    big = _np(j_flash(jq, jk, jv, causal=True, bq=64, bk=8))
    np.testing.assert_allclose(
        big[0, :, :dead],
        np.broadcast_to(v.sum(axis=0) / 16, (hq, dead, d)), **F32)
    got = _np(flash_attention(tq, tk, tv, causal=True))
    assert (got[:, :, :dead] == 0).all()
    for want in (small, big, ref):
        np.testing.assert_allclose(got[:, :, dead:], want[:, :, dead:],
                                   **F32)


def test_named_errors(rng):
    q = torch.zeros(1, 6, 8, 16)
    k = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_decode(q[:, :, :1], k, k)
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="single-token"):
        flash_decode(q, k, k)
    with pytest.raises(ValueError, match="bq must be >= 1"):
        flash_attention(q, k, k, bq=0)
    with pytest.raises(ValueError, match="bk must be >= 1"):
        flash_decode(q[:, :, :1], k, k, bk=0)
    with pytest.raises(ValueError, match="differ in batch or head dim"):
        flash_attention(q, torch.zeros(1, 4, 8, 32), torch.zeros(1, 4, 8, 32))


# --------------------------------------------------------------------------
# head dims the kernels are not built for: zero-padded on the host
# --------------------------------------------------------------------------
def test_padded_head_dim_is_the_next_kernel_width():
    for d in range(1, t_flash_mod.HEAD_DIMS[-1] + 1):
        want = min(w for w in t_flash_mod.HEAD_DIMS if w >= d)
        assert t_flash_mod.padded_head_dim(d) == want, d
    # past the widest instance: the next multiple of COL_BLOCK (the
    # chunked instances), with no upper limit
    for d in range(t_flash_mod.HEAD_DIMS[-1] + 1, 2100):
        want = -(-d // t_flash_mod.COL_BLOCK) * t_flash_mod.COL_BLOCK
        assert t_flash_mod.padded_head_dim(d) == want, d
    assert t_flash_mod.padded_head_dim(100_000) == 100_096
    for d in t_flash_mod.HEAD_DIMS:
        q = torch.zeros(1, 2, 3, d)
        got = t_flash_mod.pad_head_dim(q, q, q)
        assert all(a is q for a in got[:3]) and got[3] == d


@pytest.mark.parametrize("d", [8, 12, 80, 144, 192, 256, 320])
def test_padded_operands_compute_the_same_function(rng, d):
    """What the wrappers launch on the card, run through the plain
    versions: operands zero-padded along D, scaled by the original
    D^-0.5, the output sliced back to D."""
    (_, tq), (_, tk), (_, tv) = _qkv(rng, 2, 8, 2, 40, 56, d)
    qp, kp, vp, d0 = t_flash_mod.pad_head_dim(tq, tk, tv)
    dp = t_flash_mod.padded_head_dim(d)
    assert d0 == d and qp.shape[3] == kp.shape[3] == vp.shape[3] == dp
    assert torch.equal(qp[..., :d], tq) and not qp[..., d:].any()
    for causal in (True, False):
        got = attention_ref(qp, kp, vp, causal=causal, scale=d ** -0.5)
        assert not got[..., d:].any()
        np.testing.assert_allclose(
            _np(got[..., :d]), _np(flash_attention_plain(tq, tk, tv,
                                                         causal=causal)),
            rtol=0, atol=1e-6)
    got = decode_attention_ref(qp[:, :, :1], kp, vp, scale=d ** -0.5)
    np.testing.assert_allclose(_np(got[..., :d]),
                               _np(flash_decode_plain(tq[:, :, :1], tk, tv)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("d", [400, 512, 640])
def test_padded_operands_past_384_compute_the_same_function(rng, d):
    """The chunked instances' operands (D zero-padded to a multiple of
    128, the original D's scale, the output sliced back) through the
    plain versions: the same function within rtol=1e-5, atol=1e-5 (the
    f32 sums run over 400-640 terms, so a padded product's rounding
    moves by a few ulps more than at the widths below 384)."""
    (_, tq), (_, tk), (_, tv) = _qkv(rng, 2, 8, 2, 40, 56, d)
    qp, kp, vp, d0 = t_flash_mod.pad_head_dim(tq, tk, tv)
    assert d0 == d and qp.shape[3] == t_flash_mod.padded_head_dim(d)
    assert qp.shape[3] % t_flash_mod.COL_BLOCK == 0
    assert torch.equal(qp[..., :d], tq) and not qp[..., d:].any()
    for causal in (True, False):
        got = attention_ref(qp, kp, vp, causal=causal, scale=d ** -0.5)
        assert not got[..., d:].any()
        np.testing.assert_allclose(
            _np(got[..., :d]), _np(flash_attention_plain(tq, tk, tv,
                                                         causal=causal)),
            rtol=1e-5, atol=1e-5)
    got = decode_attention_ref(qp[:, :, :1], kp, vp, scale=d ** -0.5)
    np.testing.assert_allclose(_np(got[..., :d]),
                               _np(flash_decode_plain(tq[:, :, :1], tk, tv)),
                               rtol=1e-5, atol=1e-5)


def test_head_dim_past_the_kernels_is_refused():
    """No head dim is refused any more: past 384 the operands pad to the
    next multiple of 128 (D 400 to 512) for the chunked instances."""
    assert t_flash_mod.padded_head_dim(385) == 512
    q = torch.ones(1, 2, 1, 400)
    qp, kp, vp, d0 = t_flash_mod.pad_head_dim(q, q, q)
    assert d0 == 400 and qp.shape[3] == kp.shape[3] == vp.shape[3] == 512
    assert torch.equal(qp[..., :400], q) and not qp[..., 400:].any()
    k = torch.ones(1, 2, 3, 400)
    assert flash_attention(q, k, k).shape == q.shape
    assert flash_decode(q, k, k).shape == q.shape


@pytest.mark.parametrize("d, width", [(129, 256), (144, 256), (192, 256),
                                      (256, 256), (257, 384), (320, 384),
                                      (384, 384), (385, 512), (400, 512),
                                      (512, 512), (640, 640),
                                      (1000, 1024)])
def test_head_dims_past_128_pad_to_whole_column_blocks(d, width):
    """Past 128 the kernels take whole 128-wide column blocks of O: the
    padded width is the next multiple of ``COL_BLOCK`` among the kernel
    widths, and ``f32_tile`` gives the f32 kernel's keys a tile."""
    assert t_flash_mod.padded_head_dim(d) == width
    assert width % t_flash_mod.COL_BLOCK == 0
    q = torch.ones(1, 2, 3, d)
    qp, kp, vp, d0 = t_flash_mod.pad_head_dim(q, q, q)
    assert d0 == d and qp.shape[3] == width
    assert torch.equal(qp[..., :d], q) and not qp[..., d:].any()
    assert t_flash_mod.f32_tile(width) == ((16, 1) if width == 384
                                          else (32, 1))


@pytest.mark.parametrize("d", [8, 80, 144, 192, 256, 320, 400, 512, 640])
def test_any_head_dim_matches_reference_kernels(rng, d):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 8, 2, 48, 64, d)
    for causal in (True, False):
        want = j_flash(jq, jk, jv, causal=causal, bq=16, bk=16)
        got = flash_attention(tq, tk, tv, causal=causal, bq=16, bk=16)
        assert got.shape == tq.shape
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    want = j_decode(jq[:, :, :1], jk, jv, bk=16)
    got = flash_decode(tq[:, :, :1], tk, tv, bk=16)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_attention_budget_plans_small_head_dim(rng):
    """The input the planners route to the flash and decode kernels at
    head dim 8 (the smoke configs' ``head_dim``): planned onto
    ``attn_flash`` / ``attn_decode`` by both packages, and computed."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 4, 2, 64, 64, 8)
    for q, member in ((tq, "attn_flash"), (tq[:, :, :1], "attn_decode")):
        spec = TSpec.make("attention", "attention", (q.shape, tk.shape),
                          q.dtype)
        jspec = JSpec.make("attention", "attention",
                           (tuple(q.shape), tuple(tk.shape)), jnp.float32)
        assert t_plan.plan_single(spec, TBudget()).ip.name.endswith(member)
        assert j_plan.plan_single(jspec, JBudget()).ip.name.endswith(member)
        got = attention(q, tk, tv, causal=True, budget=TBudget())
        want = j_ref(jnp.asarray(q.numpy()), jk, jv,
                     causal=member == "attn_flash")
        np.testing.assert_allclose(_np(got), _np(want), **F32)


# --------------------------------------------------------------------------
# the op wrapper: ip= and budget= routing
# --------------------------------------------------------------------------
def test_attention_routes_ip(rng):
    (_, tq), (_, tk), (_, tv) = _qkv(rng, 1, 8, 2, 24, 40, 16)
    for causal in (True, False):
        want = flash_attention_plain(tq, tk, tv, causal=causal)
        for ip in ("attn_flash", "attention.attn_flash"):
            assert torch.equal(attention(tq, tk, tv, causal=causal, ip=ip),
                               want)
        assert torch.equal(attention(tq, tk, tv, causal=causal,
                                     ip="attn_naive"),
                           attention_ref(tq, tk, tv, causal=causal))
    tq1 = tq[:, :, :1]
    assert torch.equal(attention(tq1, tk, tv, ip="attn_decode"),
                       flash_decode_plain(tq1, tk, tv))
    with pytest.raises(KeyError, match="not an attention IP"):
        attention(tq, tk, tv, ip="attn_paged")


@pytest.mark.parametrize("shape", [((1, 4, 16, 16), (1, 2, 16, 16)),
                                   ((2, 8, 1, 32), (2, 2, 300, 32)),
                                   ((8, 32, 4096, 64), (8, 8, 4096, 64)),
                                   ((4, 8, 2048, 64), (4, 2, 2048, 64))],
                         ids=["tiny", "decode", "train4k", "prefill2k"])
@pytest.mark.parametrize("budget", [{}, dict(vmem_bytes=1 << 20),
                                    dict(mxu_available=False)],
                         ids=["ample", "vmem_1MiB", "no_mxu"])
def test_attention_budget_plans_as_reference(shape, budget):
    """``attention(budget=)`` plans the reference's member (or raises its
    error) at small and full shapes; the small ones are also executed."""
    qs, kvs = shape
    j_plan.clear_plan_cache()
    t_plan.clear_plan_cache()
    js = JSpec.make("attention", "attention", shape, "bfloat16")
    ts = TSpec.make("attention", "attention", shape, torch.bfloat16)
    try:
        want = j_plan.plan_single(js, JBudget(**budget)).ip.name
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_plan.plan_single(ts, TBudget(**budget))
        assert str(got.value) == str(e)
        assert "no feasible IP" in str(e)
        if qs[2] < 4096:
            with pytest.raises(ValueError, match="no feasible IP"):
                attention(torch.zeros(qs), torch.zeros(kvs),
                          torch.zeros(kvs), budget=TBudget(**budget))
        return
    assert t_plan.plan_single(ts, TBudget(**budget)).ip.name == want
    if qs[2] < 4096:
        rng = np.random.default_rng(1)
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   for s in (qs, kvs, kvs))
        got = attention(q, k, v, budget=TBudget(**budget))
        assert torch.equal(got, attention(q, k, v, ip=want))


# --------------------------------------------------------------------------
# registration and selection
# --------------------------------------------------------------------------
def test_library_registers_attention_as_the_reference_does():
    assert list(t_library.FAMILIES) == list(j_library.FAMILIES)
    assert t_library.get_family("attention") is t_library.ATTENTION
    assert t_library.ATTENTION.quantizable is False
    assert j_library.ATTENTION.names() == t_library.ATTENTION.names()
    for name in j_library.ATTENTION.names():
        t_ip, j_ip = t_library.ATTENTION[name], j_library.ATTENTION[name]
        for field in ("name", "family", "uses_mxu", "max_operand_bits",
                      "outputs_per_pass", "supports_dtypes", "tags",
                      "description"):
            assert getattr(t_ip, field) == getattr(j_ip, field), field
    assert t_library.get_ip("attention.attn_naive").impl is attention_ref
    assert t_library.get_ip("attention.attn_flash").impl is flash_attention
    assert t_library.get_ip("attention.attn_decode").impl is flash_decode
    assert t_library.get_family("ssm_scan") is t_library.SSM_SCAN
    with pytest.raises(KeyError):
        t_library.get_family("rwkv_scan")


@pytest.mark.parametrize("args", [(8, 32, 8, 4096, 4096, 64),
                                  (1, 4, 2, 60, 60, 16),
                                  (2, 8, 2, 48, 96, 32),
                                  (4, 32, 8, 1000, 1000, 128)],
                         ids=["train4k", "small", "cross", "d128"])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_footprints_match_reference(args, itemsize):
    for name in ("attn_naive", "attn_flash"):
        got = t_library.ATTENTION[name].footprint(*args, itemsize=itemsize)
        want = j_library.ATTENTION[name].footprint(*args, itemsize=itemsize)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    b, hq, hkv, _, skv, d = args
    for dec in ((b, hq, hkv, skv, d), (128, 32, 8, 32768, 64)):
        got = t_library.ATTENTION["attn_decode"].footprint(*dec,
                                                           itemsize=itemsize)
        want = j_library.ATTENTION["attn_decode"].footprint(*dec,
                                                            itemsize=itemsize)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(t_flash_mod.footprint(*args, causal=False)) \
        == dataclasses.asdict(j_library.ATTENTION["attn_flash"].footprint(
            *args, causal=False))


@pytest.mark.parametrize("budget", [{}, dict(mxu_available=False),
                                    dict(vmem_bytes=4 << 20),
                                    dict(precision_bits=8)],
                         ids=["ample", "no_mxu", "vmem_4MiB", "int8"])
def test_select_attention_ip_matches_reference(budget):
    for qs, kvs in (((8, 32, 4096, 64), (8, 8, 4096, 64)),
                    ((128, 32, 1, 64), (128, 8, 32768, 64)),
                    ((1, 4, 32, 16), (1, 4, 32, 16))):
        try:
            want = j_sel.select_attention_ip(qs, kvs,
                                             budget=JBudget(**budget),
                                             with_footprint=True)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                t_sel.select_attention_ip(qs, kvs, budget=TBudget(**budget))
            assert str(got.value) == str(e)
            continue
        ip, fp = t_sel.select_attention_ip(qs, kvs, budget=TBudget(**budget),
                                           with_footprint=True)
        assert ip.name == want[0].name
        assert dataclasses.asdict(fp) == dataclasses.asdict(want[1])


# --------------------------------------------------------------------------
# the budget sweep's LM sites: the reference's examples/budget_sweep.py
# against chip_smoke.py's copy, at Llama-3.2-1B's widths
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sweep():
    mod = _load("budget_sweep", ROOT / "examples" / "budget_sweep.py")
    from repro.configs import get_config
    return mod, get_config("llama3.2-1b")


def test_chip_smoke_uses_the_sweep_budgets_and_widths(sweep):
    mod, cfg = sweep
    assert list(chip_smoke.LM_BUDGETS) == list(mod.BUDGETS)
    for name, kw in chip_smoke.LM_BUDGETS.items():
        assert dataclasses.asdict(TBudget(**kw)) == \
            dataclasses.asdict(mod.BUDGETS[name])
    llama = chip_smoke.LLAMA
    assert (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim) == (llama["d_model"], llama["d_ff"],
                              llama["n_heads"], llama["n_kv_heads"],
                              llama["head_dim"])


@pytest.mark.parametrize("budget", list(chip_smoke.LM_BUDGETS))
def test_lm_sweep_plan_json_byte_equal(sweep, budget):
    mod, cfg = sweep
    jb = mod.BUDGETS[budget]
    tb = TBudget(**chip_smoke.LM_BUDGETS[budget])
    jspecs, tspecs = mod.lm_network_specs(cfg, jb), \
        chip_smoke.lm_network_specs(tb)
    assert [s.to_dict() for s in tspecs] == [s.to_dict() for s in jspecs]
    j_plan.clear_plan_cache()
    t_plan.clear_plan_cache()
    try:
        want = j_plan.plan_network(jspecs, jb)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_plan.plan_network(tspecs, tb)
        assert str(got.value) == str(e)
        for js, ts in zip(jspecs, tspecs):
            try:
                w = j_plan.select_ip(js.family, js, budget=jb).name
            except ValueError as e2:
                with pytest.raises(ValueError) as g2:
                    t_plan.select_ip(ts.family, ts, budget=tb)
                assert str(g2.value) == str(e2)
                continue
            assert t_plan.select_ip(ts.family, ts, budget=tb).name == w
        return
    got = t_plan.plan_network(tspecs, tb)
    assert got.to_json() == want.to_json()
    assert got.describe() == want.describe()


def test_lm_sweep_table_is_the_reference_table(sweep):
    """chip_smoke.py's LM_TABLE (the table it holds the card's plan to)
    is what the reference's sweep plans."""
    mod, cfg = sweep
    j_plan.clear_plan_cache()
    want = {}
    for name, b in mod.BUDGETS.items():
        specs = mod.lm_network_specs(cfg, b)
        try:
            plan = j_plan.plan_network(specs, b)
            want[name] = tuple(mod._cell(plan.site(s.name)) for s in specs)
        except ValueError:
            cells = []
            for s in specs:
                try:
                    cells.append(j_plan.select_ip(s.family, s, budget=b)
                                 .name.split(".")[-1] + "!")
                except ValueError:
                    cells.append("infeasible")
            want[name] = tuple(cells)
    assert want == chip_smoke.LM_TABLE
    t_plan.clear_plan_cache()
    table, sites_of = chip_smoke.plan_lm_sweep()
    assert table == chip_smoke.LM_TABLE
    runs = chip_smoke.lm_site_runs(sites_of)
    assert len(runs) == 9
    assert {m for _, m, _, _ in runs} == set(chip_smoke.MEMBER_KERNEL)
    assert ("ffn", "mm_vpu", 8, True) in runs
    assert ("ffn", "mm_vpu", 16, False) in runs


# the sweep's sites cut to small widths: (site) -> shapes
SMALL_SITES = {"conv3x3": ((2, 10, 10, 4), (3, 3, 4, 8)),
               "ffn": ((16, 32), (32, 24)),
               "attn_train4k": ((1, 4, 32, 16), (1, 2, 32, 16)),
               "attn_decode32k": ((2, 4, 1, 16), (2, 2, 40, 16))}


def _site_call(pkg, site, member, bits, lowered, ops):
    """One planned site of the sweep through ``pkg``'s op wrappers (the
    calls chip_smoke.py makes on the card)."""
    if site == "conv3x3":
        mod = pkg["conv2d"]
        if member == "ip3_packed":
            return mod.conv2d_dual(ops[0], ops[1], ops[2], ip=member)
        return mod.conv2d(ops[0], ops[2], ip=member)
    if site == "ffn" and lowered:
        return pkg["quant"].quantized_matmul(ops[0], ops[2], bits=bits,
                                             ip=member)
    if site == "ffn":
        if member == "mm_dual_shared":
            return pkg["matmul"].matmul_dual(*ops, ip=member)
        return pkg["matmul"].matmul(ops[0], ops[2], ip=member)
    return pkg["attention"].attention(*ops, ip=member)


@pytest.mark.parametrize(
    "run", [("conv3x3", "ip1_vpu", 8, False), ("ffn", "mm_mxu", 16, False),
            ("attn_train4k", "attn_flash", 16, False),
            ("attn_decode32k", "attn_decode", 16, False),
            ("ffn", "mm_vpu", 16, False), ("ffn", "mm_vpu", 8, True),
            ("conv3x3", "ip3_packed", 8, False),
            ("ffn", "mm_dual_shared", 8, False), ("ffn", "mm_mxu", 8, False)],
    ids=lambda r: f"{r[0]}-{r[1]}@{r[2]}{'lowered' if r[3] else ''}")
def test_lm_sites_run_as_reference(rng, run):
    """Every distinct planned site of the sweep's table (the chip run's
    list) at small widths: the port's wrappers against the reference's,
    on the site's operand dtype; integers bit-exact."""
    import repro.kernels.attention.ops as j_attn_ops
    import repro.kernels.conv2d.ops as j_conv_ops
    import repro.kernels.matmul.ops as j_mm_ops
    import repro.quant.ops as j_q_ops
    import repro_torch.kernels.attention.ops as t_attn_ops
    import repro_torch.kernels.conv2d.ops as t_conv_ops
    import repro_torch.kernels.matmul.ops as t_mm_ops
    import repro_torch.quant.ops as t_q_ops
    site, member, bits, lowered = run
    t_plan.clear_plan_cache()
    _, sites_of = chip_smoke.plan_lm_sweep()
    assert run in chip_smoke.lm_site_runs(sites_of)
    a, b = SMALL_SITES[site]
    shapes = (a, a, b) if site in ("conv3x3", "ffn") else (a, b, b)
    if bits == 8 and not lowered:
        arrs = [rng.integers(-128, 128, s, dtype=np.int8) for s in shapes]
        j_ops = [jnp.asarray(x) for x in arrs]
        t_ops = [torch.from_numpy(x) for x in arrs]
    else:
        pairs = [_both(rng.normal(size=s).astype(np.float32), "bfloat16")
                 for s in shapes]
        j_ops, t_ops = [p[0] for p in pairs], [p[1] for p in pairs]
    want = _site_call({"conv2d": j_conv_ops, "matmul": j_mm_ops,
                       "quant": j_q_ops, "attention": j_attn_ops},
                      site, member, bits, lowered, j_ops)
    got = _site_call({"conv2d": t_conv_ops, "matmul": t_mm_ops,
                      "quant": t_q_ops, "attention": t_attn_ops},
                     site, member, bits, lowered, t_ops)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        if bits == 8 and not lowered:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        elif site.startswith("attn"):
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(g), _np(w), **BF16)
        else:
            assert g.dtype == torch.float32
            np.testing.assert_allclose(_np(g), _np(w), rtol=2e-4, atol=1e-5)
