"""The port's matmul family (``repro_torch.kernels.matmul``, its library
registration, ``quantized_matmul`` and ``int8_matmul(use_kernel=True)``)
against the reference (``repro``; Pallas in interpret mode on CPU).

On a CPU tensor each port wrapper runs its plain PyTorch version (the
family oracle), the function the CUDA kernels are checked against on the
card by ``chip_smoke.py``.  Inputs are made with numpy from a seed.

Tolerances: int8 products bit-exact (int32 sums); float32 and bfloat16
within ``rtol=2e-4, atol=1e-5`` at K <= 130 (the reference's own
``test_mm_mxu_float`` tolerance; the two packages sum in other orders);
the 8-bit quantized path bit-exact (the same codes, an exact int32
accumulator and the same f32 rescale); plan JSON byte-equal.
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as j_plan
from repro.core.ip import SiteSpec as JSpec
from repro.core.resources import ResourceBudget as JBudget
from repro.kernels.matmul import dual as j_dual
from repro.kernels.matmul import mxu as j_mxu
from repro.kernels.matmul.ops import matmul as j_matmul
from repro.kernels.matmul.ops import matmul_dual as j_matmul_dual
from repro.kernels.matmul.ref import matmul_ref as j_ref
from repro.quant import ops as j_qops
from repro.quant import quantize as j_q
from repro_torch.core import library as t_library
from repro_torch.core import plan as t_plan
from repro_torch.core.ip import SiteSpec as TSpec
from repro_torch.core.resources import ResourceBudget as TBudget
from repro_torch.kernels.matmul import dual as t_dual
from repro_torch.kernels.matmul import mxu as t_mxu
from repro_torch.kernels.matmul.ops import matmul as t_matmul
from repro_torch.kernels.matmul.ops import matmul_dual as t_matmul_dual
from repro_torch.kernels.matmul.ref import matmul_dual_ref as t_dual_ref
from repro_torch.kernels.matmul.ref import matmul_ref as t_ref
from repro_torch.quant import ops as t_qops
from repro_torch.quant import quantize as t_q

FLOAT = dict(rtol=2e-4, atol=1e-5)

# the reference's tests/test_kernels_matmul.py::{SHAPES, TILES}: (M, K, N)
SHAPES = [(8, 8, 8), (64, 96, 48), (100, 130, 70), (33, 17, 5),
          (256, 512, 128)]
SHAPE_IDS = ["8x8x8", "64x96x48", "100x130x70", "33x17x5", "256x512x128"]
TILES = [dict(bm=32, bn=32, bk=32), dict(bm=128, bn=128, bk=128)]
TILE_IDS = ["t32", "t128"]


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a, copy=True))


def _int8(rng, shape):
    return _both(rng.integers(-128, 128, shape, dtype=np.int8))


def _normal(rng, shape):
    return _both(rng.normal(size=shape).astype(np.float32))


def _exact(got, want):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# mm_mxu / mm_vpu against the reference's kernels
# --------------------------------------------------------------------------
@pytest.mark.parametrize("tiles", TILES, ids=TILE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mm_mxu_int8_bit_exact(rng, shape, tiles):
    m, k, n = shape
    (ja, ta), (jb, tb) = _int8(rng, (m, k)), _int8(rng, (k, n))
    _exact(t_matmul(ta, tb, ip="mm_mxu", **tiles),
           j_matmul(ja, jb, ip="mm_mxu", **tiles))


@pytest.mark.parametrize("tiles", TILES, ids=TILE_IDS)
@pytest.mark.parametrize("shape", SHAPES[:3], ids=SHAPE_IDS[:3])
def test_mm_vpu_int8_bit_exact(rng, shape, tiles):
    m, k, n = shape
    (ja, ta), (jb, tb) = _int8(rng, (m, k)), _int8(rng, (k, n))
    tv = dict(bm=tiles["bm"], bn=tiles["bn"])
    _exact(t_matmul(ta, tb, ip="mm_vpu", **tv),
           j_matmul(ja, jb, ip="mm_vpu", **tv))


@pytest.mark.parametrize("ip", ["mm_mxu", "mm_vpu"])
@pytest.mark.parametrize("shape", SHAPES[:4], ids=SHAPE_IDS[:4])
def test_float32_matches(rng, shape, ip):
    m, k, n = shape
    (ja, ta), (jb, tb) = _normal(rng, (m, k)), _normal(rng, (k, n))
    tiles = dict(bm=32, bn=32, bk=32) if ip == "mm_mxu" else dict(bm=32,
                                                                  bn=32)
    got = t_matmul(ta, tb, ip=ip, **tiles)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_matmul(ja, jb, ip=ip, **tiles)),
                               **FLOAT)


@pytest.mark.parametrize("shape", SHAPES[:3], ids=SHAPE_IDS[:3])
def test_mm_mxu_bfloat16_matches(rng, shape):
    """bf16 operands, f32 accumulator: the products are exact in f32."""
    m, k, n = shape
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    got = t_mxu.mm_mxu(torch.from_numpy(a).bfloat16(),
                       torch.from_numpy(b).bfloat16(), bm=32, bn=32, bk=32)
    want = j_mxu.mm_mxu(jnp.asarray(a).astype(jnp.bfloat16),
                        jnp.asarray(b).astype(jnp.bfloat16), bm=32, bn=32,
                        bk=32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOAT)


def test_mm_mxu_out_dtype_and_refs(rng):
    (ja, ta), (jb, tb) = _int8(rng, (33, 17)), _int8(rng, (17, 5))
    got = t_mxu.mm_mxu(ta, tb, out_dtype=torch.float32)
    want = j_mxu.mm_mxu(ja, jb, out_dtype=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _exact(t_ref(ta, tb), j_ref(ja, jb))
    for g in t_dual_ref(ta, ta, tb):
        _exact(g, j_ref(ja, jb))


def test_results_do_not_depend_on_tile_hints(rng):
    (_, ta), (_, tb) = _normal(rng, (40, 70)), _normal(rng, (70, 30))
    base = t_mxu.mm_mxu(ta, tb)
    for tiles in TILES + [dict(bm=1, bn=7, bk=3)]:
        assert torch.equal(t_mxu.mm_mxu(ta, tb, **tiles), base)
    assert torch.equal(t_mxu.mm_vpu(ta, tb, bm=3, bn=5), base)


def test_matmul_named_errors(rng):
    (_, ta), (_, tb) = _normal(rng, (4, 6)), _normal(rng, (6, 3))
    with pytest.raises(KeyError, match="not a single-stream matmul IP"):
        t_matmul(ta, tb, ip="mm_magic")
    with pytest.raises(ValueError, match=r"\(M, K\) x \(K, N\)"):
        t_matmul(ta, ta, ip="mm_mxu")
    with pytest.raises(ValueError, match="bk must be >= 1"):
        t_mxu.mm_mxu(ta, tb, bk=0)
    with pytest.raises(ValueError, match="bm must be >= 1"):
        t_mxu.mm_vpu(ta, tb, bm=0)


# --------------------------------------------------------------------------
# the tensor-core route (int8/bf16 MXU members): its layout step and the
# entry point chosen per dtype; the kernels themselves run in chip_smoke.py
# --------------------------------------------------------------------------
PAD_SHAPES = [(300, 1000, 520), (1, 17, 3), (0, 16, 8), (64, 96, 48),
              (5, 0, 7)]
PAD_IDS = ["300x1000x520", "1x17x3", "0x16x8", "64x96x48", "5x0x7"]


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("shape", PAD_SHAPES, ids=PAD_IDS)
def test_pad_tc_operands_then_crop_equals_unpadded(rng, shape, dtype):
    """K and b's row stride padded to 16 bytes with zeros (the layout
    step of the tensor-core route and of the cp.async-staged CUDA-core
    kernels, f32 ``mm_mxu`` and ``mm_vpu``); a plain product of the
    padded operands cropped to (M, N) equals the unpadded one: exactly
    for int8, and for bf16 and f32 (f32 products) within ``rtol=1e-5,
    atol=1e-6``, since the CPU BLAS may block the padded shape
    differently."""
    m, k, n = shape
    if dtype == "int8":
        a1, a2, b = (_int8(rng, s)[1] for s in ((m, k), (m, k), (k, n)))
    else:
        a1, a2, b = (_normal(rng, s)[1].to(getattr(torch, dtype))
                     for s in ((m, k), (m, k), (k, n)))
    align = 16 // b.element_size()
    kp, np_ = -(-k // align) * align, -(-n // align) * align
    (p1, p2), pb = t_mxu.pad_tc_operands((a1, a2), b)
    assert p1.shape == p2.shape == (m, kp) and pb.shape == (kp, np_)
    assert all(t.dtype == b.dtype and t.is_contiguous()
               and t.data_ptr() % 16 == 0 for t in (p1, p2, pb))
    assert torch.equal(pb[:k, :n], b) and not pb[k:].any() \
        and not pb[:, n:].any()
    for a, p in ((a1, p1), (a2, p2)):
        assert torch.equal(p[:, :k], a) and not p[:, k:].any()
        got, want = t_ref(p, pb)[:, :n], t_ref(a, b)
        assert got.shape == want.shape == (m, n)
        if dtype == "int8":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # aligned operands pass through as they are: no copy
    (q1,), qb = t_mxu.pad_tc_operands((p1,), pb)
    assert q1 is p1 and qb is pb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", [(300, 1000, 520), (1, 17, 3),
                                   (130, 72, 1000)],
                         ids=["300x1000x520", "1x17x3", "130x72x1000"])
def test_dual_launch_operands_pad_both_streams(rng, shape, dtype):
    """What a ``mm_dual_*`` launch hands its kernel at ragged K and N:
    both streams and b with 16-byte rows and 16-byte aligned bases (f32
    too, whose CUDA-core kernel stages them with cp.async as ``mm_mxu``'s
    does), the live K and both row strides on CUDA cores (f32), the
    padded K and b's row stride on the tensor cores; the padded product
    cropped to (M, N) equals the unpadded one (exactly for int8, within
    ``rtol=1e-5, atol=1e-6`` for floats, as the CPU BLAS blocks the
    shapes differently)."""
    m, k, n = shape
    if dtype == "int8":
        a1, a2, b = (_int8(rng, s)[1] for s in ((m, k), (m, k), (k, n)))
    else:
        a1, a2, b = (_normal(rng, s)[1].to(getattr(torch, dtype))
                     for s in ((m, k), (m, k), (k, n)))
    entry, (p1, p2, pb), dims = t_dual.launch_operands(a1, a2, b)
    align = 16 // b.element_size()
    kp, np_ = -(-k // align) * align, -(-n // align) * align
    assert p1.shape == p2.shape == (m, kp) and pb.shape == (kp, np_)
    for t in (p1, p2, pb):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        assert t.shape[1] * t.element_size() % 16 == 0
    if dtype == "float32":
        assert entry == "cnn_matmul_dual" and dims == (k, kp, np_)
    else:
        assert entry == "mm_tc_matmul_dual" and dims == (kp, np_)
    for a, p in ((a1, p1), (a2, p2)):
        got, want = t_ref(p, pb)[:, :n], t_ref(a, b)
        if dtype == "int8":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,mxu,dual", [
    (torch.int8, "mm_tc_matmul", "mm_tc_matmul_dual"),
    (torch.bfloat16, "mm_tc_matmul", "mm_tc_matmul_dual"),
    (torch.float32, "cnn_matmul", "cnn_matmul_dual")])
def test_entry_point_per_dtype(dtype, mxu, dual):
    """int8/bf16 MXU members take the tensor-core entry points, f32 the
    CUDA-core ones; ``mm_vpu`` takes ``cnn_matmul`` on every dtype (no
    MMA); one name per dtype, whatever the call."""
    assert t_mxu.entry_point("mxu", dtype, dtype) == mxu
    assert t_mxu.entry_point("vpu", dtype, dtype) == "cnn_matmul"
    assert t_dual.entry_point(dtype, dtype, dtype) == dual


@pytest.mark.parametrize("dtypes", [
    (torch.int8, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float32, torch.float32, torch.int8),
    (torch.float64, torch.float64, torch.float64)],
    ids=["i8-bf16", "bf16-f32", "f32-i8", "f64"])
def test_entry_point_refuses_mixed_dtypes(dtypes):
    """Mixed or unsupported operand dtypes raise the wrappers' existing
    ``TypeError`` messages before any launch."""
    a, _, b = dtypes
    with pytest.raises(TypeError) as e:
        t_mxu.entry_point("mxu", a, b)
    if a in t_mxu.KERNEL_DTYPES:
        assert str(e.value) == (f"b dtype {b} is not supported by the CUDA "
                                f"kernel (have [{a}])")
    else:
        assert str(e.value) == (f"a dtype {a} is not supported by the CUDA "
                                f"kernel (have {list(t_mxu.KERNEL_DTYPES)})")
    bad = next(name for name, d in zip(("a1", "a2", "b"), dtypes)
               if d not in t_mxu.KERNEL_DTYPES or d != dtypes[0])
    with pytest.raises(TypeError, match=f"^{bad} dtype .* has no CUDA dual "
                                        f"matmul kernel .* ROADMAP queue 2, "
                                        f"item 13"):
        t_dual.entry_point(*dtypes)


def test_chip_smoke_holds_the_tensor_core_kernels():
    """``chip_smoke.py`` names the kernels of the route it checks: every
    kernel of its SASS table is defined in the source it is listed under
    (the matmul ones in ``mm_tc_kernels.cu``, bf16 flash attention in
    ``attn_tc_kernels.cu``), every tensor-core matmul row points at
    ``mm_tc_kernels.cu`` and at ``mm_mxu``'s or ``_mm_dual``'s TPU kernel,
    the flash row at ``attn_tc_kernels.cu``, and the f32 and ``mm_vpu``
    rows stay on ``mm_kernels.cu``."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke.TC_SASS) == {smoke.CSRC_MM_TC, smoke.CSRC_ATTN_TC}
    src = (root / smoke.CSRC_MM_TC).read_text()
    for kernel, mnemonic in smoke.TC_SASS[smoke.CSRC_MM_TC].items():
        assert f"MM_TC_KERNEL({kernel}," in src
        assert mnemonic == ("IGMMA" if "_i8_" in kernel else "HGMMA")
    src = (root / smoke.CSRC_ATTN_TC).read_text()
    assert smoke.TC_SASS[smoke.CSRC_ATTN_TC] == {
        "attn_tc_flash_kernel": "HGMMA"}
    assert "attn_tc_flash_kernel(" in src
    # the SASS check matches kernels by substring: no other name holds it
    csrc = (root / smoke.CSRC_MM).parent
    names = set(re.findall(r"\b(\w+_kernel)\b", "".join(
        path.read_text() for path in csrc.glob("*.cu"))))
    for kernel in list(smoke.TC_SASS[smoke.CSRC_ATTN_TC]) + list(
            smoke.LOGIC_ONLY):
        assert [n for n in names if kernel in n] == [kernel]
    assert smoke.SOURCE["flash_attention"] == smoke.CSRC_ATTN_TC
    assert smoke.SOURCE["flash_decode"] == smoke.CSRC_ATTN
    for row in smoke.TC_ROWS:
        assert smoke.SOURCE[row] == smoke.CSRC_MM_TC
        assert smoke.REPLACES[row].split(":")[0] in (
            "src/repro/kernels/matmul/mxu.py",
            "src/repro/kernels/matmul/dual.py")
    for row in ("mm_mxu", "mm_vpu", "mm_vpu (int8)", "mm_vpu (bf16)"):
        assert smoke.SOURCE[row] == smoke.CSRC_MM
    assert smoke.mm_row("mm_mxu", torch.int8) == "mm_mxu (int8)"
    assert smoke.mm_row("mm_mxu", torch.bfloat16) == "mm_mxu (bf16)"
    assert smoke.mm_row("mm_mxu", torch.float32) == "mm_mxu"
    assert smoke.mm_row("mm_vpu", torch.int8) == "mm_vpu (int8)"
    assert smoke.mm_row("mm_vpu", torch.bfloat16) == "mm_vpu (bf16)"
    assert smoke.mm_row("mm_vpu", torch.float32) == "mm_vpu"


def test_chip_smoke_names_every_kernel():
    """Every row of ``chip_smoke.py``'s kernels line names the CUDA
    kernels it times (``KERNEL``), each defined in the row's source:
    f32 ``mm_mxu`` on ``mm_mxu_f32_kernel`` and ``conv2d_ip2`` on
    ``conv2d_mxu_tiled_kernel``, both in the CUDA-core sources, and
    their dual-stream siblings (f32 ``mm_dual_full``, ``conv2d_ip4``) on
    the same bodies."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke.KERNEL) == set(smoke.REPLACES)
    for row, names in smoke.KERNEL.items():
        src = (root / smoke.SOURCE[row]).read_text()
        for kernel in names.split(", "):
            assert re.search(rf"(\b{kernel}\(|MM_TC_KERNEL\({kernel},)",
                             src), (row, kernel)
    assert smoke.KERNEL["mm_mxu"] == "mm_mxu_f32_kernel"
    assert smoke.KERNEL["conv2d_ip2"] == "conv2d_mxu_tiled_kernel"
    assert smoke.SOURCE["conv2d_ip2"] == smoke.CSRC
    # the dual-stream members on f32 run their single-stream sibling's body
    assert smoke.KERNEL["conv2d_ip4"] == "conv2d_mxu_tiled_kernel"
    assert smoke.SOURCE["conv2d_ip4"] == smoke.CSRC
    assert smoke.KERNEL["mm_dual_full (f32)"] == "mm_dual_f32_kernel"
    assert smoke.SOURCE["mm_dual_full (f32)"] == smoke.CSRC_MM


# --------------------------------------------------------------------------
# the dual-stream members against the reference's kernel (interpret mode)
# --------------------------------------------------------------------------
def test_mm_dual_members_raise_named_errors(rng):
    """The int8-only contract of ``mm_dual_shared`` (a ``TypeError`` before
    any launch, in both packages), a wrong member name, mismatched
    streams; both members run."""
    (ja, ta), (jb, tb) = _normal(rng, (8, 8)), _normal(rng, (8, 8))
    with pytest.raises(TypeError, match="8-bit"):
        t_matmul_dual(ta, ta, tb, ip="mm_dual_shared")
    with pytest.raises(TypeError, match="8-bit"):
        j_matmul_dual(ja, ja, jb, ip="mm_dual_shared")
    (ji, ia), (jw, ib) = _int8(rng, (8, 8)), _int8(rng, (8, 8))
    for bad in ((ia, ia, tb), (ia, ta, ib), (ta, ia, ib)):
        with pytest.raises(TypeError, match="8-bit"):
            t_dual.mm_dual_shared(*bad)
        with pytest.raises(TypeError, match="8-bit"):
            t_dual.mm_dual_shared_plain(*bad)
    with pytest.raises(ValueError, match="differ in shape"):
        t_dual.mm_dual_full(ta, ta[:4], tb)
    with pytest.raises(ValueError, match="bk must be >= 1"):
        t_dual.mm_dual_shared(ia, ia, ib, bk=0)
    for ip in ("mm_dual_shared", "mm_dual_full"):
        for got, want in zip(t_matmul_dual(ia, ia, ib, ip=ip),
                             j_matmul_dual(ji, ji, jw, ip=ip)):
            _exact(got, want)
    y1, y2 = t_matmul_dual(ia, ia, ib)              # planned, then run
    _exact(y1, j_ref(ji, jw))
    with pytest.raises(KeyError, match="not a dual-stream matmul IP"):
        t_matmul_dual(ta, ta, tb, ip="mm_mxu")


@pytest.mark.parametrize("tiles", TILES, ids=TILE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mm_dual_shared_int8_bit_exact(rng, shape, tiles):
    m, k, n = shape
    (ja1, ta1), (ja2, ta2) = _int8(rng, (m, k)), _int8(rng, (m, k))
    (jb, tb) = _int8(rng, (k, n))
    want = j_dual.mm_dual_shared(ja1, ja2, jb, **tiles)
    got = t_dual.mm_dual_shared(ta1, ta2, tb, **tiles)
    for g, w in zip(got, want):
        _exact(g, w)
    for g, w in zip(t_dual.mm_dual_shared_plain(ta1, ta2, tb), want):
        _exact(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", SHAPES[:4], ids=SHAPE_IDS[:4])
def test_mm_dual_full_matches(rng, shape, dtype):
    """Accumulator dtype out (int32 / f32, never cast back to bf16), the
    reference's values: int8 bit-exact, floats within FLOAT."""
    m, k, n = shape
    if dtype == "int8":
        (ja1, ta1), (ja2, ta2) = _int8(rng, (m, k)), _int8(rng, (m, k))
        (jb, tb) = _int8(rng, (k, n))
    else:
        arrs = [rng.normal(size=s).astype(np.float32)
                for s in ((m, k), (m, k), (k, n))]
        (ja1, ja2, jb) = (jnp.asarray(x).astype(dtype) for x in arrs)
        (ta1, ta2, tb) = (torch.from_numpy(x).to(getattr(torch, dtype))
                          for x in arrs)
    want = j_dual.mm_dual_full(ja1, ja2, jb, bm=32, bn=32, bk=32)
    got = t_dual.mm_dual_full(ta1, ta2, tb, bm=32, bn=32, bk=32)
    for g, w in zip(got, want):
        if dtype == "int8":
            _exact(g, w)
        else:
            assert g.dtype == torch.float32 and str(w.dtype) == "float32"
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **FLOAT)
    for g, w in zip(got, t_dual.mm_dual_full_plain(ta1, ta2, tb)):
        assert torch.equal(g, w)
    for g, x in zip(got, (ta1, ta2)):          # each stream is mm_mxu's
        assert torch.equal(g, t_mxu.mm_mxu(x, tb))


@pytest.mark.parametrize("shape", [(512, 2048, 8192), (64, 96, 48), (1, 1, 1),
                                   (300, 700, 900)],
                         ids=["ffn", "64x96x48", "1x1x1", "300x700x900"])
@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_footprints_match_reference(shape, itemsize):
    from repro.core import library as j_library
    for name in ("mm_vpu", "mm_mxu", "mm_dual_shared", "mm_dual_full"):
        got = t_library.MATMUL[name].footprint(*shape, itemsize=itemsize)
        want = j_library.MATMUL[name].footprint(*shape, itemsize=itemsize)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    full = t_library.MATMUL["mm_dual_full"].footprint(*shape)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        j_library.MATMUL["mm_dual_full"].footprint(*shape))


def test_library_registers_matmul_as_the_reference_does():
    from repro.core import library as j_library
    assert list(t_library.FAMILIES)[:5] == list(j_library.FAMILIES)[:5]
    for name in j_library.MATMUL.names():
        t_ip, j_ip = t_library.MATMUL[name], j_library.MATMUL[name]
        for field in ("name", "family", "uses_mxu", "max_operand_bits",
                      "outputs_per_pass", "supports_dtypes", "tags",
                      "description"):
            assert getattr(t_ip, field) == getattr(j_ip, field), field
    assert t_library.get_ip("matmul.mm_mxu").impl is t_mxu.mm_mxu
    assert t_library.get_ip("matmul.mm_dual_shared").impl is \
        t_dual.mm_dual_shared
    assert t_library.get_ip("matmul.mm_dual_full").impl is \
        t_dual.mm_dual_full
    assert t_library.get_family("attention").name == "attention"
    assert t_library.get_family("ssm_scan").name == "ssm_scan"
    with pytest.raises(KeyError):
        t_library.get_ip("rwkv_scan.wkv")


# --------------------------------------------------------------------------
# planning: byte-equal plan JSON, and the chip run's matmul table
# --------------------------------------------------------------------------
FFN = ((512, 2048), (2048, 8192))
BUDGETS = {"default": {}, "logic_only": dict(mxu_available=False),
           "vmem_1MiB": dict(vmem_bytes=1 << 20),
           "vmem_900KiB": dict(vmem_bytes=900 * 1024),
           "int8_floor": dict(precision_bits=8),
           "passes_4": dict(mxu_passes_budget=4)}


def _net(make, dtype, ladder):
    return [make("up", "matmul", FFN, dtype, ladder=ladder, dual=False),
            make("small", "matmul", ((64, 96), (96, 48)), dtype,
                 ladder=ladder, dual=False),
            make("dual", "matmul", ((64, 96), (96, 48)), dtype, dual=True),
            make("dual_ragged", "matmul", ((33, 17), (17, 5)), dtype,
                 dual=True)]


@pytest.mark.parametrize("ladder", [(), (16, 8)], ids=["native", "ladder"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("budget", list(BUDGETS))
def test_matmul_plan_json_byte_equal(budget, dtype, ladder):
    j_plan.clear_plan_cache()
    t_plan.clear_plan_cache()
    try:
        want = j_plan.plan_network(_net(JSpec.make, dtype, ladder),
                                   JBudget(**BUDGETS[budget]))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_plan.plan_network(_net(TSpec.make, dtype, ladder),
                                TBudget(**BUDGETS[budget]))
        assert str(got.value) == str(e)
        return
    got = t_plan.plan_network(_net(TSpec.make, dtype, ladder),
                              TBudget(**BUDGETS[budget]))
    assert got.to_json() == want.to_json()
    assert got.describe() == want.describe()
    assert got.explain() == want.explain()


def test_dual_sites_plan_onto_the_dual_footprints():
    """At least the default budget plans the dual sites (not every case
    above raises)."""
    t_plan.clear_plan_cache()
    plan = t_plan.plan_network(_net(TSpec.make, "int8", ()), TBudget())
    members = {s.spec.name: s.ip.name for s in plan.sites}
    assert members["dual"] in ("matmul.mm_dual_shared", "matmul.mm_dual_full")
    assert members["up"] == "matmul.mm_mxu"


# the chip run's calls at Llama-3.2-1B's FFN up-projection
# (chip_smoke.py::MATMUL_PLANS): dtype, ladder, budget, member@bits
MATMUL_PLANS = [("float32", (), {}, "matmul.mm_mxu@32"),
                ("int8", (), {}, "matmul.mm_mxu@8"),
                ("float32", (), dict(mxu_available=False), "matmul.mm_vpu@32"),
                ("float32", (8,), dict(vmem_bytes=1 << 20), "matmul.mm_mxu@8"),
                ("float32", (16, 8), dict(vmem_bytes=900 * 1024),
                 "matmul.mm_vpu@16")]


@pytest.mark.parametrize("dtype,ladder,budget,want", MATMUL_PLANS,
                         ids=["f32", "int8", "f32-logic", "f32-l8",
                              "f32-l16"])
def test_ffn_calls_plan_the_listed_member(dtype, ladder, budget, want):
    """Planning only, at the full FFN width."""
    j_plan.clear_plan_cache()
    t_plan.clear_plan_cache()
    got = t_plan.plan_single(TSpec.make("mm", "matmul", FFN, dtype,
                                        ladder=ladder, dual=False),
                             TBudget(**budget))
    ref = j_plan.plan_single(JSpec.make("mm", "matmul", FFN, dtype,
                                        ladder=ladder, dual=False),
                             JBudget(**budget))
    assert f"{got.ip.name}@{got.precision_bits}" == \
        f"{ref.ip.name}@{ref.precision_bits}" == want


# a small site the ladder lowers: (shapes, budget, ladder, member@bits)
LOWERED = [(((64, 96), (96, 48)), dict(vmem_bytes=36 * 1024), (8,),
            "matmul.mm_mxu@8"),
           (((64, 96), (96, 48)), dict(vmem_bytes=34 * 1024), (16, 8),
            "matmul.mm_vpu@16")]


@pytest.mark.parametrize("shapes,budget,ladder,want", LOWERED,
                         ids=["int8", "16bit"])
def test_matmul_executes_lowered_plans(rng, shapes, budget, ladder, want):
    """``matmul(budget=, ladder=)`` lowers in both packages to the same
    member and width and returns the reference's float result."""
    (m, k), (_, n) = shapes
    (ja, ta), (jb, tb) = _normal(rng, (m, k)), _normal(rng, (k, n))
    planned = t_plan.plan_single(TSpec.make("mm", "matmul", shapes,
                                            "float32", ladder=ladder,
                                            dual=False), TBudget(**budget))
    assert f"{planned.ip.name}@{planned.precision_bits}" == want
    got = t_matmul(ta, tb, budget=TBudget(**budget), ladder=ladder)
    ref = j_matmul(ja, jb, budget=JBudget(**budget), ladder=ladder)
    if planned.precision_bits == 8:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLOAT)


# --------------------------------------------------------------------------
# quantized_matmul and int8_matmul(use_kernel=True)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ip", ["mm_mxu", "mm_vpu"])
@pytest.mark.parametrize("shape", SHAPES[:4], ids=SHAPE_IDS[:4])
def test_quantized_matmul_8bit_bit_exact(rng, shape, ip):
    m, k, n = shape
    (ja, ta), (jb, tb) = _normal(rng, (m, k)), _normal(rng, (k, n))
    got = t_qops.quantized_matmul(ta, tb, bits=8, ip=ip)
    want = j_qops.quantized_matmul(ja, jb, bits=8, ip=ip)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ip", ["mm_mxu", "mm_vpu"])
@pytest.mark.parametrize("shape", SHAPES[:4], ids=SHAPE_IDS[:4])
def test_quantized_matmul_16bit_matches(rng, shape, ip):
    m, k, n = shape
    (ja, ta), (jb, tb) = _normal(rng, (m, k)), _normal(rng, (k, n))
    np.testing.assert_allclose(
        t_qops.quantized_matmul(ta, tb, bits=16, ip=ip).numpy(),
        np.asarray(j_qops.quantized_matmul(ja, jb, bits=16, ip=ip)),
        **FLOAT)


@pytest.mark.parametrize("xshape", [(5, 12), (2, 3, 12), (64, 96)],
                         ids=["2d", "3d", "64x96"])
def test_int8_matmul_kernel_path_bit_exact(rng, xshape):
    jx, tx = _normal(rng, xshape)
    jw, tw = _both(rng.normal(size=(xshape[-1], 6)).astype(np.float32) * 0.3)
    twq, jwq = t_q.quantize_weights(tw), j_q.quantize_weights(jw)
    got = t_q.int8_matmul(tx, twq, use_kernel=True)
    want = j_q.int8_matmul(jx, jwq, use_kernel=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, t_q.int8_matmul(tx, twq))
