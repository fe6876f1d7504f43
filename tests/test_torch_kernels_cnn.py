"""The port's CNN kernel modules (``repro_torch.kernels``) against the
reference's Pallas kernels (``repro.kernels``, interpret mode on CPU).

On a CPU tensor each port wrapper runs its plain PyTorch version, so
these tests hold the plain versions — the functions the CUDA kernels are
checked against on the card by ``chip_smoke.py`` — to the reference.
Inputs are made with numpy from a seed and fed to both packages.

Tolerances: float32 conv and fused blocks (and the f32 rescale of the
int8 fused rung) ``rtol=1e-4, atol=1e-5`` (the port sums in another
order than XLA), bf16 convs the same (widened exactly, summed in f32);
pool and activation ``1e-6``, bf16 results one bf16 rounding of it
(``BF16``); int8/int16 conv/pool, the int32 floor average and the
native-int8 fused block bit-exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.activation import lut_poly as j_lut
from repro.kernels.activation import vpu_exact as j_act
from repro.kernels.conv2d import ip1_vpu as j_ip1
from repro.kernels.conv2d import ip2_mxu as j_ip2
from repro.kernels.conv2d import ip3_packed as j_ip3
from repro.kernels.conv2d import ip4_dual as j_ip4
from repro.kernels.fused import cnn_block as j_fused
from repro.kernels.pool2d import mxu_im2col as j_im2col
from repro.kernels.pool2d import vpu_window as j_pool
from repro_torch.kernels.activation import lut_poly as t_lut
from repro_torch.kernels.activation import vpu_exact as t_act
from repro_torch.kernels.activation.ops import activation as t_activation
from repro_torch.kernels.conv2d import inner as t_inner
from repro_torch.kernels.conv2d import ip1_vpu as t_ip1
from repro_torch.kernels.conv2d import ip2_mxu as t_ip2
from repro_torch.kernels.conv2d import ip3_packed as t_ip3
from repro_torch.kernels.conv2d import ip4_dual as t_ip4
from repro_torch.kernels.conv2d.ops import conv2d as t_conv2d
from repro_torch.kernels.conv2d.ops import conv2d_dual as t_conv2d_dual
from repro_torch.kernels.fused import cnn_block as t_fused
from repro_torch.kernels.fused.ops import fused_cnn_block as t_fused_block
from repro_torch.kernels.pool2d import mxu_im2col as t_im2col
from repro_torch.kernels.pool2d import vpu_window as t_pool
from repro_torch.kernels.pool2d.ops import pool2d as t_pool2d
from repro_torch.kernels.pool2d.ref import norm_window_stride

F32 = dict(rtol=1e-4, atol=1e-5)
TIGHT = dict(rtol=1e-6, atol=1e-6)
# a bf16 result: the f32 values within TIGHT, each rounded once to bf16,
# may round apart by one bf16 step (2^-8 of the value)
BF16 = dict(rtol=2 ** -8, atol=1e-6)

CONV_SHAPES = [((2, 12, 12, 4), (3, 3, 4, 8)),
               ((1, 9, 11, 3), (3, 3, 3, 5)),
               ((2, 8, 8, 2), (2, 2, 2, 3))]
CONV_IDS = ["2x12x12x4-k3-8", "1x9x11x3-k3-5", "2x8x8x2-k2-3"]


def _both(a):
    """One numpy array as (jax array, torch CPU tensor)."""
    return jnp.asarray(a), torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _randn(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _randint8(rng, shape, lo=-128, hi=127):
    return rng.integers(lo, hi, shape).astype(np.int8)


# --------------------------------------------------------------------------
# conv2d: ip1_vpu / ip2_mxu
# --------------------------------------------------------------------------
CONV_MEMBERS = [(j_ip1.conv2d_ip1, t_ip1.conv2d_ip1),
                (j_ip2.conv2d_ip2, t_ip2.conv2d_ip2)]


@pytest.mark.parametrize("member", [0, 1], ids=["ip1_vpu", "ip2_mxu"])
@pytest.mark.parametrize("xs,ws", CONV_SHAPES, ids=CONV_IDS)
def test_conv_f32_matches_reference(rng, member, xs, ws):
    jfn, tfn = CONV_MEMBERS[member]
    (jx, tx), (jw, tw) = _both(_randn(rng, xs)), _both(_randn(rng, ws))
    want, got = _np(jfn(jx, jw)), _np(tfn(tx, tw))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("member", [0, 1], ids=["ip1_vpu", "ip2_mxu"])
@pytest.mark.parametrize("xs,ws", CONV_SHAPES, ids=CONV_IDS)
def test_conv_int8_bit_exact(rng, member, xs, ws):
    jfn, tfn = CONV_MEMBERS[member]
    (jx, tx), (jw, tw) = _both(_randint8(rng, xs)), _both(_randint8(rng, ws))
    want, got = _np(jfn(jx, jw)), _np(tfn(tx, tw))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_conv_tile_hint_does_not_change_result(rng):
    x, w = torch.from_numpy(_randn(rng, (1, 8, 8, 3))), \
        torch.from_numpy(_randn(rng, (3, 3, 3, 7)))
    for fn in (t_ip1.conv2d_ip1, t_ip2.conv2d_ip2):
        assert torch.equal(fn(x, w, block_cout=3), fn(x, w))


def _conv1_tiles(x, w, plan):
    """``conv2d_vpu_tiled_kernel``'s decomposition on the CPU: each tile
    of ``plan`` computed only from what the kernel stages for it (the
    input halo, or per (tap, chunk) the shifted tile's chunk of
    channels), in the Conv1 order: per tap, a partial that starts at 0
    takes the staged channels' products in ascending order, across the
    chunks, then adds into the accumulator.  Returns the output and the
    number of tiles that wrote each output."""
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    ho, wo = h - kh + 1, w_ - kw + 1
    acc_dtype = torch.float32 if x.is_floating_point() else torch.int32
    xa, wa = x.to(acc_dtype), w.to(acc_dtype)
    y = torch.zeros((n, ho, wo, cout), dtype=acc_dtype)
    hits = torch.zeros((n, ho, wo, cout), dtype=torch.int32)
    chunks = [(c, min(c + plan.cc, cin)) for c in range(0, cin, plan.cc)]
    assert plan.whole == (chunks == [(0, cin)] and plan.cc == cin)
    # the kernel's CTAs: one a (row, column, channel) tile of each image
    tiles = [(h0, w0, c0) for h0 in range(0, ho, plan.th)
             for w0 in range(0, wo, plan.tw)
             for c0 in range(0, cout, plan.bc)]
    for b in range(n):
        for h0, w0, c0 in tiles:
            r, c, q = (min(plan.th, ho - h0), min(plan.tw, wo - w0),
                       min(plan.bc, cout - c0))
            halo = xa[b, h0:h0 + plan.th + kh - 1, w0:w0 + plan.tw + kw - 1]
            acc = torch.zeros((r, c, q), dtype=acc_dtype)
            for i in range(kh):
                for j in range(kw):
                    part = torch.zeros((r, c, q), dtype=acc_dtype)
                    for ca, cb in chunks:
                        if plan.whole:
                            box = halo[i:i + r, j:j + c, ca:cb]
                        else:
                            box = xa[b, h0 + i:h0 + i + r, w0 + j:w0 + j + c,
                                     ca:cb]
                        # the staged box holds every input the windows read
                        assert box.shape == (r, c, cb - ca)
                        for k in range(cb - ca):
                            part = part + (box[..., k, None]
                                           * wa[i, j, ca + k, c0:c0 + q])
                    acc = acc + part
            y[b, h0:h0 + r, w0:w0 + c, c0:c0 + q] = acc
            hits[b, h0:h0 + r, w0:w0 + c, c0:c0 + q] += 1
    return y, hits


# (x, w, block_cout, shared memory the plan may use): rows and columns no
# multiple of the tile, Cout 7, Cin 1 and 5, 1x1 and 5x5 taps, and a Cin
# that a small budget cuts into chunks (f32: 4 channels, int8: 16)
CONV1_PLANS = [((2, 13, 37, 1), (3, 3, 1, 7), 128, None),
               ((1, 11, 19, 5), (5, 5, 5, 7), 128, None),
               ((2, 9, 10, 5), (1, 1, 5, 7), 4, None),
               ((1, 10, 40, 20), (3, 3, 20, 7), 128, 2048),
               ((1, 7, 45, 20), (2, 3, 20, 9), 8, 2048)]
CONV1_IDS = ["cin1-k3", "cin5-k5", "cin5-k1-bc4", "chunked", "chunked-bc8"]


def _conv_operands(rng, dtype, xs, ws):
    """x and w as (jax, torch) pairs: f32 standard normal, int8 in
    [-128, 127); int16 over its full range and bf16 rounded from f32 in
    both packages (``_conv4_operands``)."""
    if dtype == "float32":
        return _both(_randn(rng, xs)), _both(_randn(rng, ws))
    if dtype == "int8":
        return _both(_randint8(rng, xs)), _both(_randint8(rng, ws))
    return _conv4_operands(rng, dtype, xs, ws)[1:]


@pytest.mark.parametrize("dtype", ["float32", "int8", "int16", "bfloat16"])
@pytest.mark.parametrize("xs,ws,block_cout,smem", CONV1_PLANS,
                         ids=CONV1_IDS)
def test_conv1_tile_plan_emulation(rng, dtype, xs, ws, block_cout, smem):
    """The tiled Conv1 kernel's plan covers every output exactly once,
    each tile's staged inputs cover its windows, and the tile-by-tile
    computation in the Conv1 order is bitwise equal to
    ``conv2d_ip1_plain`` and matches the reference's kernel (integers
    exactly, int16 products wrapping in the int32 accumulator)."""
    (jx, tx), (jw, tw) = _conv_operands(rng, dtype, xs, ws)
    n, h, w_, cin = xs
    kh, kw, _, cout = ws
    kwargs = {} if smem is None else dict(smem_bytes=smem)
    plan = t_ip1.tile_plan(h, w_, cin, kh, kw, cout,
                           itemsize=tx.element_size(),
                           block_cout=block_cout, **kwargs)
    assert plan.th * plan.tw == (t_ip1.THREADS >> plan.glog) * t_ip1.PIXELS
    assert plan.bc <= t_ip1.QUAD * t_ip1.MAX_QUADS
    assert plan.whole == (smem is None)
    if not plan.whole:
        assert plan.cc < cin and plan.cc % (16 // tx.element_size()) == 0
    got, hits = _conv1_tiles(tx, tw, plan)
    assert (hits == 1).all()
    assert torch.equal(got, t_ip1.conv2d_ip1_plain(tx, tw))
    want = _np(j_ip1.conv2d_ip1(jx, jw))
    if tx.is_floating_point():
        np.testing.assert_allclose(_np(got), want, **F32)
    else:
        np.testing.assert_array_equal(_np(got), want)


def _conv2_tiles(xs, w, plan, acc_dtype):
    """``conv2d_mxu_tiled_kernel``'s decomposition on the CPU for the
    streams ``xs`` (one for Conv2, two for Conv4) sharing ``w``: each
    tile of ``plan`` computed only from what the kernel stages for it
    (each stream's input halo, each pixel at ``inner.pixel_pitch``, or
    per (tap, chunk) each stream's shifted tile's chunk of channels, and
    the weights once), in the Conv2 order: ONE chain per output over (i,
    j, cin) from 0 in ``acc_dtype``, the taps outermost and the chunks
    ascending, 4 channels a load where a whole quad remains, then one at
    a time, each weight row feeding every stream.  Returns the outputs
    and the number of tiles that wrote each output, stacked by stream."""
    x = torch.stack(tuple(xs))
    ns, n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    ho, wo = h - kh + 1, w_ - kw + 1
    vec = 16 // x.element_size()
    xa, wa = x.to(acc_dtype), w.to(acc_dtype)
    y = torch.zeros((ns, n, ho, wo, cout), dtype=acc_dtype)
    hits = torch.zeros((ns, n, ho, wo, cout), dtype=torch.int32)
    chunks = [(c, min(c + plan.cc, cin)) for c in range(0, cin, plan.cc)]
    assert plan.whole == (chunks == [(0, cin)] and plan.cc == cin)
    # a staged pixel: whole 16-byte chunks, an odd number of them, and
    # every 4-channel load lies on a 16-byte (f32) or 4-byte (int8) step
    pitch = t_inner.pixel_pitch(plan.cc, vec)
    assert pitch >= plan.cc and pitch % vec == 0 and (pitch // vec) % 2
    assert all(ca % 4 == 0 for ca, _ in chunks)
    tiles = [(h0, w0, c0) for h0 in range(0, ho, plan.th)
             for w0 in range(0, wo, plan.tw)
             for c0 in range(0, cout, plan.bc)]
    for b in range(n):
        for h0, w0, c0 in tiles:
            r, c, q = (min(plan.th, ho - h0), min(plan.tw, wo - w0),
                       min(plan.bc, cout - c0))
            halo = xa[:, b, h0:h0 + plan.th + kh - 1,
                      w0:w0 + plan.tw + kw - 1]
            acc = torch.zeros((ns, r, c, q), dtype=acc_dtype)
            for i in range(kh):
                for j in range(kw):
                    for ca, cb in chunks:
                        if plan.whole:
                            box = halo[:, i:i + r, j:j + c, ca:cb]
                        else:
                            box = xa[:, b, h0 + i:h0 + i + r,
                                     w0 + j:w0 + j + c, ca:cb]
                        # the staged boxes hold every input the windows read
                        assert box.shape == (ns, r, c, cb - ca)
                        n4 = (cb - ca) // 4 * 4
                        runs = [range(k0, k0 + 4) for k0 in range(0, n4, 4)]
                        runs += [range(k, k + 1) for k in range(n4, cb - ca)]
                        for run in runs:
                            for k in run:
                                acc = acc + (box[..., k, None]
                                             * wa[i, j, ca + k, c0:c0 + q])
            y[:, b, h0:h0 + r, w0:w0 + c, c0:c0 + q] = acc
            hits[:, b, h0:h0 + r, w0:w0 + c, c0:c0 + q] += 1
    return y, hits


# CONV1_PLANS' cases, a whole halo read 4 channels a load (Cin 16, Cout
# 32) and chunks whose last one ends in a partial quad (Cin 22)
CONV2_PLANS = CONV1_PLANS + [((2, 9, 12, 16), (3, 3, 16, 32), 128, None),
                             ((1, 7, 9, 22), (3, 3, 22, 5), 128, 2048)]
CONV2_IDS = CONV1_IDS + ["cin16-quads", "chunked-tail"]


@pytest.mark.parametrize("dtype", ["float32", "int8", "int16", "bfloat16"])
@pytest.mark.parametrize("xs,ws,block_cout,smem", CONV2_PLANS,
                         ids=CONV2_IDS)
def test_conv2_tile_plan_emulation(rng, dtype, xs, ws, block_cout, smem):
    """The tiled Conv2 kernel's plan covers every output exactly once,
    each tile's staged inputs cover its windows, and the tile-by-tile
    chain over (i, j, cin) is bitwise equal to the plain chain: in f32
    (the kernels' accumulator) to ``inner.accumulate_mxu``'s, and to
    ``conv2d_ip2_plain`` (f64 for floats, int32 wrapping for integers),
    which matches the reference's kernel."""
    (jx, tx), (jw, tw) = _conv_operands(rng, dtype, xs, ws)
    n, h, w_, cin = xs
    kh, kw, _, cout = ws
    kwargs = {} if smem is None else dict(smem_bytes=smem)
    size = tx.element_size()
    plan = t_inner.tile_plan(h, w_, cin, kh, kw, cout, itemsize=size,
                             block_cout=block_cout, style="mxu", **kwargs)
    assert plan.th * plan.tw == (t_inner.THREADS >> plan.glog) * t_inner.PIXELS
    assert plan.bc <= t_inner.QUAD * t_inner.MAX_QUADS
    # a small budget cuts Cin into chunks (the default may too: Conv2's
    # padded pixels make the 128-row tile of cin5-k1-bc4 exceed it)
    assert not plan.whole if smem is not None else True
    staged = t_inner.tile_smem_bytes(plan, kh, kw, cin, itemsize=size,
                                     style="mxu")
    budget = t_inner.SMEM_BYTES if smem is None else smem
    if not plan.whole:
        assert plan.cc < cin and plan.cc % (16 // size) == 0
    assert staged <= budget or plan.cc == 16 // size
    if tx.is_floating_point():
        f32, hits = _conv2_tiles((tx,), tw, plan, torch.float32)
        assert (hits == 1).all()
        assert torch.equal(f32[0], t_inner.accumulate_mxu(
            tx, tw, ho=h - kh + 1, wo=w_ - kw + 1, acc_dtype=torch.float32))
        got = _conv2_tiles((tx,), tw, plan, torch.float64)[0][0].float()
    else:
        got, hits = _conv2_tiles((tx,), tw, plan, torch.int32)
        assert (hits == 1).all()
        got = got[0]
    assert torch.equal(got, t_ip2.conv2d_ip2_plain(tx, tw))
    want = _np(j_ip2.conv2d_ip2(jx, jw))
    if tx.is_floating_point():
        np.testing.assert_allclose(_np(got), want, **F32)
    else:
        np.testing.assert_array_equal(_np(got), want)


def _conv4_operands(rng, dtype, xs, ws):
    """Two streams and weights as (jax, torch) pairs: floats standard
    normal (bf16 rounded from f32 in both packages), integers over their
    full range."""
    if dtype in ("int8", "int16"):
        info = np.iinfo(dtype)
        arrs = [rng.integers(info.min, info.max, s, endpoint=True).astype(
            dtype) for s in (xs, xs, ws)]
        return [_both(a) for a in arrs]
    arrs = [_randn(rng, s) for s in (xs, xs, ws)]
    if dtype == "float32":
        return [_both(a) for a in arrs]
    return [(jnp.asarray(a).astype(jnp.bfloat16),
             torch.from_numpy(a).to(torch.bfloat16)) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "int8", "int16", "bfloat16"])
@pytest.mark.parametrize("xs,ws,block_cout,smem", CONV2_PLANS,
                         ids=CONV2_IDS)
def test_conv4_tile_plan_emulation(rng, dtype, xs, ws, block_cout, smem):
    """Conv4 runs Conv2's tiled kernel with two streams: the plan with
    ``streams=2`` cuts the CTAs as Conv2's does and covers every output
    of both streams once, the staged bytes (both halos or chunks, the
    weights once) fit the budget or Cin is chunked, and each stream's
    tile-by-tile chain is bitwise equal to the one-stream chain: in f32
    to ``inner.accumulate_mxu``'s, and (f64 for floats, int32 wrapping
    for integers) to ``conv2d_ip4_plain``, which matches the reference's
    kernel, exactly for integers."""
    (jxa, txa), (jxb, txb), (jw, tw) = _conv4_operands(rng, dtype, xs, ws)
    n, h, w_, cin = xs
    kh, kw, _, cout = ws
    kwargs = {} if smem is None else dict(smem_bytes=smem)
    size = txa.element_size()
    plan = t_inner.tile_plan(h, w_, cin, kh, kw, cout, itemsize=size,
                             block_cout=block_cout, style="mxu", streams=2,
                             **kwargs)
    one = t_inner.tile_plan(h, w_, cin, kh, kw, cout, itemsize=size,
                            block_cout=block_cout, style="mxu")
    assert (plan.glog, plan.twlog, plan.th) == (one.glog, one.twlog, one.th)
    assert plan.cc <= one.cc
    staged = t_inner.tile_smem_bytes(plan, kh, kw, cin, itemsize=size,
                                     style="mxu", streams=2)
    assert staged == 2 * t_inner.tile_smem_bytes(
        plan, kh, kw, cin, itemsize=size, style="mxu") - (
        (kh * kw * cin if plan.whole else plan.cc) * plan.bc * size)
    budget = t_inner.SMEM_BYTES if smem is None else smem
    if smem is not None:
        assert not plan.whole
    if not plan.whole:
        assert plan.cc < cin and plan.cc % (16 // size) == 0
    assert staged <= budget or plan.cc == 16 // size
    ho, wo = h - kh + 1, w_ - kw + 1
    if txa.is_floating_point():
        f32, hits = _conv2_tiles((txa, txb), tw, plan, torch.float32)
        assert (hits == 1).all()
        for got, x in zip(f32, (txa, txb)):
            assert torch.equal(got, t_inner.accumulate_mxu(
                x, tw, ho=ho, wo=wo, acc_dtype=torch.float32))
        ys = _conv2_tiles((txa, txb), tw, plan, torch.float64)[0].float()
    else:
        ys, hits = _conv2_tiles((txa, txb), tw, plan, torch.int32)
        assert (hits == 1).all()
    plain = t_ip4.conv2d_ip4_plain(txa, txb, tw)
    want = j_ip4.conv2d_ip4(jxa, jxb, jw, block_cout=block_cout)
    for got, p, j in zip(ys, plain, want):
        assert torch.equal(got, p)
        if txa.is_floating_point():
            np.testing.assert_allclose(_np(got), _np(j), **F32)
        else:
            np.testing.assert_array_equal(_np(got), _np(j))


def test_tile_plan_styles_share_the_cut():
    """Conv1 and Conv2 cut a conv into the same CTAs; only the shared
    memory a tile stages differs, and ``ip1_vpu.tile_plan`` is the shared
    plan under its old name."""
    assert t_ip1.tile_plan is t_inner.tile_plan
    for h, w, cin, k, cout, size in ((224, 224, 3, 3, 16, 4),
                                     (111, 111, 16, 3, 32, 4),
                                     (111, 111, 16, 3, 32, 1),
                                     (12, 20, 600, 3, 7, 4)):
        vpu, mxu = (t_inner.tile_plan(h, w, cin, k, k, cout, itemsize=size,
                                      style=style) for style in ("vpu", "mxu"))
        assert (vpu.glog, vpu.twlog, vpu.th) == (mxu.glog, mxu.twlog, mxu.th)
    with pytest.raises(ValueError, match="unknown style"):
        t_inner.tile_plan(8, 8, 3, 3, 3, 4, itemsize=4, style="dual")
    with pytest.raises(ValueError, match="takes no 2 streams"):
        t_inner.tile_plan(8, 8, 3, 3, 3, 4, itemsize=4, style="vpu",
                          streams=2)


# --------------------------------------------------------------------------
# pool2d: pool_vpu (the kernel) and pool_im2col (plain on the CPU)
# --------------------------------------------------------------------------
POOL_GEOMS = [((2, 2), None), ((3, 3), (2, 2)), ((2, 3), (1, 2))]
POOL_IDS = ["2x2", "3x3s2", "2x3s1x2"]


@pytest.mark.parametrize("window,stride", POOL_GEOMS, ids=POOL_IDS)
@pytest.mark.parametrize("mode", ["max", "avg"])
def test_pool_f32_matches_reference(rng, window, stride, mode):
    jx, tx = _both(_randn(rng, (2, 10, 11, 5)))
    want = _np(j_pool.pool2d_window(jx, window=window, stride=stride,
                                    mode=mode))
    got = _np(t_pool.pool2d_window(tx, window=window, stride=stride,
                                   mode=mode))
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **TIGHT)


@pytest.mark.parametrize("dtype", ["int8", "int32"])
@pytest.mark.parametrize("mode", ["max", "avg"])
def test_pool_int_bit_exact_with_floor_average(rng, dtype, mode):
    """int avg floors (jnp //) — the negative sums here make C's
    truncating division disagree, so this pins the floor."""
    x = rng.integers(-120, 120, (2, 9, 9, 4)).astype(dtype)
    jx, tx = _both(x)
    want = _np(j_pool.pool2d_window(jx, window=(3, 3), stride=(2, 2),
                                    mode=mode))
    got = _np(t_pool.pool2d_window(tx, window=(3, 3), stride=(2, 2),
                                   mode=mode))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if mode == "avg":
        assert (want < 0).any()


@pytest.mark.parametrize("member", ["window", "im2col"])
@pytest.mark.parametrize("mode", ["max", "avg"])
def test_pool_bf16_plain_matches_reference(rng, member, mode):
    """bf16 pooling (the CUDA kernels reduce in f32): max keeps bf16 and
    picks an input exactly, avg gives f32, as the reference's kernels in
    interpret mode give them."""
    jfn, tfn = {"window": (j_pool.pool2d_window, t_pool.pool2d_window),
                "im2col": (j_im2col.pool2d_im2col,
                           t_im2col.pool2d_im2col)}[member]
    x = _randn(rng, (2, 10, 11, 5))
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)
    want = jfn(jx, window=(3, 3), stride=(2, 2), mode=mode)
    got = tfn(tx, window=(3, 3), stride=(2, 2), mode=mode)
    out = torch.bfloat16 if mode == "max" else torch.float32
    assert got.dtype == out and str(want.dtype) == str(out).split(".")[1]
    want = np.asarray(want.astype(jnp.float32))
    if mode == "max":
        np.testing.assert_array_equal(_np(got.float()), want)
    else:
        np.testing.assert_allclose(_np(got), want, **TIGHT)


def test_pool_max_propagates_nan():
    x = torch.zeros((1, 4, 4, 1))
    x[0, 1, 1, 0] = float("nan")
    y = t_pool.pool2d_window(x)
    assert torch.isnan(y[0, 0, 0, 0]) and not torch.isnan(y[0, 1, 1, 0])


def test_ctypes_signatures_match_the_launchers():
    """Each C entry ``kernels/cuda.py`` binds takes as many arguments as
    its ``_SIGNATURES`` entry passes (ctypes would refuse the call only
    on the card, and a missing argument shifts every later one)."""
    import re
    from repro_torch.kernels import cuda
    found = {}
    for name in cuda.SOURCES:
        src = (cuda.CSRC / name).read_text()
        for m in re.finditer(r"^int (\w+)\(([^)]*)\)\s*\{",
                             src[src.index('extern "C" {'):], re.M):
            found[m.group(1)] = len([a for a in m.group(2).split(",")
                                     if a.strip()])
    for fn, args in cuda._SIGNATURES.items():
        assert found.get(fn) == len(args), (fn, found.get(fn), len(args))


def _window_chain(taps, get, kh, kw, mode):
    """Each element's taps in i-major order from (0, 0) (``window_step``),
    ``get(i, j)`` yielding tap (i, j) of every element, loaded ``TAPS``
    at a time as ``pool2d_kernel`` loads them; then ``window_end``."""
    acc = None
    for t0 in range(0, len(taps), t_pool.TAPS):
        chunk = taps[t0:t0 + t_pool.TAPS]
        for (i, j), v in zip(chunk, [get(i, j) for i, j in chunk]):
            if (i, j) == (0, 0):
                acc = v
            elif mode == "max":
                acc = torch.maximum(acc, v)
            else:
                acc = acc + v
    if mode == "avg":
        acc = (acc / (kh * kw) if acc.is_floating_point()
               else torch.div(acc, kh * kw, rounding_mode="floor"))
    return acc


def _pool_walk(x, plan, kh, kw, sh, sw, mode):
    """``pool2d_kernel``'s cut on the CPU, in kernel order: every thread
    of ``plan``'s grid takes its (row, lane, channel vector) from its
    index and owns the outputs q, q + lanes, .. of that row; each element
    takes its taps through ``_window_chain``.  Returns the output and the
    number of times each output element was written."""
    n, h, w, c = x.shape
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    out_dtype = t_pool.pool_dtypes(x.dtype, mode)[1]
    xv = x.to(torch.float32 if x.is_floating_point() else torch.int32)
    xv = xv.reshape(-1)
    y = torch.zeros(n * ho * wo * c, dtype=out_dtype)
    hits = torch.zeros(y.numel(), dtype=torch.int32)
    taps = [(i, j) for i in range(kh) for j in range(kw)]
    g = torch.arange(plan.ctas * t_pool.THREADS)
    per_row = plan.lanes * plan.cv
    row = g // per_row
    g, row = g[row < n * ho], row[row < n * ho]
    q = (g - row * per_row) // plan.cv
    c0 = (g - row * per_row - q * plan.cv) * plan.ve
    b, oh = row // ho, row % ho
    for k in range(t_pool.MAX_OUTS):
        ow = q + k * plan.lanes
        live = (ow < wo) & (k < plan.outs)
        ch = c0[live, None] + torch.arange(plan.ve)         # (threads, ve)
        base = ((b[live, None] * h + oh[live, None] * sh) * w
                + ow[live, None] * sw) * c + ch
        acc = _window_chain(taps, lambda i, j: xv[base + (i * w + j) * c],
                            kh, kw, mode)
        idx = (((b[live, None] * ho + oh[live, None]) * wo + ow[live, None])
               * c + ch).reshape(-1)
        y[idx] = acc.reshape(-1).to(out_dtype)
        hits.index_add_(0, idx, torch.ones(idx.numel(), dtype=torch.int32))
    return y.view(n, ho, wo, c), hits


# (x shape, window, stride, storage offset of x in elements): C of 16
# (16-byte vectors in every dtype), 3, 7, 17, 33, 32 and 48; 2x2 with
# stride 2, 3x3 with strides 1 and 2, 1x3 with stride (1, 2), 3x3 with
# stride (1, 2); a window as large as the input; N > 1; inputs one
# element past a 16-byte boundary
POOL_PLANS = [((2, 9, 10, 16), (2, 2), None, 0),
              ((1, 9, 11, 3), (3, 3), (1, 1), 0),
              ((2, 11, 9, 7), (3, 3), (2, 2), 0),
              ((1, 8, 13, 17), (1, 3), (1, 2), 0),
              ((2, 7, 9, 33), (2, 2), None, 0),
              ((1, 6, 7, 16), (6, 7), None, 0),
              ((2, 10, 10, 32), (3, 3), (1, 1), 0),
              ((2, 9, 10, 16), (2, 2), None, 1),
              ((2, 13, 21, 48), (3, 3), (1, 2), 1)]
POOL_PLAN_IDS = ["c16-2x2", "c3-3x3s1", "c7-3x3s2", "c17-1x3s12", "c33-2x2",
                 "c16-whole", "c32-3x3s1", "c16-offset1", "c48-3x3s12-offset1"]


# each member's reference kernel and plain version: pool2d_im2col's
# kernel is pool2d_window's body (pool_window) under its own name, on the
# same pool_plan cut
POOL_MEMBERS = {"pool2d_window": (j_pool.pool2d_window,
                                  t_pool.pool2d_window_plain),
                "pool2d_im2col": (j_im2col.pool2d_im2col,
                                  t_im2col.pool2d_im2col_plain)}


@pytest.mark.parametrize("member", sorted(POOL_MEMBERS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int32"])
@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("xs,window,stride,off", POOL_PLANS,
                         ids=POOL_PLAN_IDS)
def test_pool_plan_emulation(rng, dtype, mode, xs, window, stride, off,
                             member):
    """``pool_plan``'s cut walked thread by thread covers every output
    exactly once, takes 16-byte vectors exactly where C * itemsize is a
    multiple of 16 and the input is aligned, and its reduction is
    bitwise the member's plain version (and both plain versions equal
    each other bitwise); the result matches the member's reference
    kernel in interpret mode (integers and max exactly, float avg within
    ``TIGHT``)."""
    j_member, t_plain = POOL_MEMBERS[member]
    numel = int(np.prod(xs))
    if dtype in ("int8", "int32"):
        vals = torch.from_numpy(rng.integers(-128, 128, numel + off))
    else:
        vals = torch.from_numpy(_randn(rng, (numel + off,)) * 3)
    base = torch.empty(numel + off, dtype=getattr(torch, dtype))
    base.copy_(vals)
    assert base.data_ptr() % 16 == 0
    x = base[off:].view(xs)
    (kh, kw), (sh, sw) = norm_window_stride(window, stride)
    n, h, w, c = xs
    size = x.element_size()
    plan = t_pool.pool_plan(n, h, w, c, kh, kw, sh, sw, itemsize=size,
                            x_addr=x.data_ptr(), y_addr=0)
    vec = (c * size) % 16 == 0 and off == 0
    assert plan.ve == (16 // size if vec else 1)
    assert plan.cv * plan.ve == c and plan.outs <= t_pool.MAX_OUTS
    got, hits = _pool_walk(x, plan, kh, kw, sh, sw, mode)
    assert (hits == 1).all()
    assert got.dtype == t_pool.pool_dtypes(x.dtype, mode)[1]
    kw_ = dict(window=window, stride=stride, mode=mode)
    assert torch.equal(got, t_plain(x, **kw_))
    assert torch.equal(t_im2col.pool2d_im2col_plain(x, **kw_),
                       t_pool.pool2d_window_plain(x, **kw_))
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == "bfloat16" else dtype)
    want = j_member(jx, interpret=True, **kw_)
    assert str(want.dtype) == str(got.dtype).split(".")[1]
    want = np.asarray(want.astype(jnp.float32)) if dtype == "bfloat16" \
        else np.asarray(want)
    if mode == "max" or not x.is_floating_point():
        np.testing.assert_array_equal(_np(got.float()) if dtype == "bfloat16"
                                      else _np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, **TIGHT)


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_pool_im2col_plain_matches_reference(rng, mode):
    x = _randn(rng, (2, 8, 8, 3))
    jx, tx = _both(x)
    np.testing.assert_allclose(
        _np(t_im2col.pool2d_im2col(tx, mode=mode)),
        _np(j_im2col.pool2d_im2col(jx, mode=mode)), **TIGHT)
    xi = rng.integers(-50, 50, (2, 8, 8, 3)).astype(np.int8)
    jx, tx = _both(xi)
    np.testing.assert_array_equal(
        _np(t_im2col.pool2d_im2col(tx, mode=mode)),
        _np(j_im2col.pool2d_im2col(jx, mode=mode)))


# --------------------------------------------------------------------------
# activation: act_vpu (the kernel) and act_lut (plain on the CPU)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["relu", "relu6", "sigmoid", "tanh", "gelu"])
def test_activation_f32_matches_reference(rng, kind):
    jx, tx = _both(_randn(rng, (3, 7, 6)) * 4)
    want = _np(j_act.activation_exact(jx, kind=kind))
    got = _np(t_act.activation_exact(tx, kind=kind))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, **TIGHT)


@pytest.mark.parametrize("kind", ["relu", "tanh"])
def test_activation_int_input_gives_f32(rng, kind):
    jx, tx = _both(rng.integers(-5, 5, (4, 9)).astype(np.int32))
    want = _np(j_act.activation_exact(jx, kind=kind))
    got = _np(t_act.activation_exact(tx, kind=kind))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, **TIGHT)


@pytest.mark.parametrize("kind", ["relu", "relu6", "sigmoid", "tanh", "gelu"])
def test_activation_bf16_plain_matches_reference(rng, kind):
    """bf16 in, bf16 out: the f32 function rounded once to bf16 (the
    CUDA kernel's ``__float2bfloat16_rn``), as the reference's kernel in
    interpret mode gives it, within one bf16 rounding of ``TIGHT``."""
    x = _randn(rng, (3, 7, 6)) * 4
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)
    want = j_act.activation_exact(jx, kind=kind)
    got = t_act.activation_exact(tx, kind=kind)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(want.astype(jnp.float32)), **BF16)
    if kind in ("relu", "relu6"):      # exact functions: the same bits
        np.testing.assert_array_equal(_np(got.float()),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("kind", ["relu6", "sigmoid", "tanh"])
def test_activation_lut_bf16_plain_matches_reference(rng, kind):
    """bf16 in, bf16 out: the f32 table entry rounded once to bf16."""
    x = _randn(rng, (4, 33)) * 5
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)
    want = j_lut.activation_lut(jx, kind=kind)
    got = t_lut.activation_lut(tx, kind=kind)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(want.astype(jnp.float32)), **BF16)


def test_cuda_dtypes_cover_the_members():
    """Each CNN member's CUDA kernel takes every dtype its library entry
    declares (``supports_dtypes``), and the conv and fused kernels int16
    too, so a tenant the planner admits is never refused on the card."""
    import sys
    from repro_torch.core.library import FAMILIES
    for family in ("conv2d", "pool2d", "activation", "cnn_fused"):
        for ip in FAMILIES[family].members.values():
            have = sys.modules[ip.impl.__module__].CUDA_DTYPES
            want = {getattr(torch, d) for d in ip.supports_dtypes}
            if family in ("conv2d", "cnn_fused") and \
                    ip.name != "conv2d.ip3_packed":
                want.add(torch.int16)
            assert want <= set(have), (ip.name, want - set(have))


def test_activation_relu_propagates_nan():
    x = torch.tensor([float("nan"), -1.0, 2.0])
    for kind in ("relu", "relu6"):
        y = t_act.activation_exact(x, kind=kind)
        assert torch.isnan(y[0]) and y[1] == 0.0 and y[2] == 2.0


def _walk_pieces(numel, plan, ve):
    """The element ranges ``act_walk`` gives each piece of work on the
    CPU, in kernel order: the head (one a thread), every CTA's tiles a
    grid apart (a vector a thread), the tail (one a thread)."""
    tile = t_act.THREADS * t_act.VECS
    nvec = (numel - plan.head) // ve
    tail0 = plan.head + nvec * ve
    assert plan.tiles == -(-nvec // tile)
    assert 1 <= plan.grid and (plan.grid <= plan.tiles or plan.grid == 1)
    threads = np.arange(plan.grid * t_act.THREADS)
    pieces = [threads[threads < plan.head]]
    for cta in range(plan.grid):
        for t in range(cta, plan.tiles, plan.grid):
            v = np.arange(t * tile, min((t + 1) * tile, nvec))
            pieces.append((plan.head + v[:, None] * ve
                           + np.arange(ve)).reshape(-1))
    pieces.append(tail0 + threads[threads < numel - tail0])
    return pieces


LUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8, "int32": torch.int32}


@pytest.mark.parametrize("dtype", list(LUT_DTYPES))
def test_activation_lut_walk_emulation(dtype):
    """``walk_plan`` (the mirror of the launchers' ``act_split``, which
    ``chip_smoke.py`` holds against the C query) covers each element
    exactly once at input offsets of 0-15 bytes (those not aligned to
    the element are refused), numels 0, 1, 15 and a tile of ``THREADS *
    VECS * VE`` plus and minus 1, and a grid smaller than the tiles;
    the output assembled piece by piece is bitwise
    ``activation_lut_plain``, which matches the reference's kernel in
    interpret mode within 1e-6 (its table from ``jnp.linspace``; bf16
    one bf16 rounding of that)."""
    tdt = LUT_DTYPES[dtype]
    size = torch.empty((), dtype=tdt).element_size()
    osize = t_lut.activation_out_dtype(tdt).itemsize
    ve = 16 // size
    tile = t_act.THREADS * t_act.VECS * ve
    xs = torch.linspace(-6, 6, 40 * tile + 5)
    if not tdt.is_floating_point:
        xs = (xs * 20).round()
    xs = xs.to(tdt)
    xs[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")]
                          ).to(tdt) if tdt.is_floating_point else xs[:3]
    cases = [(n, 132) for n in (0, 1, 15, tile - 1, tile, tile + 1)]
    cases.append((40 * tile + 5, 1))    # a grid of 16 CTAs, 41 tiles
    for off in range(16):
        for numel, sms in cases:
            for yoff in (0, osize):
                kw = dict(itemsize=size, out_itemsize=osize, x_addr=off,
                          y_addr=yoff, sms=sms)
                if off % size:
                    with pytest.raises(ValueError, match="aligned"):
                        t_act.walk_plan(numel, **kw)
                    continue
                plan = t_act.walk_plan(numel, **kw)
                assert plan.head == min(numel, (16 - off) % 16 // size)
                assert plan.vstore == ((yoff + plan.head * osize) % 16 == 0)
                hits = np.zeros(numel, dtype=np.int64)
                x = xs[:numel]
                y = torch.zeros(numel, dtype=t_lut.activation_out_dtype(tdt))
                for idx in _walk_pieces(numel, plan, ve):
                    np.add.at(hits, idx, 1)
                    part = torch.from_numpy(idx)
                    y[part] = t_lut.activation_lut_plain(x[part])
                assert (hits == 1).all(), (off, numel, sms)
                assert torch.equal(y, t_lut.activation_lut_plain(x))
    x = xs[3:tile + 1]
    want = j_lut.activation_lut(
        jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == "bfloat16" else dtype), interpret=True)
    got = t_lut.activation_lut_plain(x)
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(want.astype(jnp.float32)),
                               **(BF16 if dtype == "bfloat16" else TIGHT))


@pytest.mark.parametrize("kind", ["relu6", "sigmoid", "tanh"])
def test_activation_lut_plain_matches_reference(rng, kind):
    jx, tx = _both(_randn(rng, (4, 33)) * 5)
    np.testing.assert_allclose(_np(t_lut.activation_lut(tx, kind=kind)),
                               _np(j_lut.activation_lut(jx, kind=kind)),
                               **TIGHT)


# --------------------------------------------------------------------------
# fused conv -> pool -> act
# --------------------------------------------------------------------------
FUSED = {"vpu": (j_fused.fused_cnn_vpu, t_fused.fused_cnn_vpu,
                 t_ip1.conv2d_ip1),
         "mxu": (j_fused.fused_cnn_mxu, t_fused.fused_cnn_mxu,
                 t_ip2.conv2d_ip2)}
FUSED_CASES = [("max", "relu", None), ("avg", "tanh", None),
               ("max", "gelu", (1, 1)), ("avg", "sigmoid", (1, 2))]


@pytest.mark.parametrize("style", ["vpu", "mxu"])
@pytest.mark.parametrize("mode,kind,stride", FUSED_CASES,
                         ids=["max-relu", "avg-tanh", "max-gelu-s1",
                              "avg-sigmoid-s12"])
def test_fused_f32_matches_reference(rng, style, mode, kind, stride):
    jfn, tfn, _ = FUSED[style]
    (jx, tx), (jw, tw) = _both(_randn(rng, (2, 12, 11, 4))), \
        _both(_randn(rng, (3, 3, 4, 6)))
    kw = dict(pool_window=(2, 2), pool_stride=stride, pool_mode=mode,
              act_kind=kind)
    want, got = _np(jfn(jx, jw, **kw)), _np(tfn(tx, tw, **kw))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("style", ["vpu", "mxu"])
@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("scaled", [False, True], ids=["int32-pool",
                                                       "int8-rung"])
def test_fused_int8_matches_reference(rng, style, mode, scaled):
    """Native int8 (int32 pool, floor avg) is bit-exact.  The int8 rung
    (per-channel f32 rescale of the int32 accumulator before pooling)
    has an exact integer conv; its f32 rescale-and-average may contract
    into FMAs under XLA, so it is held at the float32 tolerance."""
    jfn, tfn, _ = FUSED[style]
    (jx, tx), (jw, tw) = _both(_randint8(rng, (2, 10, 10, 3))), \
        _both(_randint8(rng, (3, 3, 3, 5)))
    scale = (rng.random(5).astype(np.float32) * 1e-3) if scaled else None
    jscale = None if scale is None else jnp.asarray(scale)
    tscale = None if scale is None else torch.from_numpy(scale)
    want = _np(jfn(jx, jw, jscale, pool_mode=mode, act_kind="relu"))
    got = _np(tfn(tx, tw, tscale, pool_mode=mode, act_kind="relu"))
    if scaled:
        np.testing.assert_allclose(got, want, **F32)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("style", ["vpu", "mxu"])
@pytest.mark.parametrize("mode,kind", [("max", "relu"), ("avg", "tanh"),
                                       ("max", "gelu")])
def test_fused_plain_bitwise_equals_plain_chain(rng, style, mode, kind):
    """The port's fusion invariant on the CPU path: one fused call is
    bitwise the conv -> pool -> act chain of the standalone members."""
    _, tfn, conv = FUSED[style]
    x = torch.from_numpy(_randn(rng, (2, 12, 12, 4)))
    w = torch.from_numpy(_randn(rng, (3, 3, 4, 8)))
    chain = t_act.activation_exact(
        t_pool.pool2d_window(conv(x, w), mode=mode), kind=kind)
    assert torch.equal(tfn(x, w, pool_mode=mode, act_kind=kind), chain)


# --------------------------------------------------------------------------
# the tiled fused kernel's plan, and Conv3's packed recovery
# --------------------------------------------------------------------------
def _band_conv(xa, wa, b, h0, w0, c0, tile, style, acc_dtype):
    """The conv values of one conv tile (a band of the fused kernel) at
    (h0, w0), channels c0.., computed only from what the kernel stages
    for it (the halo, or per (tap, chunk) the shifted tile's chunk of
    channels), in the style's order: vpu, per tap a partial over the
    staged channels, then into the accumulator; mxu, one chain over (i,
    j, cin).  Clipped to the conv plane and Cout."""
    kh, kw, cin, cout = wa.shape
    ho, wo = xa.shape[1] - kh + 1, xa.shape[2] - kw + 1
    r, c, q = (min(tile.th, ho - h0), min(tile.tw, wo - w0),
               min(tile.bc, cout - c0))
    chunks = [(ca, min(ca + tile.cc, cin)) for ca in range(0, cin, tile.cc)]
    halo = xa[b, h0:h0 + tile.th + kh - 1, w0:w0 + tile.tw + kw - 1]
    acc = torch.zeros((r, c, q), dtype=acc_dtype)
    for i in range(kh):
        for j in range(kw):
            part = torch.zeros((r, c, q), dtype=acc_dtype)
            for ca, cb in chunks:
                box = (halo[i:i + r, j:j + c, ca:cb] if tile.whole else
                       xa[b, h0 + i:h0 + i + r, w0 + j:w0 + j + c, ca:cb])
                # the staged box holds every input the tile's windows read
                assert box.shape == (r, c, cb - ca)
                for k in range(cb - ca):
                    prod = box[..., k, None] * wa[i, j, ca + k, c0:c0 + q]
                    if style == "vpu":
                        part = part + prod
                    else:
                        acc = acc + prod
            if style == "vpu":
                acc = acc + part
    return acc


def _fused_tiles(x, w, scale, plan, style, window, stride, mode, kind):
    """``fused_cnn_tiled_kernel``'s decomposition on the CPU: the CTAs of
    ``plan`` (pooled tiles x channel blocks), each band of conv values
    (``_band_conv``: f32 for vpu floats, f64 for mxu floats as the plain
    Conv2 chain, int32 for integers; rescaled on the int8 rung) and each
    window's taps taken from the bands in band order, i-major within a
    band, carried across bands.  Asserts that a band holds every tap it
    is asked for and that each window gets all its taps once.  Returns
    the output and the number of CTAs that wrote each output."""
    from repro_torch.kernels.activation.ref import _FNS
    (ph, pw), (sh, sw) = window, stride
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    ho, wo = h - kh + 1, w_ - kw + 1
    po, qo = (ho - ph) // sh + 1, (wo - pw) // sw + 1
    tile = plan.tile
    if x.is_floating_point():
        acc_dtype = torch.float32 if style == "vpu" else torch.float64
    else:
        acc_dtype = torch.int32
    pool_dtype = (torch.float32 if x.is_floating_point() or scale is not None
                  else torch.int32)
    xa, wa = x.to(acc_dtype), w.to(acc_dtype)
    assert plan.tp * plan.tq <= (t_inner.THREADS >> tile.glog) * t_inner.PIXELS
    assert plan.col_segs == 1 or tile.th == 1
    y = torch.zeros((n, po, qo, cout), dtype=pool_dtype)
    hits = torch.zeros((n, po, qo, cout), dtype=torch.int32)
    for b in range(n):
        for p0 in range(0, po, plan.tp):
            for q0 in range(0, qo, plan.tq):
                for c0 in range(0, cout, tile.bc):
                    q = min(tile.bc, cout - c0)
                    outs = [(pi, qi) for pi in range(plan.tp)
                            for qi in range(plan.tq)
                            if p0 + pi < po and q0 + qi < qo]
                    red, taps = {}, {o: 0 for o in outs}
                    for rb in range(plan.row_bands):
                        for cs in range(plan.col_segs):
                            br, bcol = rb * tile.th, cs * tile.tw
                            h0, w0 = p0 * sh + br, q0 * sw + bcol
                            if h0 >= ho or w0 >= wo:
                                continue
                            band = _band_conv(xa, wa, b, h0, w0, c0, tile,
                                              style, acc_dtype).to(pool_dtype)
                            if scale is not None:
                                band = band * scale[c0:c0 + q]
                            for pi, qi in outs:
                                wr, wc = pi * sh - br, qi * sw - bcol
                                for i in range(max(0, -wr),
                                               min(ph, tile.th - wr)):
                                    for j in range(max(0, -wc),
                                                   min(pw, tile.tw - wc)):
                                        assert (wr + i < band.shape[0]
                                                and wc + j < band.shape[1])
                                        v = band[wr + i, wc + j]
                                        o = (pi, qi)
                                        if i == 0 and j == 0:
                                            assert o not in red
                                            red[o] = v
                                        elif mode == "max":
                                            red[o] = torch.maximum(red[o], v)
                                        else:
                                            red[o] = red[o] + v
                                        taps[o] += 1
                    for pi, qi in outs:
                        assert taps[(pi, qi)] == ph * pw
                        v = red[(pi, qi)]
                        if mode == "avg":
                            v = (v / (ph * pw) if v.is_floating_point() else
                                 torch.div(v, ph * pw, rounding_mode="floor"))
                        y[b, p0 + pi, q0 + qi, c0:c0 + q] = v
                        hits[b, p0 + pi, q0 + qi, c0:c0 + q] += 1
    return _FNS[kind](y.to(torch.float32)), hits


# (x, w, window, stride, mode, kind, shared memory the plan may use):
# the five pool geometries of the card's checks, a window taller than
# the conv tile's 8 rows (two row bands), one wider than 32 columns (a
# tile of 64), one wider than the widest band of 2048 columns (one-row
# bands in two column segments), and a Cin that a small budget chunks
FUSED_PLANS = [
    ((2, 12, 11, 3), (3, 3, 3, 6), (2, 2), (2, 2), "max", "relu", None),
    ((2, 12, 11, 3), (3, 3, 3, 6), (3, 3), (2, 2), "avg", "tanh", None),
    ((1, 9, 10, 3), (3, 3, 3, 5), (2, 2), (1, 1), "max", "gelu", None),
    ((1, 9, 12, 3), (3, 3, 3, 5), (2, 3), (1, 2), "avg", "sigmoid", None),
    ((2, 13, 12, 2), (3, 3, 2, 6), (2, 2), (3, 3), "max", "relu6", None),
    ((1, 14, 20, 3), (3, 3, 3, 20), (10, 3), (2, 2), "avg", "relu", None),
    ((1, 5, 40, 2), (3, 3, 2, 4), (2, 36), (1, 1), "max", "tanh", None),
    ((1, 2, 2100, 1), (1, 1, 1, 4), (2, 2049), (1, 17), "max", "relu",
     None),
    ((1, 7, 9, 20), (3, 3, 20, 5), (2, 2), (2, 2), "avg", "relu", 2048)]
FUSED_PLAN_IDS = ["2x2s2", "3x3s2", "2x2s1", "2x3s1x2", "2x2s3", "tall",
                  "wide", "col-segs", "chunked"]


def _fused_operands(rng, dtype, xs, ws):
    """(jax, torch) operands and scale of a fused block: the conv
    operands of ``_conv_operands`` (int16 full range, int8 in [-128,
    127)), and on the int8 rung a per-channel f32 scale."""
    if dtype == "int8-rung":
        (jx, tx), (jw, tw) = _conv_operands(rng, "int8", xs, ws)
        s = rng.random(ws[-1]).astype(np.float32) * 1e-3
        return (jx, tx), (jw, tw), (jnp.asarray(s), torch.from_numpy(s))
    return (*_conv_operands(rng, dtype, xs, ws), (None, None))


def _fused_reference(style, jx, jw, js, window, stride, mode, kind):
    """The reference's fused kernel in interpret mode; for a window of
    thousands of taps, whose interpret-mode trace takes about a minute,
    the reference's family oracles chained (conv, the int8 rung's
    rescale, pool, activation)."""
    from repro.kernels.activation.ref import activation_ref
    from repro.kernels.conv2d.ref import conv2d_ref
    from repro.kernels.pool2d.ref import pool2d_ref
    if window[0] * window[1] <= 64:
        jfn = j_fused.fused_cnn_vpu if style == "vpu" else j_fused.fused_cnn_mxu
        return jfn(jx, jw, js, pool_window=window, pool_stride=stride,
                   pool_mode=mode, act_kind=kind)
    y = conv2d_ref(jx, jw)
    if js is not None:
        y = y.astype(jnp.float32) * js
    return activation_ref(pool2d_ref(y, window=window, stride=stride,
                                     mode=mode).astype(jnp.float32),
                          kind=kind)


@pytest.mark.parametrize("style", ["vpu", "mxu"])
@pytest.mark.parametrize("dtype", ["float32", "int8", "int8-rung", "int16",
                                   "bfloat16"])
@pytest.mark.parametrize("xs,ws,window,stride,mode,kind,smem", FUSED_PLANS,
                         ids=FUSED_PLAN_IDS)
def test_fused_tile_plan_emulation(rng, style, dtype, xs, ws, window,
                                   stride, mode, kind, smem):
    """The fused kernel's cut in pooled space (``inner.fused_plan``)
    writes every pooled output once, each CTA's bands hold every tap of
    its windows, and the band-by-band computation from only what a CTA
    stages is bitwise equal to ``fused_cnn_plain`` and matches the
    reference (integers exactly; floats and the int8 rung's f32 rescale
    at the float32 tolerance)."""
    (jx, tx), (jw, tw), (js, ts) = _fused_operands(rng, dtype, xs, ws)
    n, h, w_, cin = xs
    kh, kw, _, cout = ws
    kwargs = {} if smem is None else dict(smem_bytes=smem)
    plan = t_inner.fused_plan(h, w_, cin, kh, kw, cout, *window, *stride,
                              itemsize=tx.element_size(), style=style,
                              **kwargs)
    tile = plan.tile
    assert tile.th * tile.tw == (t_inner.THREADS >> tile.glog) * t_inner.PIXELS
    assert tile.tw >= window[1] or tile.th == 1
    assert t_inner.fused_smem_bytes(plan, kh, kw, cin,
                                    itemsize=tx.element_size(),
                                    style=style) <= t_inner.SMEM_BYTES
    assert tile.whole == (smem is None)
    got, hits = _fused_tiles(tx, tw, ts, plan, style, window, stride, mode,
                             kind)
    assert (hits == 1).all()
    kw_ = dict(pool_window=window, pool_stride=stride, pool_mode=mode,
               act_kind=kind)
    assert torch.equal(got, t_fused.fused_cnn_plain(style, tx, tw, ts, **kw_))
    want = _np(_fused_reference(style, jx, jw, js, window, stride, mode,
                                kind))
    if tx.is_floating_point() or ts is not None:
        np.testing.assert_allclose(_np(got), want, **F32)
    else:
        np.testing.assert_array_equal(_np(got), want)


def test_fused_plan_cuts():
    """The served blocks' fused plans are the tiled convs' cuts (one band
    a CTA), a window past the tile's rows walks row bands, one past 32
    columns widens the tile, one past the widest band walks one-row
    bands in column segments; ``style`` is checked."""
    for args, size, style in (((224, 224, 3, 3, 3, 16, 2, 2, 2, 2), 4, "vpu"),
                              ((111, 111, 16, 3, 3, 32, 2, 2, 2, 2), 4,
                               "mxu")):
        plan = t_inner.fused_plan(*args, itemsize=size, style=style)
        conv = t_inner.tile_plan(*args[:6], itemsize=size, style=style)
        assert plan.tile == conv
        assert (plan.row_bands, plan.col_segs) == (1, 1)
        assert (plan.tp, plan.tq) == (conv.th // 2, conv.tw // 2)
    tall = t_inner.fused_plan(30, 70, 16, 3, 3, 40, 12, 5, 3, 2, itemsize=4)
    assert (tall.tp, tall.row_bands, tall.col_segs) == (1, 2, 1)
    wide = t_inner.fused_plan(30, 70, 16, 3, 3, 40, 2, 40, 2, 3, itemsize=4)
    assert wide.tile.tw == 64 and wide.col_segs == 1
    segs = t_inner.fused_plan(3, 2100, 2, 1, 1, 4, 3, 2090, 1, 3, itemsize=4)
    assert (segs.tile.th, segs.tile.tw, segs.tq) == (1, 2048, 1)
    assert (segs.row_bands, segs.col_segs) == (3, 2)
    with pytest.raises(ValueError, match="unknown style"):
        t_inner.fused_plan(8, 8, 3, 3, 3, 4, 2, 2, 2, 2, itemsize=4,
                           style="packed")


def _conv3_tiles(xa, xb, w, plan):
    """``conv2d_ip3_tiled_kernel``'s arithmetic and cut on the CPU: each
    tile of ``plan`` from its staged packed pairs p = a * 2^16 + b (the
    halo, or per (tap, chunk) the shifted tile's chunk), the products
    p * w taken a block at a time (channels 0-1 and 2-3 of each whole
    quad, the channels past the last quad one at a time): m = the
    block's sum plus 32512 * (2^16 + 1), mod 2^32, into sum_m, and m's
    high half into sum_a; at the end the b stream's biased sum is sum_m
    - sum_a * 2^16 and both shed the bias of their blocks.  Asserts that
    m holds both streams' biased block sums exactly.  Returns both
    streams (int32, wrapping) and the tiles that wrote each output."""
    n, h, w_, cin = xa.shape
    kh, kw, _, cout = w.shape
    ho, wo = h - kh + 1, w_ - kw + 1
    bias, mod = 32512, 2 ** 32
    packed = xa.to(torch.int64) * 2 ** 16 + xb.to(torch.int64)
    a64, b64, wl = xa.to(torch.int64), xb.to(torch.int64), w.to(torch.int64)
    ya = torch.zeros((n, ho, wo, cout), dtype=torch.int32)
    yb = torch.zeros_like(ya)
    hits = torch.zeros_like(ya)
    chunks = [(c, min(c + plan.cc, cin)) for c in range(0, cin, plan.cc)]
    for b in range(n):
        for h0 in range(0, ho, plan.th):
            for w0 in range(0, wo, plan.tw):
                for c0 in range(0, cout, plan.bc):
                    r, c, q = (min(plan.th, ho - h0), min(plan.tw, wo - w0),
                               min(plan.bc, cout - c0))
                    halo = packed[b, h0:h0 + plan.th + kh - 1,
                                  w0:w0 + plan.tw + kw - 1]
                    sum_m = torch.zeros((r, c, q), dtype=torch.int64)
                    sum_a = torch.zeros_like(sum_m)
                    blocks = 0
                    for i in range(kh):
                        for j in range(kw):
                            for ca, cb in chunks:
                                rows = slice(h0 + i, h0 + i + r)
                                cols = slice(w0 + j, w0 + j + c)
                                box = (halo[i:i + r, j:j + c, ca:cb]
                                       if plan.whole else
                                       packed[b, rows, cols, ca:cb])
                                assert box.shape == (r, c, cb - ca)
                                n4 = (cb - ca) // 4 * 4
                                runs = [range(k, k + 2)
                                        for k in range(0, n4, 2)]
                                runs += [range(k, k + 1)
                                         for k in range(n4, cb - ca)]
                                for run in runs:
                                    taps = [(ca + k, k) for k in run]
                                    wq = [wl[i, j, cc, c0:c0 + q]
                                          for cc, _ in taps]
                                    m = (sum(box[..., k, None] * wk for
                                             (_, k), wk in zip(taps, wq))
                                         + bias * (2 ** 16 + 1)) % mod
                                    # m holds both streams' biased block
                                    # sums, no carry between its halves
                                    ab, bb = (sum(s_[b, rows, cols, cc, None]
                                                  * wk for (cc, _), wk in
                                                  zip(taps, wq)) + bias
                                              for s_ in (a64, b64))
                                    assert ((ab >= 0) & (ab < 2 ** 16)
                                            & (bb >= 0) & (bb < 2 ** 16)).all()
                                    assert torch.equal(m, ab * 2 ** 16 + bb)
                                    sum_m = sum_m + m
                                    sum_a = sum_a + m // 2 ** 16
                                    blocks += 1
                    ya[b, h0:h0 + r, w0:w0 + c, c0:c0 + q] = _wrap32(
                        sum_a - blocks * bias)
                    yb[b, h0:h0 + r, w0:w0 + c, c0:c0 + q] = _wrap32(
                        sum_m - sum_a * 2 ** 16 - blocks * bias)
                    hits[b, h0:h0 + r, w0:w0 + c, c0:c0 + q] += 1
    return ya, yb, hits


# (x, w, shared memory the plan may use): the halo whole with Cin 30 (a
# tap's seven quads of two-pair blocks and two one-pair blocks), and a
# small budget that chunks Cin 42 (its last chunk ends past a quad)
CONV3_PLANS = [((1, 10, 20, 30), (3, 3, 30, 32), None),
               ((1, 5, 7, 42), (3, 3, 42, 5), 4096)]


def _wrap32(v):
    """int64 -> the int32 that a wrapping 32-bit sum holds."""
    return ((v + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


@pytest.mark.parametrize("fill", ["extreme", "random"])
@pytest.mark.parametrize("xs,ws,smem", CONV3_PLANS, ids=["whole", "chunked"])
def test_conv3_packed_recovery_emulation(rng, fill, xs, ws, smem):
    """Conv3's two-pair blocks split exactly: on operands all -128 (every
    block's stream sums at 32768, the top of the biased 16 bits) and on
    full-range int8, the tile-by-tile recovery is bitwise
    ``conv2d_ip3_plain``, the reference's ``conv2d_ip3`` and two
    ``conv2d_ip1`` convs."""
    if fill == "extreme":
        arrs = [np.full(s, -128, np.int8) for s in (xs, xs, ws)]
    else:
        arrs = [rng.integers(-128, 127, s, endpoint=True).astype(np.int8)
                for s in (xs, xs, ws)]
    (jxa, txa), (jxb, txb), (jw, tw) = (_both(a) for a in arrs)
    n, h, w_, cin = xs
    kh, kw, _, cout = ws
    kwargs = {} if smem is None else dict(smem_bytes=smem)
    plan = t_inner.tile_plan(h, w_, cin, kh, kw, cout, itemsize=1,
                             style="packed", **kwargs)
    assert plan.whole == (smem is None)
    if not plan.whole:
        assert cin % plan.cc % 4 != 0
    assert t_inner.tile_smem_bytes(plan, kh, kw, cin, itemsize=1,
                                   style="packed") <= t_inner.SMEM_BYTES
    ya, yb, hits = _conv3_tiles(txa, txb, tw, plan)
    assert (hits == 1).all()
    pa, pb = t_ip3.conv2d_ip3_plain(txa, txb, tw)
    assert torch.equal(ya, pa) and torch.equal(yb, pb)
    assert torch.equal(ya, t_ip1.conv2d_ip1_plain(txa, tw))
    assert torch.equal(yb, t_ip1.conv2d_ip1_plain(txb, tw))
    ja, jb = j_ip3.conv2d_ip3(jxa, jxb, jw)
    np.testing.assert_array_equal(_np(ya), _np(ja))
    np.testing.assert_array_equal(_np(yb), _np(jb))


# --------------------------------------------------------------------------
# Footprints: every ported footprint function returns the reference's
# --------------------------------------------------------------------------
CONV_FP_ARGS = [(1, 224, 224, 3, 3, 3, 16), (4, 111, 111, 16, 3, 3, 32),
                (2, 12, 12, 6, 3, 3, 12), (2, 9, 11, 2, 2, 2, 300)]
POOL_FP_ARGS = [(4, 222, 222, 16, 2, 2, 2, 2), (2, 10, 11, 5, 3, 3, 2, 2),
                (1, 7, 7, 200, 2, 3, 1, 2)]
FUSED_FP_ARGS = [(4, 224, 224, 3, 3, 3, 16, 2, 2, 2, 2),
                 (4, 111, 111, 16, 3, 3, 32, 2, 2, 2, 2),
                 (2, 12, 12, 4, 3, 3, 200, 3, 3, 1, 1)]


def _fp_cases():
    for jm, tm in ((j_ip1, t_ip1), (j_ip2, t_ip2), (j_ip3, t_ip3),
                   (j_ip4, t_ip4)):
        for args in CONV_FP_ARGS:
            for kw in ({"itemsize": 4}, {"itemsize": 1},
                       {"itemsize": 2, "block_cout": 64}):
                yield jm.footprint, tm.footprint, args, kw
    for jm, tm in ((j_pool, t_pool), (j_im2col, t_im2col)):
        for args in POOL_FP_ARGS:
            for kw in ({"itemsize": 4, "mode": "max"},
                       {"itemsize": 1, "mode": "avg"},
                       {"itemsize": 4, "mode": "avg", "block_c": 8}):
                yield jm.footprint, tm.footprint, args, kw
    for jm, tm in ((j_act, t_act), (j_lut, t_lut)):
        for n in (1, 1000, 4 * 111 * 111 * 16):
            for kw in ({"itemsize": 4, "kind": "relu"},
                       {"itemsize": 2, "kind": "tanh"},
                       {"itemsize": 1, "kind": "gelu", "block_rows": 8}):
                yield jm.footprint, tm.footprint, (n,), kw
    for jf, tf in ((j_fused.footprint_vpu, t_fused.footprint_vpu),
                   (j_fused.footprint_mxu, t_fused.footprint_mxu)):
        for args in FUSED_FP_ARGS:
            for kw in ({"itemsize": 4, "mode": "max", "kind": "relu"},
                       {"itemsize": 1, "mode": "avg", "kind": "tanh"},
                       {"itemsize": 4, "kind": "gelu", "block_cout": 16}):
                yield jf, tf, args, kw


def test_footprints_equal_reference():
    n = 0
    for jf, tf, args, kw in _fp_cases():
        assert dataclasses.asdict(tf(*args, **kw)) == \
            dataclasses.asdict(jf(*args, **kw)), (tf.__module__, args, kw)
        n += 1
    assert n == 4 * 4 * 3 + 2 * 3 * 3 + 2 * 3 * 3 + 2 * 3 * 3


# --------------------------------------------------------------------------
# Named errors at the package boundary
# --------------------------------------------------------------------------
def test_named_errors():
    x = torch.zeros((1, 6, 6, 2))
    w = torch.zeros((3, 3, 2, 4))
    with pytest.raises(ValueError, match="unknown pool mode"):
        t_pool2d(x, mode="median")
    with pytest.raises(ValueError, match="exceeds the input plane"):
        t_pool2d(x, window=(7, 7))
    with pytest.raises(KeyError, match="not a single-stream conv IP"):
        t_conv2d(x, w, ip="ip9_magic")
    with pytest.raises(KeyError, match="not a pool2d IP"):
        t_pool2d(x, ip="pool_magic")
    with pytest.raises(KeyError, match="not an activation IP"):
        t_activation(x, ip="act_magic")
    with pytest.raises(ValueError, match="unknown activation"):
        t_activation(x, kind="swish", ip="act_vpu")
    with pytest.raises(KeyError, match="not a fused CNN-block IP"):
        t_fused_block(x, w, ip="fused_magic")
    with pytest.raises(ValueError, match="unknown activation"):
        t_fused_block(x, w, activation="swish", ip="fused_vpu")
    with pytest.raises(ValueError, match="exceeds the input plane"):
        t_fused_block(x, w, pool_window=(5, 5), ip="fused_vpu")
    with pytest.raises(ValueError, match="block_cout"):
        t_conv2d(x, w, ip="ip1_vpu", block_cout=0)
    with pytest.raises(KeyError, match="not a dual-stream conv IP"):
        t_conv2d_dual(x, x, w, ip="ip1_vpu")


def test_budget_path_selects_and_runs(rng):
    """``budget=`` goes through plan_single; the result equals the
    explicitly named member's."""
    from repro_torch.core.resources import ResourceBudget
    x = torch.from_numpy(_randn(rng, (1, 10, 10, 3)))
    w = torch.from_numpy(_randn(rng, (3, 3, 3, 4)))
    logic_only = ResourceBudget(mxu_available=False)
    assert torch.equal(t_conv2d(x, w, budget=logic_only),
                       t_conv2d(x, w, ip="ip1_vpu"))
    assert torch.equal(t_fused_block(x, w, budget=logic_only),
                       t_fused_block(x, w, ip="fused_vpu"))
    y = t_conv2d(x, w)
    assert torch.equal(t_pool2d(y), t_pool2d(y, ip="pool_vpu"))
    assert torch.equal(t_activation(y, kind="tanh"),
                       t_activation(y, kind="tanh", ip="act_vpu"))
