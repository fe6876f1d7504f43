"""The port's fixed-point subsystem (``repro_torch.quant``) and its two
new kernels' plain versions (Act2 ``activation_lut``, Pool2
``pool2d_im2col``) against the reference (``repro.quant``, Pallas in
interpret mode on CPU).  Inputs are made with numpy from a seed and fed
to both packages.

Tolerances: quantization codes and scales bit-exact (both divide and
round half to even in f32); the 8-bit quantized conv and pool bit-exact
(integer accumulation, elementwise rescale); 16-bit fake-quant, the
quantized activation and the quantized fused block ``rtol=1e-4,
atol=1e-5`` (float sums in another order than XLA; the fused int8
rung's f32 rescale contracts into FMAs under XLA, ROADMAP queue 3); the
LUT ``1e-6`` (``torch.linspace`` and ``jnp.linspace`` differ by up to an
ulp at some table points); relative errors ``1e-6``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.resources import ResourceBudget as JBudget
from repro.kernels.activation import lut_poly as j_lut
from repro.kernels.activation.ops import activation as j_activation
from repro.kernels.conv2d.ops import conv2d as j_conv2d
from repro.kernels.fused.ops import fused_cnn_block as j_fused_block
from repro.kernels.pool2d import mxu_im2col as j_im2col
from repro.kernels.pool2d.ops import pool2d as j_pool2d
from repro.quant import calibrate as j_cal
from repro.quant import ops as j_ops
from repro.quant import quantize as j_q
from repro.quant import report as j_report
from repro_torch.core.resources import ResourceBudget as TBudget
from repro_torch.kernels.activation import lut_poly as t_lut
from repro_torch.kernels.activation.ops import activation as t_activation
from repro_torch.kernels.conv2d.ops import conv2d as t_conv2d
from repro_torch.kernels.fused.ops import fused_cnn_block as t_fused_block
from repro_torch.kernels.pool2d import mxu_im2col as t_im2col
from repro_torch.kernels.pool2d.ops import pool2d as t_pool2d
from repro_torch.quant import calibrate as t_cal
from repro_torch.quant import ops as t_ops
from repro_torch.quant import quantize as t_q
from repro_torch.quant import report as t_report

F32 = dict(rtol=1e-4, atol=1e-5)
TIGHT = dict(rtol=1e-6, atol=1e-6)


def _both(a):
    """One numpy array as (jax array, torch CPU tensor)."""
    return jnp.asarray(a), torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _randn(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _exact(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# (a) quantize core: codes and scales bit-exact
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_weights_bit_exact(rng, bits, axis):
    jw, tw = _both(_randn(rng, (3, 3, 5, 7), 0.3))
    want, got = j_q.quantize_weights(jw, axis=axis, bits=bits), \
        t_q.quantize_weights(tw, axis=axis, bits=bits)
    _exact(got.q, want.q)
    _exact(got.scale, want.scale)
    _exact(t_q.dequantize(got), j_q.dequantize(want))


@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_acts_batch_scale_bit_exact(rng, bits):
    jx, tx = _both(_randn(rng, (2, 6, 6, 4), 3.0))
    want, got = j_q.quantize_acts(jx, bits=bits), \
        t_q.quantize_acts(tx, bits=bits)
    _exact(got.q, want.q)
    _exact(got.scale, want.scale)
    assert got.scale.dim() == 0
    _exact(t_q.dequantize(got), j_q.dequantize(want))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("axis", [None, -1])
def test_bf16_operands_quantize_bit_exact(rng, bits, axis):
    """bf16 operands (the budget sweep's lowered FFN site quantizes bf16
    activations): codes divide in f32 as the reference's promotion does.
    Under PyTorch's promotion a 0-dim f32 scale left the quotient in bf16
    and moved about 7% of the per-tensor codes."""
    x = _randn(rng, (64, 32), 2.0)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    if axis is None:
        want, got = j_q.quantize_acts(jx, bits=bits), \
            t_q.quantize_acts(tx, bits=bits)
    else:
        want, got = j_q.quantize_weights(jx, axis=axis, bits=bits), \
            t_q.quantize_weights(tx, axis=axis, bits=bits)
    _exact(got.q, want.q)
    _exact(got.scale, want.scale)
    _exact(t_q.fake_quant(tx, bits=bits, axis=axis),
           j_q.fake_quant(jx, bits=bits, axis=axis))


@pytest.mark.parametrize("scale", [0.01, 0.0173])
def test_quantize_acts_calibrated_scale_saturates(rng, scale):
    """A calibrated scale narrower than the batch saturates at +-qmax."""
    jx, tx = _both(_randn(rng, (64,), 2.0))
    want, got = j_q.quantize_acts(jx, scale=scale), \
        t_q.quantize_acts(tx, scale=scale)
    _exact(got.q, want.q)
    _exact(got.scale, want.scale)
    assert int(got.q.abs().max()) == t_q.qmax(8)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("axis", [None, -1])
def test_fake_quant_bit_exact(rng, bits, axis):
    jx, tx = _both(_randn(rng, (4, 9, 6)))
    _exact(t_q.fake_quant(tx, bits=bits, axis=axis),
           j_q.fake_quant(jx, bits=bits, axis=axis))


def test_exact_half_step_ties_round_to_even():
    """x / scale lands exactly on k + 0.5: both round half to even."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 3.0],
                 np.float32)
    jx, tx = _both(x)
    want = j_q.quantize_acts(jx, scale=1.0)
    got = t_q.quantize_acts(tx, scale=1.0)
    _exact(got.q, want.q)
    assert got.q.tolist() == [0, 2, 2, 0, -2, -2, 126, 3]


def test_all_zero_and_min_scale_bit_exact():
    jz, tz = _both(np.zeros((2, 3, 3, 4), np.float32))
    for fn_j, fn_t in ((j_q.quantize_acts, t_q.quantize_acts),
                       (j_q.quantize_weights, t_q.quantize_weights)):
        want, got = fn_j(jz), fn_t(tz)
        _exact(got.q, want.q)
        _exact(got.scale, want.scale)
        assert torch.isfinite(t_q.dequantize(got)).all()
        assert not t_q.dequantize(got).any()
    # one all-zero output channel among live ones
    w = np.ones((3, 3, 2, 3), np.float32)
    w[..., 1] = 0.0
    jw, tw = _both(w)
    _exact(t_q.quantize_weights(tw).scale, j_q.quantize_weights(jw).scale)
    assert float(t_q.quantize_weights(tw).scale[..., 1]) == \
        np.float32(t_q.MIN_SCALE) / np.float32(127)


def test_code_dtype_and_bad_width():
    assert t_q.code_dtype(8) == torch.int8
    assert t_q.code_dtype(16) == torch.int16
    assert t_q.qmax(8) == j_q.qmax(8) == 127
    with pytest.raises(ValueError, match="unsupported quantization width"):
        t_q.quantize_acts(torch.zeros(3), bits=12)


@pytest.mark.parametrize("axis", [None, -1])
def test_quantization_error_matches(rng, axis):
    jx, tx = _both(_randn(rng, (16, 8)))
    np.testing.assert_allclose(
        t_q.quantization_error(tx, axis=axis),
        j_q.quantization_error(jx, axis=axis), **TIGHT)


def test_int8_matmul_bit_exact_and_kernel_seam(rng):
    jx, tx = _both(_randn(rng, (5, 12)))
    jw, tw = _both(_randn(rng, (12, 6), 0.3))
    want = j_q.int8_matmul(jx, j_q.quantize_weights(jw))
    got = t_q.int8_matmul(tx, t_q.quantize_weights(tw))
    _exact(got, want)
    # the kernel seam (mm_mxu's int8 path; its plain version on the CPU)
    _exact(t_q.int8_matmul(tx, t_q.quantize_weights(tw), use_kernel=True),
           j_q.int8_matmul(jx, j_q.quantize_weights(jw), use_kernel=True))
    _exact(t_ops.quantized_matmul(tx, tw), j_ops.quantized_matmul(jx, jw))


def test_core_quantize_reexports_the_subsystem():
    from repro_torch.core import quantize as shim
    assert shim.quantize_acts is t_q.quantize_acts
    assert shim.MIN_SCALE == t_q.MIN_SCALE


# --------------------------------------------------------------------------
# (a) calibration and reports
# --------------------------------------------------------------------------
@pytest.mark.parametrize("momentum", [None, 0.9])
def test_calibrator_matches_reference(rng, momentum):
    jc, tc = j_cal.Calibrator(momentum), t_cal.Calibrator(momentum)
    for i in range(4):
        jx, tx = _both(_randn(rng, (3, 5), 1.0 + i))
        for site in ("a", "b"):
            jc.observe(site, jx * (2 if site == "b" else 1))
            tc.observe(site, tx * (2 if site == "b" else 1))
    assert tc.to_dict() == jc.to_dict()
    assert tc.sites() == jc.sites()
    for bits in (8, 16):
        assert tc.scale("a", bits=bits) == jc.scale("a", bits=bits)
    jx, tx = _both(_randn(rng, (7,), 4.0))
    want, got = jc.quantize("b", jx), tc.quantize("b", tx)
    _exact(got.q, want.q)
    _exact(got.scale, want.scale)
    back = t_cal.Calibrator.from_dict(tc.to_dict())
    assert back.to_dict() == tc.to_dict()
    with pytest.raises(KeyError, match="never observed"):
        tc.scale("zzz")


def test_report_relative_error_and_summary(rng):
    jg, tg = _both(_randn(rng, (4, 6)))
    jr, tr = _both(_randn(rng, (4, 6)))
    np.testing.assert_allclose(t_report.relative_error(tg, tr),
                               j_report.relative_error(jg, jr), **TIGHT)
    zero = np.zeros((3,), np.float32)
    assert t_report.relative_error(*_both(zero)[1:], torch.zeros(3)) == 0.0
    jrep, trep = {}, {}
    for bits, site in ((8, "s.conv"), (32, "s.pool"), (16, "s.act")):
        j_report.record(jrep, site, bits, jg * bits, jr)
        t_report.record(trep, site, bits, tg * bits, tr)
    assert sorted(trep) == sorted(jrep)
    for lowered_only in (True, False):
        np.testing.assert_allclose(
            t_report.max_rel_error(trep, lowered_only=lowered_only),
            j_report.max_rel_error(jrep, lowered_only=lowered_only),
            **TIGHT)
    assert [ln.split()[:2] for ln in t_report.summarize(trep).splitlines()] \
        == [ln.split()[:2] for ln in j_report.summarize(jrep).splitlines()]
    assert t_report.max_rel_error({}) == 0.0


# --------------------------------------------------------------------------
# (b) quantized execution per family
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ip", ["ip1_vpu", "ip2_mxu"])
def test_quantized_conv2d_int8_bit_exact(rng, ip):
    (jx, tx), (jw, tw) = _both(_randn(rng, (2, 9, 9, 4))), \
        _both(_randn(rng, (3, 3, 4, 6), 0.2))
    _exact(t_ops.quantized_conv2d(tx, tw, bits=8, ip=ip),
           j_ops.quantized_conv2d(jx, jw, bits=8, ip=ip))
    acc, scale = t_ops.quantized_conv2d(tx, tw, bits=8, ip=ip,
                                        return_scale=True)
    jacc, jscale = j_ops.quantized_conv2d(jx, jw, bits=8, ip=ip,
                                          return_scale=True)
    _exact(acc, jacc)
    _exact(scale, jscale)
    assert acc.dtype == torch.int32 and tuple(scale.shape) == (1, 1, 1, 6)


@pytest.mark.parametrize("ip", ["ip1_vpu", "ip2_mxu"])
def test_quantized_conv2d_16bit_close(rng, ip):
    (jx, tx), (jw, tw) = _both(_randn(rng, (2, 9, 9, 4))), \
        _both(_randn(rng, (3, 3, 4, 6), 0.2))
    got, none = t_ops.quantized_conv2d(tx, tw, bits=16, ip=ip,
                                       return_scale=True)
    assert none is None
    np.testing.assert_allclose(
        _np(got), _np(j_ops.quantized_conv2d(jx, jw, bits=16, ip=ip)), **F32)


@pytest.mark.parametrize("ip", ["pool_vpu", "pool_im2col"])
@pytest.mark.parametrize("mode", ["max", "avg"])
def test_quantized_pool2d_matches(rng, ip, mode):
    jx, tx = _both(_randn(rng, (2, 8, 8, 5)))
    _exact(t_ops.quantized_pool2d(tx, mode=mode, bits=8, ip=ip),
           j_ops.quantized_pool2d(jx, mode=mode, bits=8, ip=ip))
    np.testing.assert_allclose(
        _np(t_ops.quantized_pool2d(tx, mode=mode, bits=16, ip=ip)),
        _np(j_ops.quantized_pool2d(jx, mode=mode, bits=16, ip=ip)), **F32)


@pytest.mark.parametrize("kind,ip", [("relu", "act_vpu"),
                                     ("tanh", "act_vpu"),
                                     ("tanh", "act_lut"),
                                     ("sigmoid", "act_lut")])
@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_activation_close(rng, kind, ip, bits):
    jx, tx = _both(_randn(rng, (3, 5, 7), 3.0))
    np.testing.assert_allclose(
        _np(t_ops.quantized_activation(tx, kind=kind, bits=bits, ip=ip)),
        _np(j_ops.quantized_activation(jx, kind=kind, bits=bits, ip=ip)),
        **F32)


@pytest.mark.parametrize("ip", ["fused_vpu", "fused_mxu"])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("mode,kind", [("max", "relu"), ("avg", "tanh")])
def test_quantized_fused_cnn_block_close(rng, ip, bits, mode, kind):
    (jx, tx), (jw, tw) = _both(_randn(rng, (2, 10, 10, 4))), \
        _both(_randn(rng, (3, 3, 4, 8), 0.2))
    kw = dict(bits=bits, ip=ip, pool_mode=mode, activation=kind)
    np.testing.assert_allclose(
        _np(t_ops.quantized_fused_cnn_block(tx, tw, **kw)),
        _np(j_ops.quantized_fused_cnn_block(jx, jw, **kw)), **F32)


def test_quantized_ops_reject_native_width():
    with pytest.raises(ValueError, match="lowered width"):
        t_ops.quantized_conv2d(torch.zeros(1, 4, 4, 1),
                               torch.zeros(3, 3, 1, 1), bits=32)


# --------------------------------------------------------------------------
# the op wrappers run the plans the ladder lowered
# --------------------------------------------------------------------------
CONV_XW = ((2, 16, 16, 8), (3, 3, 8, 16))
LOWERED_CALLS = {
    # family: (shapes, site kwargs, {KiB of VMEM: the width it lowers to})
    "conv2d": (CONV_XW, dict(dual=False), {16: 8, 20: 16}),
    "cnn_fused": (CONV_XW, dict(window=(2, 2), stride=None, mode="max",
                                kind="relu"), {20: 8, 24: 16}),
    "pool2d": (((2, 40, 40, 8),), dict(window=(2, 2), stride=(2, 2),
                                       mode="max"), {16: 8, 32: 16}),
    "activation": (((2, 40, 40, 8),), dict(kind="tanh"), {128: 8,
                                                          160: 16}),
}


def _call(pkg, family, args, budget, ladder):
    conv, fused, pool, act = (
        (j_conv2d, j_fused_block, j_pool2d, j_activation) if pkg == "j"
        else (t_conv2d, t_fused_block, t_pool2d, t_activation))
    if family == "conv2d":
        return conv(*args, budget=budget, ladder=ladder)
    if family == "cnn_fused":
        return fused(*args, budget=budget, ladder=ladder)
    if family == "pool2d":
        return pool(*args, budget=budget, ladder=ladder)
    return act(*args, kind="tanh", budget=budget, ladder=ladder)


@pytest.mark.parametrize("family,kib", [
    (fam, kib) for fam, (_, _, widths) in LOWERED_CALLS.items()
    for kib in widths])
def test_ops_wrappers_execute_lowered_plans(rng, family, kib):
    """The budget lowers the wrapper's site in both packages to the same
    member and width, and the port returns the reference's float
    result."""
    from repro.core.ip import SiteSpec as JSpec
    from repro.core.plan import plan_single as j_plan
    from repro_torch.core.ip import SiteSpec as TSpec
    from repro_torch.core.plan import plan_single as t_plan
    shapes, site_kw, widths = LOWERED_CALLS[family]
    jb, tb = JBudget(vmem_bytes=kib * 1024), TBudget(vmem_bytes=kib * 1024)
    jp = j_plan(JSpec.make(family, family, shapes, "float32",
                           ladder=(16, 8), **site_kw), jb)
    tp = t_plan(TSpec.make(family, family, shapes, "float32",
                           ladder=(16, 8), **site_kw), tb)
    assert (tp.ip.name, tp.precision_bits) == \
        (jp.ip.name, jp.precision_bits)
    assert tp.precision_bits == widths[kib]
    arrays = [_randn(rng, shapes[0])] + \
        [_randn(rng, s, 0.1) for s in shapes[1:]]
    pairs = [_both(a) for a in arrays]
    got = _call("t", family, [t for _, t in pairs], tb, (16, 8))
    want = _call("j", family, [j for j, _ in pairs], jb, (16, 8))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# --------------------------------------------------------------------------
# (c) Act2: the repaired NaN/inf rule and exact ties
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["tanh", "sigmoid", "relu6"])
def test_lut_nan_and_inf_match_reference(kind):
    x = np.array([np.nan, 1.0, -np.inf, np.inf, 0.0], np.float32)
    jx, tx = _both(x)
    got = _np(t_lut.activation_lut(tx, kind=kind))
    want = _np(j_lut.activation_lut(jx, kind=kind))
    np.testing.assert_allclose(got, want, **TIGHT)
    table = _np(t_lut.build_table(kind))
    assert got[0] == table[0] and got[2] == table[0] and got[3] == table[-1]


@pytest.mark.parametrize("kind", ["tanh", "sigmoid"])
def test_lut_exact_half_step_ties_match_reference(kind):
    """Inputs where (x + r) * s is exactly k + 0.5 in f32: the index
    rounds half to even in both packages."""
    r, s = t_lut.RANGES[kind], np.float32(t_lut.lut_scale(kind))
    k = np.arange(0, 255, dtype=np.float32)
    x = ((k + np.float32(0.5)) / s - np.float32(r)).astype(np.float32)
    x = x[(x + np.float32(r)) * s == k + np.float32(0.5)]
    assert x.size > 100
    jx, tx = _both(x)
    np.testing.assert_allclose(_np(t_lut.activation_lut(tx, kind=kind)),
                               _np(j_lut.activation_lut(jx, kind=kind)),
                               **TIGHT)
    idx = torch.round((tx + r) * float(s)).long()
    assert bool((idx % 2 == 0).all())            # ties went to even


@pytest.mark.parametrize("dtype", ["int8", "int32"])
def test_lut_integer_input_gives_f32(rng, dtype):
    jx, tx = _both(rng.integers(-9, 9, (4, 7)).astype(dtype))
    got = t_lut.activation_lut(tx, kind="tanh")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got),
                               _np(j_lut.activation_lut(jx, kind="tanh")),
                               **TIGHT)


def test_lut_table_cached_per_kind_and_device():
    a = t_lut.table_for("tanh", "cpu")
    assert t_lut.table_for("tanh", torch.device("cpu")) is a
    assert t_lut.table_for("sigmoid", "cpu") is not a
    np.testing.assert_allclose(_np(a), _np(j_lut.build_table("tanh")),
                               **TIGHT)
    with pytest.raises(ValueError, match="block_rows"):
        t_lut.activation_lut(torch.zeros(3), block_rows=0)
    with pytest.raises(ValueError, match="saturating kinds"):
        t_lut.activation_lut(torch.zeros(3), kind="gelu")


# --------------------------------------------------------------------------
# Pool2 plain version and (g) the budget path that picks it
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["int8", "int32"])
@pytest.mark.parametrize("mode", ["max", "avg"])
def test_pool_im2col_int_bit_exact_with_floor(rng, dtype, mode):
    jx, tx = _both(rng.integers(-120, 120, (2, 9, 9, 4)).astype(dtype))
    kw = dict(window=(3, 3), stride=(2, 2), mode=mode)
    want = j_im2col.pool2d_im2col(jx, **kw)
    _exact(t_im2col.pool2d_im2col(tx, **kw), want)
    if mode == "avg":
        assert (_np(want) < 0).any()


def test_pool_im2col_nan_and_tile_hint():
    x = torch.zeros((1, 4, 4, 3))
    x[0, 1, 1, 0] = float("nan")
    y = t_im2col.pool2d_im2col(x)
    assert torch.isnan(y[0, 0, 0, 0]) and not torch.isnan(y[0, 1, 1, 0])
    z = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 6, 6, 5)).astype(np.float32))
    assert torch.equal(t_im2col.pool2d_im2col(z, block_c=2, mode="avg"),
                       t_im2col.pool2d_im2col(z, mode="avg"))
    with pytest.raises(ValueError, match="block_c"):
        t_im2col.pool2d_im2col(z, block_c=0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("ladder", [(), (16, 8)])
def test_pool_budget_path_picks_im2col_like_reference(rng, dtype, ladder):
    """pool2d(mode="avg", budget=VPU-limited) picks pool_im2col in both
    packages, and the port's result is the reference's."""
    from repro.core.ip import SiteSpec as JSpec
    from repro.core.plan import plan_single as j_plan
    from repro_torch.core.ip import SiteSpec as TSpec
    from repro_torch.core.plan import plan_single as t_plan
    x = (_randn(rng, (2, 40, 40, 8)) if dtype == "float32"
         else rng.integers(-100, 100, (2, 40, 40, 8)).astype(np.int8))
    jx, tx = _both(x)
    kw = dict(ladder=ladder, window=(2, 2), stride=(2, 2), mode="avg")
    budget = dict(vpu_ops_budget=40_000)   # Pool1 needs 51200 ops
    jp = j_plan(JSpec.make("pool2d", "pool2d", (x.shape,), dtype, **kw),
                JBudget(**budget))
    tp = t_plan(TSpec.make("pool2d", "pool2d", (x.shape,), dtype, **kw),
                TBudget(**budget))
    assert tp.ip.name == jp.ip.name == "pool2d.pool_im2col"
    assert tp.precision_bits == jp.precision_bits
    got = t_pool2d(tx, mode="avg", budget=TBudget(**budget), ladder=ladder)
    want = j_pool2d(jx, mode="avg", budget=JBudget(**budget), ladder=ladder)
    if dtype == "int8":
        _exact(got, want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **TIGHT)
