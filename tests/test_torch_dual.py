"""The port's dual-stream convs (Conv3 ``ip3_packed``, Conv4 ``ip4_dual``,
``conv2d_dual``) and its selector shims and fixed-IP baselines against
the reference (``repro``; Pallas in interpret mode on CPU).

On a CPU tensor each port wrapper runs its plain PyTorch version, so
these tests hold the plain versions — the functions the CUDA kernels are
checked against on the card by ``chip_smoke.py`` — to the reference.
Inputs are made with numpy from a seed and fed to both packages.

Tolerances: integer paths bit-exact (int8 and full-range int16, whose
int32 sums wrap in both packages); float32 and bfloat16 Conv4 within
``rtol=1e-4, atol=1e-5`` (the reference's own float conv tolerance; the
port sums in another order than XLA).  Planner outputs (members,
footprints, est-cycles, rendered plans) are equal exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import calibrate_cost as j_cal
from repro.core import plan as j_plan
from repro.core import resources as j_res
from repro.core import selector as j_sel
from repro.core.ip import SiteSpec as JSpec
from repro.core.resources import ResourceBudget as JBudget
from repro.kernels.conv2d import ip3_packed as j_ip3
from repro.kernels.conv2d.ops import conv2d_dual as j_dual
from repro.kernels.conv2d.ref import conv2d_dual_ref as j_dual_ref
from repro.models.blocks import cnn_block_site_specs as j_block_specs
from repro_torch.core import calibrate_cost as t_cal
from repro_torch.core import plan as t_plan
from repro_torch.core import resources as t_res
from repro_torch.core import selector as t_sel
from repro_torch.core.ip import SiteSpec as TSpec
from repro_torch.core.resources import ResourceBudget as TBudget
from repro_torch.kernels.conv2d import ip3_packed as t_ip3
from repro_torch.kernels.conv2d import ip4_dual as t_ip4
from repro_torch.kernels.conv2d.ops import conv2d_dual as t_dual
from repro_torch.kernels.conv2d.ref import conv2d_dual_ref as t_dual_ref
from repro_torch.models.blocks import cnn_block_site_specs as t_block_specs

F32 = dict(rtol=1e-4, atol=1e-5)

# the reference's conv shapes (tests/test_kernels_conv2d.py::SHAPES):
# (N, H, W, Cin, KH, KW, Cout)
SHAPES = [(1, 8, 8, 1, 3, 3, 1), (2, 12, 12, 3, 3, 3, 8),
          (1, 16, 9, 4, 5, 3, 16), (3, 7, 7, 2, 1, 1, 4),
          (1, 10, 10, 8, 3, 3, 130)]
SHAPE_IDS = ["1x8x8x1-k3-1", "2x12x12x3-k3-8", "1x16x9x4-k5x3-16",
             "3x7x7x2-k1-4", "1x10x10x8-k3-130"]
# the six sign-borrow corner cases of the reference's
# test_ip3_extreme_values: (a, b, w)
EXTREMES = [(-128, -128, -128), (-128, 127, -128), (127, -128, 127),
            (127, 127, 127), (-1, 1, -1), (0, -128, 127)]


def _both(a):
    """One numpy array as (jax array, torch CPU tensor)."""
    return jnp.asarray(a), torch.from_numpy(np.array(a, copy=True))


def _ints(rng, shape, dtype=np.int8):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape, dtype=dtype)


def _exact(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _operands(rng, shape, dtype=np.int8):
    n, h, w, cin, kh, kw, cout = shape
    return [_both(_ints(rng, s, dtype)) for s in
            ((n, h, w, cin), (n, h, w, cin), (kh, kw, cin, cout))]


# --------------------------------------------------------------------------
# Conv3 / Conv4 against the reference's Pallas kernels
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ip", ["ip3_packed", "ip4_dual"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_dual_int8_bit_exact(rng, shape, ip):
    (jxa, txa), (jxb, txb), (jw, tw) = _operands(rng, shape)
    _exact(t_dual(txa, txb, tw, ip=ip), j_dual(jxa, jxb, jw, ip=ip))


@pytest.mark.parametrize("ip", ["ip3_packed", "ip4_dual"])
@pytest.mark.parametrize("a,b,w", EXTREMES)
def test_dual_extreme_values(ip, a, b, w):
    """-128 * -128 and friends: the borrow correction must be exact."""
    xa = torch.full((1, 3, 3, 1), a, dtype=torch.int8)
    xb = torch.full((1, 3, 3, 1), b, dtype=torch.int8)
    wt = torch.full((3, 3, 1, 1), w, dtype=torch.int8)
    ya, yb = t_dual(xa, xb, wt, ip=ip)
    assert int(ya[0, 0, 0, 0]) == 9 * a * w
    assert int(yb[0, 0, 0, 0]) == 9 * b * w
    _exact((ya, yb), j_dual(jnp.asarray(xa.numpy()), jnp.asarray(xb.numpy()),
                            jnp.asarray(wt.numpy()), ip=ip))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       h=st.integers(3, 8), cin=st.integers(1, 3), cout=st.integers(1, 4))
def test_ip3_packing_exact_property(seed, h, cin, cout):
    """Conv3 over random int8 operands equals two independent integer
    convolutions (the reference's oracle)."""
    rng = np.random.default_rng(seed)
    (jxa, txa), (jxb, txb), (jw, tw) = _operands(
        rng, (1, h, h, cin, 3, 3, cout))
    got = t_ip3.conv2d_ip3(txa, txb, tw)
    _exact(got, j_dual_ref(jxa, jxb, jw))
    _exact(got, [t.numpy() for t in t_dual_ref(txa, txb, tw)])


def test_unpack_is_exact_over_all_int8_pairs():
    """The packing identity for every (a, b) pair of int8 values at the
    extreme and unit weights: ``_unpack`` recovers a*w and b*w exactly,
    as the reference's ``_unpack`` does."""
    v = torch.arange(-128, 128, dtype=torch.int32)
    a, b = v.repeat_interleave(256), v.repeat(256)
    for w in (-128, -1, 0, 1, 127):
        m = (a * (1 << 16) + b) * w
        high, low = t_ip3._unpack(m)
        assert torch.equal(high, a * w) and torch.equal(low, b * w)
        jh, jl = j_ip3._unpack(jnp.asarray(m.numpy()))
        np.testing.assert_array_equal(high.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(low.numpy(), np.asarray(jl))


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[2]],
                         ids=[SHAPE_IDS[1], SHAPE_IDS[2]])
def test_ip4_int16_full_range_wraps_bit_exact(rng, shape):
    """Full-range int16 taps overflow int32; both packages wrap."""
    (jxa, txa), (jxb, txb), (jw, tw) = _operands(rng, shape, np.int16)
    _exact(t_ip4.conv2d_ip4(txa, txb, tw), j_dual(jxa, jxb, jw,
                                                  ip="ip4_dual"))
    # all taps at -32768: 9 * 2^30 wraps to 2^30
    x = torch.full((1, 3, 3, 1), -32768, dtype=torch.int16)
    ya, _ = t_ip4.conv2d_ip4(x, x, x.reshape(3, 3, 1, 1))
    assert int(ya[0, 0, 0, 0]) == 9 * 2**30 - 2 * 2**32 == 2**30
    _exact((ya,), j_dual(jnp.asarray(x.numpy()), jnp.asarray(x.numpy()),
                         jnp.asarray(x.numpy().reshape(3, 3, 1, 1)),
                         ip="ip4_dual")[:1])


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES[:3], ids=SHAPE_IDS[:3])
def test_ip4_float_matches(rng, shape, dtype):
    n, h, w, cin, kh, kw, cout = shape
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((n, h, w, cin), (n, h, w, cin), (kh, kw, cin, cout))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tt = torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32
    tx = [torch.from_numpy(a).to(tt) for a in arrs]
    got = t_ip4.conv2d_ip4(*tx)
    want = j_dual(*jx, ip="ip4_dual")
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **F32)


def test_ip4_f32_streams_equal_single_stream_conv2(rng):
    """Each Conv4 stream is Conv2's computation of that stream (the
    kernel's bitwise contract, here on the plain versions)."""
    from repro_torch.kernels.conv2d.ip2_mxu import conv2d_ip2
    xa, xb = (torch.from_numpy(rng.normal(size=(2, 9, 9, 4)).astype(
        np.float32)) for _ in range(2))
    w = torch.from_numpy(rng.normal(size=(3, 3, 4, 6)).astype(np.float32))
    ya, yb = t_ip4.conv2d_ip4(xa, xb, w)
    assert torch.equal(ya, conv2d_ip2(xa, w))
    assert torch.equal(yb, conv2d_ip2(xb, w))


def test_dual_named_errors(rng):
    x16 = torch.zeros((1, 6, 6, 2), dtype=torch.int16)
    w8 = torch.zeros((3, 3, 2, 2), dtype=torch.int8)
    with pytest.raises(TypeError, match="8-bit"):
        t_dual(x16, x16, w8, ip="ip3_packed")
    with pytest.raises(TypeError, match="8-bit"):
        j_dual(jnp.asarray(x16.numpy()), jnp.asarray(x16.numpy()),
               jnp.asarray(w8.numpy()), ip="ip3_packed")
    x8 = torch.zeros((1, 6, 6, 2), dtype=torch.int8)
    with pytest.raises(KeyError, match="not a dual-stream conv IP"):
        t_dual(x8, x8, w8, ip="ip1_vpu")
    with pytest.raises(KeyError, match="not a dual-stream conv IP"):
        j_dual(jnp.asarray(x8.numpy()), jnp.asarray(x8.numpy()),
               jnp.asarray(w8.numpy()), ip="ip1_vpu")
    with pytest.raises(ValueError, match="streams must match"):
        t_dual(x8, x8[:, :5], w8, ip="ip4_dual")
    with pytest.raises(ValueError, match="block_cout"):
        t_ip4.conv2d_ip4(x8, x8, w8, block_cout=0)


# --------------------------------------------------------------------------
# conv2d_dual(budget=): the member the planner gives
# --------------------------------------------------------------------------
# The frontend's two block shapes and the four dual budgets of the chip
# run (chip_smoke.py::DUAL_PLANS), with the member the reference picks.
BLOCKS = {"block0": ((4, 224, 224, 3), (3, 3, 3, 16)),
          "block1": ((4, 111, 111, 16), (3, 3, 16, 32))}
DUAL_PLANS = [("int8", dict(precision_bits=8, mxu_passes_budget=1),
               "conv2d.ip3_packed"),
              ("int8", {}, "conv2d.ip4_dual"),
              ("float32", {}, "conv2d.ip4_dual"),
              ("int16", dict(precision_bits=16), "conv2d.ip4_dual")]


@pytest.mark.parametrize("dtype,budget,member", DUAL_PLANS,
                         ids=["int8-packed", "int8", "float32", "int16"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_dual_budget_plans_the_listed_member(block, dtype, budget, member):
    """Planning only, at the full frontend widths."""
    shapes = BLOCKS[block]
    j_plan.clear_plan_cache()
    t_plan.clear_plan_cache()
    want = j_plan.plan_single(JSpec.make("conv2d", "conv2d", shapes, dtype,
                                         dual=True), JBudget(**budget))
    got = t_plan.plan_single(TSpec.make("conv2d", "conv2d", shapes,
                                        getattr(torch, dtype), dual=True),
                             TBudget(**budget))
    assert got.ip.name == want.ip.name == member
    assert dataclasses.asdict(got.footprint) == \
        dataclasses.asdict(want.footprint)


@pytest.mark.parametrize("dtype,budget,member", DUAL_PLANS,
                         ids=["int8-packed", "int8", "float32", "int16"])
def test_dual_budget_runs_the_planned_member(rng, dtype, budget, member):
    """At a small shape ``budget=`` returns the explicitly named
    member's result."""
    shape = (2, 10, 10, 3, 3, 3, 4)
    if dtype == "float32":
        x = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
             for s in ((2, 10, 10, 3), (2, 10, 10, 3), (3, 3, 3, 4))]
    else:
        x = [t for _, t in _operands(rng, shape, getattr(np, dtype))]
    planned = t_plan.plan_single(
        TSpec.make("conv2d", "conv2d", (x[0].shape, x[2].shape),
                            x[0].dtype, dual=True),
        TBudget(**budget)).ip.name
    got = t_dual(*x, budget=TBudget(**budget))
    want = t_dual(*x, ip=planned)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# --------------------------------------------------------------------------
# selector shims and fixed-IP baselines on the reference's Table III
# network (benchmarks/run.py::table3_network_specs and table3_comparison)
# --------------------------------------------------------------------------
TABLE3_LAYERS = [(8, 16), (16, 32), (32, 32)]   # (cin, cout), 3x3 convs
TABLE3_BASELINES = {
    "fixed_vpu": {"conv2d": "ip1_vpu", "pool2d": "pool_vpu",
                  "activation": "act_vpu"},
    "fixed_mxu": {"conv2d": "ip2_mxu", "pool2d": "pool_im2col",
                  "activation": "act_vpu"},
}
TABLE3_BUDGETS = {
    "ample": {},
    "no_mxu": dict(mxu_available=False),
    "vpu_starved": dict(vpu_ops_budget=2_000_000),
    "vmem_tight": dict(vmem_bytes=2 * 2**20),
    "mxu_modest_vpu_tight": dict(vpu_ops_budget=2_000_000,
                                 mxu_passes_budget=12),
}


def _table3_specs(block_specs, n=2, hw=32):
    specs = []
    shape = (n, hw, hw, TABLE3_LAYERS[0][0])
    for li, (cin, cout) in enumerate(TABLE3_LAYERS):
        layer, out = block_specs(shape, (3, 3, cin, cout), x_dtype="int8",
                                 pool_mode="avg", activation="relu6",
                                 site=f"layer{li}")
        specs += layer
        shape = out[0] if isinstance(out, tuple) else out.shape
    return specs


def _shim_calls(sel, spec, budget):
    """The ``select_<family>_ip`` call that prices one Table III site."""
    d = spec.dtype
    if spec.family == "conv2d":
        return sel.select_conv_ip(*spec.shapes, dual=False, dtype=d,
                                  budget=budget, with_footprint=True)
    if spec.family == "pool2d":
        return sel.select_pool_ip(spec.shapes[0],
                                  window=spec.knob("window", (2, 2)),
                                  stride=spec.knob("stride"),
                                  mode=spec.knob("mode", "max"), dtype=d,
                                  budget=budget, with_footprint=True)
    return sel.select_activation_ip(spec.shapes[0],
                                    kind=spec.knob("kind", "relu"), dtype=d,
                                    budget=budget, with_footprint=True)


def _same_choice(got, want):
    if isinstance(want, Exception):
        assert isinstance(got, type(want)) and str(got) == str(want)
        return
    (tip, tfp), (jip, jfp) = got, want
    assert tip.name == jip.name
    assert dataclasses.asdict(tfp) == dataclasses.asdict(jfp)


def _call(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except (ValueError, KeyError) as e:
        return e


@pytest.mark.parametrize("budget", list(TABLE3_BUDGETS))
def test_selector_shims_match_reference_on_table3(budget):
    tspecs, jspecs = (_table3_specs(t_block_specs),
                      _table3_specs(j_block_specs))
    for ts, js in zip(tspecs, jspecs):
        _same_choice(
            _call(_shim_calls, t_sel, ts, TBudget(**TABLE3_BUDGETS[budget])),
            _call(_shim_calls, j_sel, js, JBudget(**TABLE3_BUDGETS[budget])))
    # conv and matmul shims, single- and dual-stream
    tb, jb = TBudget(**TABLE3_BUDGETS[budget]), JBudget(**TABLE3_BUDGETS[budget])
    for dual in (False, True):
        _same_choice(
            _call(t_sel.select_conv_ip, (2, 16, 16, 8), (3, 3, 8, 16),
                  dual=dual, budget=tb, with_footprint=True),
            _call(j_sel.select_conv_ip, (2, 16, 16, 8), (3, 3, 8, 16),
                  dual=dual, budget=jb, with_footprint=True))
        _same_choice(
            _call(t_sel.select_matmul_ip, (64, 96), (96, 48), dual=dual,
                  budget=tb, with_footprint=True),
            _call(j_sel.select_matmul_ip, (64, 96), (96, 48), dual=dual,
                  budget=jb, with_footprint=True))


@pytest.mark.parametrize("budget", list(TABLE3_BUDGETS))
def test_fixed_network_cost_matches_reference_on_table3(budget):
    tspecs, jspecs = (_table3_specs(t_block_specs),
                      _table3_specs(j_block_specs))
    for name, members in TABLE3_BASELINES.items():
        got = t_plan.fixed_network_cost(tspecs, members,
                                        TBudget(**TABLE3_BUDGETS[budget]))
        want = j_plan.fixed_network_cost(jspecs, members,
                                         JBudget(**TABLE3_BUDGETS[budget]))
        assert got == want, (name, got, want)


def test_fixed_network_cost_edges():
    tspecs = _table3_specs(t_block_specs)
    members = dict(TABLE3_BASELINES["fixed_vpu"], conv2d="ip3_packed")
    assert t_plan.fixed_network_cost(tspecs, members) is None  # not a cand.
    # calibration= prices (no longer refused): exactly the reference's
    # cost under a table fitted on the same samples
    jspecs = _table3_specs(j_block_specs)
    tables = []
    for cal, res in ((j_cal, j_res), (t_cal, t_res)):
        table = cal.CalibrationTable()
        for i, m in enumerate(("conv2d.ip1_vpu", "pool2d.pool_vpu",
                               "activation.act_vpu", "conv2d.ip2_mxu")):
            for comp, hbm in ((1e3, 1 << 12), (5e4, 1 << 16),
                              (2e5, 1 << 20)):
                fp = res.Footprint(vmem_bytes=1024, hbm_bytes=hbm,
                                   mxu_passes=0, vpu_ops=100,
                                   est_cycles=comp + res.hbm_cycles(hbm))
                table.record(m, fp, 1e-4 * (i + 1) * comp + 1e-6 * hbm + 3.0)
        tables.append(table.fit())
    for name, members in TABLE3_BASELINES.items():
        got = t_plan.fixed_network_cost(tspecs, members,
                                        calibration=tables[1])
        want = j_plan.fixed_network_cost(jspecs, members,
                                         calibration=tables[0])
        assert got == want, (name, got, want)
        assert got != t_plan.fixed_network_cost(tspecs, members)


def test_describe_plan_matches_reference():
    tspecs, jspecs = (_table3_specs(t_block_specs),
                      _table3_specs(j_block_specs))
    for kw in ({}, dict(mxu_available=False)):
        t_plan.clear_plan_cache()
        j_plan.clear_plan_cache()
        got = t_plan.plan_network(tspecs, TBudget(**kw), fuse=False)
        want = j_plan.plan_network(jspecs, JBudget(**kw), fuse=False)
        assert t_sel.describe_plan(got) == j_sel.describe_plan(want)
        ad_hoc = {s: got[s] for s in list(got)[:2]}
        assert t_sel.describe_plan(ad_hoc) == j_sel.describe_plan(
            {s: want[s] for s in list(want)[:2]})


def test_select_attention_ip_raises_the_family_error():
    """The attention family is ported: its shim selects as the
    reference's does, and raises the family's own "no feasible IP" error
    where the reference does."""
    shapes = ((1, 4, 8, 16), (1, 4, 8, 16))
    want, want_fp = j_sel.select_attention_ip(*shapes, with_footprint=True)
    got, got_fp = t_sel.select_attention_ip(*shapes, with_footprint=True)
    assert got.name == want.name
    assert dataclasses.asdict(got_fp) == dataclasses.asdict(want_fp)
    with pytest.raises(ValueError, match="no feasible IP") as e:
        t_sel.select_attention_ip(*shapes,
                                  budget=TBudget(mxu_available=False))
    with pytest.raises(ValueError) as j_e:
        j_sel.select_attention_ip(*shapes,
                                  budget=JBudget(mxu_available=False))
    assert str(e.value) == str(j_e.value)
