"""The port's optimizer and gradient compression (``repro_torch.optim``)
against the reference's (``repro.optim``).

The reference's update runs op by op here (no ``jit``), as its source
reads: XLA's CPU backend, compiling the update whole, contracts
``b1 * m + (1 - b1) * g`` and the like into fused multiply-adds (one
rounding each), which PyTorch does not, so only the op-by-op run is the
reference's arithmetic to the bit.  On the same grads the port's
params, moments and step are then bitwise the reference's wherever the
grads are not clipped; where they are, the clip scale comes from the
global norm, whose sums run in another order, and the results are held
within ``rtol=1e-6`` (a few f32 roundings).  The jitted update is held
within one rounding of each fused term.  The schedule (``lr_at``, f32
from an int32 step, ``cos`` as the C library's ``cosf``) and the bias
corrections are bitwise.  Compression (int8, top-k, both, with error
feedback) is bitwise.  Then ``test_substrate``'s optimizer and
compression cases re-run against the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro.optim import grad_compress as j_gc
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import grad_compress as t_gc
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     init_opt_state, lr_at)
from repro_torch.optim.grad_compress import (compress_grads,
                                             dequantize_int8, init_ef_state,
                                             quantize_int8, topk_mask,
                                             wire_bytes)

CONFIGS = [dict(warmup_steps=2, total_steps=10), {},
           dict(lr=1e-2, warmup_steps=5, total_steps=40),
           dict(lr=1e-3, warmup_steps=0, total_steps=1)]


def _both(**kw):
    return j_adamw.AdamWConfig(**kw), AdamWConfig(**kw)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _np(t):
    """A tensor's bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _tree(rng, scale, md="float32"):
    """A params tree (keys out of sorted order) and grads of ``scale``."""
    shapes = {"w": (7, 33), "a": {"z": (129,), "b": (2, 3, 4)}}

    def draw(s):
        return (lambda shp: (s * rng.normal(size=shp)).astype(np.float32))
    p = jax.tree.map(draw(1.0), shapes, is_leaf=lambda x: isinstance(x, tuple))
    g = jax.tree.map(draw(scale), shapes,
                     is_leaf=lambda x: isinstance(x, tuple))
    return p, g


def _t(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(
        dtype or torch.float32), tree)


def _j(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


@pytest.mark.parametrize("kw", CONFIGS, ids=str)
def test_lr_at_is_bitwise_the_references(kw):
    jc, tc = _both(**kw)
    for step in range(0, tc.total_steps + 60):
        want = np.float32(j_adamw.lr_at(jc, jnp.int32(step)))
        got = lr_at(tc, step)
        assert isinstance(got, np.float32)
        assert _bits(got) == _bits(want), step


@pytest.mark.parametrize("b", [0.9, 0.95, 0.999])
def test_bias_corrections_are_bitwise_the_references(b):
    f = jax.jit(lambda s: 1 - b ** s.astype(jnp.float32))
    for step in range(1, 200):
        want = np.float32(f(jnp.int32(step)))
        got = np.float32(1) - np.float32(b) ** np.float32(step)
        assert _bits(got) == _bits(want), step


@pytest.mark.parametrize("md", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_apply_updates_is_bitwise_the_references_unclipped(md, param_dtype):
    jc, tc = _both(warmup_steps=2, total_steps=10, moment_dtype=md)
    rng = np.random.default_rng(0)
    pnp, gnp = _tree(rng, 1e-3)
    jd = jnp.dtype(param_dtype)
    td = getattr(torch, param_dtype)
    jp, jg = _j(pnp, jd), _j(gnp, jd)
    js = j_adamw.init_opt_state(jc, jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(td), jp)
    tg = jax.tree.map(lambda a: torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(td), jg)
    ts = init_opt_state(tc, tp)
    for it in range(4):
        jp, js, jm = j_adamw.apply_updates(jc, jp, jg, js)
        tp, ts, tm = apply_updates(tc, tp, tg, ts)
        assert float(jm["grad_norm"]) < 1.0      # no clipping
        for want, got in zip(jax.tree.leaves((jp, js.mu, js.nu)),
                             t_adamw.tree_leaves((tp, ts.mu, ts.nu))):
            assert str(got.dtype).split(".")[1] == str(want.dtype)
            np.testing.assert_array_equal(_np(got), _bits(want))
        assert int(ts.step) == int(js.step) == it + 1
        assert ts.step.dtype == torch.int32
        assert _bits(np.float32(tm["lr"])) == _bits(np.float32(jm["lr"]))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)


@pytest.mark.parametrize("md", ["float32", "bfloat16"])
def test_apply_updates_clipped_within_the_norms_rounding(md):
    jc, tc = _both(warmup_steps=2, total_steps=10, moment_dtype=md)
    pnp, gnp = _tree(np.random.default_rng(1), 10.0)
    jp, jg = _j(pnp), _j(gnp)
    js = j_adamw.init_opt_state(jc, jp)
    tp, tg = _t(pnp), _t(gnp)
    ts = init_opt_state(tc, tp)
    for _ in range(3):
        jp, js, jm = j_adamw.apply_updates(jc, jp, jg, js)
        tp, ts, tm = apply_updates(tc, tp, tg, ts)
        assert float(jm["grad_norm"]) > 1.0      # clipped
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for want, got in zip(jax.tree.leaves((jp, js.mu, js.nu)),
                             t_adamw.tree_leaves((tp, ts.mu, ts.nu))):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=1e-6 if md == "float32" else
                                       2 ** -8, atol=1e-30)


def test_jitted_update_within_one_rounding_of_each_fused_term():
    """Under ``jit`` the reference's multiply-adds are fused: the
    port's moments are within one f32 rounding of the larger term of
    each (``b1 * m``, ``(1 - b1) * g``) and one of the result."""
    jc, tc = _both(warmup_steps=2, total_steps=10)
    pnp, gnp = _tree(np.random.default_rng(2), 1e-3)
    jp, jg = _j(pnp), _j(gnp)
    js = j_adamw.init_opt_state(jc, jp)
    tp, tg = _t(pnp), _t(gnp)
    ts = init_opt_state(tc, tp)
    step = jax.jit(lambda p, g, s: j_adamw.apply_updates(jc, p, g, s))
    for _ in range(3):
        m_prev = [t.clone() for t in t_adamw.tree_leaves(ts.mu)]
        v_prev = [t.clone() for t in t_adamw.tree_leaves(ts.nu)]
        # both sides start the step from the port's state; the reference
        # gets copies (a CPU array may share the numpy buffer) and has
        # finished its step before the port writes its tensors in place
        js = j_adamw.OptState(*(jax.tree.map(lambda t: jnp.array(
            t.numpy().copy()), x) for x in (ts.mu, ts.nu)),
            jnp.int32(ts.step))
        jp = jax.tree.map(lambda t: jnp.array(t.numpy().copy()), tp)
        jp, js, _ = jax.block_until_ready(step(jp, jg, js))
        tp, ts, _ = apply_updates(tc, tp, tg, ts)
        grads = t_adamw.tree_leaves(tg)
        for b, moms, prev, sq in ((0.9, (js.mu, ts.mu), m_prev, False),
                                  (0.95, (js.nu, ts.nu), v_prev, True)):
            for want, got, pm, g in zip(jax.tree.leaves(moms[0]),
                                        t_adamw.tree_leaves(moms[1]),
                                        prev, grads):
                g = g * g if sq else g
                want = torch.from_numpy(np.array(want))
                term = torch.maximum((b * pm).abs(), ((1 - b) * g).abs())
                ulp = torch.finfo(torch.float32).eps * (term + want.abs())
                assert bool(((got - want).abs() <= ulp).all())


def test_updates_in_place_write_the_given_tensors():
    cfg = AdamWConfig(warmup_steps=2, total_steps=10)
    pnp, gnp = _tree(np.random.default_rng(3), 1e-2)
    p, g = _t(pnp), _t(gnp)
    s = init_opt_state(cfg, p)
    before = [t.clone() for t in t_adamw.tree_leaves((p, s))]
    ptrs = [t.data_ptr() for t in t_adamw.tree_leaves((p, s))]
    ip, is_, _ = apply_updates(cfg, p, g, s)
    assert ip is p and is_ is s
    assert [t.data_ptr() for t in t_adamw.tree_leaves((ip, is_))] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(
        before, t_adamw.tree_leaves((ip, is_))))
    # the same step on copies of the given trees gives the same values
    cp, cs, _ = apply_updates(cfg, _t(pnp), g, init_opt_state(cfg, _t(pnp)))
    for a, b in zip(t_adamw.tree_leaves((cp, cs)),
                    t_adamw.tree_leaves((ip, is_))):
        assert torch.equal(a, b)


def test_blocked_update_equals_the_whole_leaf(monkeypatch):
    """Large leaves are updated (and their norms summed) in flat blocks:
    elementwise, so blocks of any size give the same params and
    moments."""
    cfg = AdamWConfig(warmup_steps=2, total_steps=10)
    pnp, gnp = _tree(np.random.default_rng(4), 1e-3)
    whole = apply_updates(cfg, _t(pnp), _t(gnp), init_opt_state(
        cfg, _t(pnp)))
    monkeypatch.setattr(t_adamw, "BLOCK", 5)
    blocked = apply_updates(cfg, _t(pnp), _t(gnp), init_opt_state(
        cfg, _t(pnp)))
    for a, b in zip(t_adamw.tree_leaves(whole[:2]),
                    t_adamw.tree_leaves(blocked[:2])):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(blocked[2]["grad_norm"]),
                               float(whole[2]["grad_norm"]), rtol=1e-6)


def test_mismatched_trees_raise():
    cfg = AdamWConfig()
    p = {"w": torch.zeros(3), "b": torch.zeros(2)}
    with pytest.raises(ValueError, match="leaves"):
        apply_updates(cfg, p, {"w": torch.zeros(3)}, init_opt_state(cfg, p))


def test_global_norm_and_clip_match_the_reference():
    pnp, gnp = _tree(np.random.default_rng(5), 3.0)
    want_tree, want_norm = j_adamw.clip_by_global_norm(_j(gnp), 1.0)
    got_tree, got_norm = t_adamw.clip_by_global_norm(_t(gnp), 1.0)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    np.testing.assert_allclose(float(t_adamw.global_norm(_t(gnp))),
                               float(j_adamw.global_norm(_j(gnp))),
                               rtol=1e-6)
    for w, g in zip(jax.tree.leaves(want_tree),
                    t_adamw.tree_leaves(got_tree)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# --------------------------------------------------------------------------
# gradient compression
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["int8", "topk", "int8_topk"])
def test_compress_grads_is_bitwise_the_references(scheme):
    rng = np.random.default_rng(6)
    je = te = None
    for it in range(4):
        g = {"x": rng.normal(size=(50, 7)).astype(np.float32),
             "y": (1e-3 * rng.normal(size=(33,))).astype(np.float32)}
        if je is None:
            je, te = j_gc.init_ef_state(_j(g)), init_ef_state(_t(g))
        jw, je = j_gc.compress_grads(_j(g), je, scheme=scheme,
                                     topk_frac=0.2)
        tw, te = compress_grads(_t(g), te, scheme=scheme, topk_frac=0.2)
        for k in g:
            np.testing.assert_array_equal(_bits(tw[k].numpy()),
                                          _bits(jw[k]))
            np.testing.assert_array_equal(_bits(te.residual[k].numpy()),
                                          _bits(je.residual[k]))


@pytest.mark.parametrize("scheme", ["int8", "topk", "int8_topk", "none"])
def test_wire_bytes_equal_the_references(scheme):
    g = {"a": np.zeros((1000,), np.float32), "b": np.zeros((7, 9),
                                                           np.float32)}
    for frac in (0.1, 0.37):
        assert wire_bytes(_t(g), scheme, frac) == \
            j_gc.wire_bytes(_j(g), scheme, frac)


def test_quantize_and_topk_are_bitwise_the_references():
    x = np.random.default_rng(7).normal(size=(300,)).astype(np.float32)
    jq, js = j_gc.quantize_int8(jnp.asarray(x))
    tq, ts = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert _bits(ts.numpy()) == _bits(js)
    for frac in (0.01, 0.1, 0.5, 1.0):
        np.testing.assert_array_equal(
            topk_mask(torch.from_numpy(x), frac).numpy(),
            np.asarray(j_gc.topk_mask(jnp.asarray(x), frac)))


# --------------------------------------------------------------------------
# test_substrate's optimizer and compression cases, on the port
# --------------------------------------------------------------------------
def test_adamw_descends_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                      total_steps=100)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(cfg, params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, _ = apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 1.0


def test_adamw_grad_clip_and_lr_schedule():
    cfg = AdamWConfig(lr=1e-3, grad_clip=1.0, warmup_steps=10,
                      total_steps=100)
    assert float(lr_at(cfg, 0)) < float(lr_at(cfg, 10))
    assert float(lr_at(cfg, 100)) < float(lr_at(cfg, 10))
    params = {"w": torch.zeros(3)}
    state = init_opt_state(cfg, params)
    _, _, metrics = apply_updates(cfg, params, {"w": torch.full((3,), 1e6)},
                                  state)
    assert float(metrics["grad_norm"]) > 1e5  # norm reported pre-clip


def test_adamw_bf16_moments():
    cfg = AdamWConfig(moment_dtype="bfloat16")
    params = {"w": torch.ones(4)}
    state = init_opt_state(cfg, params)
    assert state.mu["w"].dtype == torch.bfloat16
    p2, s2, _ = apply_updates(cfg, params, {"w": torch.ones(4)}, state)
    assert s2.mu["w"].dtype == torch.bfloat16
    assert p2["w"].dtype == torch.float32


def test_int8_quantization_bounded_error():
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1000,)).astype(np.float32))
    q, scale = quantize_int8(x)
    err = (dequantize_int8(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


def test_topk_keeps_largest():
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(100,)).astype(np.float32))
    m = topk_mask(x, 0.1)
    kept, dropped = x.abs()[m > 0], x.abs()[m == 0]
    assert float(kept.min()) >= float(dropped.max()) - 1e-6
    assert 8 <= kept.numel() <= 12


@pytest.mark.parametrize("scheme", ["int8", "topk", "int8_topk"])
def test_error_feedback_unbiased_accumulation(scheme):
    rng = np.random.default_rng(10)
    grads_seq = [torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
                 for _ in range(10)]
    ef = init_ef_state(grads_seq[0])
    total_wire = torch.zeros(64)
    for g in grads_seq:
        wire, ef = compress_grads(g, ef, scheme=scheme, topk_frac=0.2)
        total_wire = total_wire + wire
    np.testing.assert_allclose((total_wire + ef.residual).numpy(),
                               sum(grads_seq).numpy(), rtol=1e-4, atol=1e-4)


def test_wire_bytes_savings():
    g = torch.zeros(1000)
    assert wire_bytes(g, "int8") == 1000
    assert wire_bytes(g, "topk", 0.1) == 100 * 8
    assert wire_bytes(g, "none") == 4000
