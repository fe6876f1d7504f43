"""The port's CNN frontend and block (``repro_torch.models``) against
the reference's, with the reference's weights carried across by
``params_from_numpy``.  Full widths: channels (3, 16, 32), d_model 64;
f32, bf16 and int16 images and weights.  Tolerance ``rtol=1e-4,
atol=1e-5`` (float32 convs summed in another order than XLA)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import clear_plan_cache as j_clear
from repro.models.blocks import apply_cnn_block as j_block
from repro.models.blocks import cnn_block_site_specs as j_block_specs
from repro.models.frontends import apply_cnn_frontend as j_apply
from repro.models.frontends import init_cnn_frontend as j_init
from repro_torch.core.plan import clear_plan_cache as t_clear
from repro_torch.core.resources import ResourceBudget
from repro_torch.models.blocks import apply_cnn_block as t_block
from repro_torch.models.blocks import cnn_block_site_specs as t_block_specs
from repro_torch.models.frontends import apply_cnn_frontend as t_apply
from repro_torch.models.frontends import (CudaUnavailableError,
                                          init_cnn_frontend,
                                          params_from_numpy)

F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    p = j_init(jax.random.PRNGKey(3))
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                "cpu")


def _int16_params(rng):
    """An int16 frontend (the reference's widths) with small integer
    weights: ``init_cnn_frontend(dtype=int16)`` would round N(0, 1/27)
    draws to zero.  Block 0 then sums exactly in int32; block 1 takes
    its f32 input against the int16 weights, widened exactly."""
    tree = {"blocks": [{"w": rng.integers(-8, 9, s).astype(np.int16)}
                       for s in ((3, 3, 3, 16), (3, 3, 16, 32))],
            "proj": rng.integers(-4, 5, (32, 64)).astype(np.int16)}
    return tree, params_from_numpy(tree, "cpu")


def _frontend_case(rng, params, dtype):
    """(reference params, port params, reference images, port images) of
    the f32 frontend, its bf16 twin (the reference's init in bf16, the
    images rounded to bf16 in both packages) or the int16 one."""
    if dtype == "int16":
        jp, tp = _int16_params(rng)
        x = rng.integers(-100, 101, (2, 32, 32, 3)).astype(np.int16)
        return jp, tp, jnp.asarray(x), torch.from_numpy(x)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    if dtype == "float32":
        return (*params, jnp.asarray(x), torch.from_numpy(x))
    jp = j_init(jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return (jp, tp, jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int16"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_frontend_matches_reference(rng, params, fuse, dtype):
    jp, tp, jx, tx = _frontend_case(rng, params, dtype)
    j_clear()
    t_clear()
    want = np.asarray(j_apply(jp, jx, fuse=fuse))
    got = t_apply(tp, tx, fuse=fuse)
    assert tuple(got.shape) == want.shape == (2, 36, 64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int16"])
def test_frontend_fused_bitwise_equals_unfused(rng, params, dtype):
    _, tp, _, x = _frontend_case(rng, params, dtype)
    logic_only = ResourceBudget(mxu_available=False)
    for budget in (None, logic_only):
        assert torch.equal(t_apply(tp, x, budget=budget, fuse=True),
                           t_apply(tp, x, budget=budget, fuse=False))


@pytest.mark.parametrize("mode,kind", [("max", "relu"), ("avg", "tanh"),
                                       ("max", "gelu")])
def test_block_matches_reference(rng, mode, kind):
    w = (rng.normal(size=(3, 3, 4, 8)) / 6).astype(np.float32)
    x = rng.normal(size=(2, 12, 12, 4)).astype(np.float32)
    plan_j, plan_t = {}, {}
    for fuse in (True, False):
        want = np.asarray(j_block({"w": jnp.asarray(w)}, jnp.asarray(x),
                                  pool_mode=mode, activation=kind,
                                  fuse=fuse, plan=plan_j))
        got = t_block({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                      pool_mode=mode, activation=kind, fuse=fuse,
                      plan=plan_t)
        np.testing.assert_allclose(got.numpy(), want, **F32)
    assert sorted(plan_t) == sorted(plan_j)
    assert {k: v[0].name for k, v in plan_t.items()} == \
        {k: v[0].name for k, v in plan_j.items()}


@pytest.mark.parametrize("x_dtype,w_dtype", [("float32", "float32"),
                                             ("int8", "int8"),
                                             ("int8", "float32")])
@pytest.mark.parametrize("mode", ["max", "avg"])
def test_block_site_specs_match_eval_shape(x_dtype, w_dtype, mode):
    """Shape arithmetic gives the specs ``jax.eval_shape`` gives."""
    kw = dict(x_dtype=x_dtype, w_dtype=w_dtype, pool_mode=mode,
              pool_stride=(1, 2), activation="tanh", site="b")
    j_specs, j_out = j_block_specs((2, 13, 12, 4), (3, 3, 4, 8), **kw)
    t_specs, t_out = t_block_specs((2, 13, 12, 4), (3, 3, 4, 8), **kw)
    assert [s.to_dict() for s in t_specs] == [s.to_dict() for s in j_specs]
    assert t_out == (tuple(j_out.shape), j_out.dtype.name)


def test_block_plan_mismatch_is_a_named_error(rng, params):
    _, tp = params
    from repro_torch.core.plan import plan_network
    specs, _ = t_block_specs((2, 16, 16, 3), (3, 3, 3, 16),
                             x_dtype="float32")
    network = plan_network(specs, fuse=True)
    x = torch.from_numpy(rng.normal(size=(2, 16, 16, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="plan/site mismatch"):
        t_block(tp["blocks"][0], x, network=network, pool_window=(3, 3))


def test_lowered_plans_and_quant_report_raise(rng, params):
    """Lowered plans and ``quant_report`` execute now (queue 1, item 4),
    and so do the int8 matmul kernel path and the quantized matmul."""
    from repro_torch.quant.ops import quantized_matmul
    from repro_torch.quant.quantize import int8_matmul, quantize_weights
    _, tp = params
    x = torch.from_numpy(rng.normal(size=(1, 16, 16, 3)).astype(np.float32))
    report = {}
    y = t_apply(tp, x, quant_report=report)
    assert tuple(y.shape) == (1, 4, 64)
    assert report and not any(r.lowered for r in report.values())
    tight = ResourceBudget(vmem_bytes=40 * 1024)
    report = {}
    y_low = t_apply(tp, x, budget=tight, ladder=(16, 8), quant_report=report)
    assert any(r.lowered for r in report.values())
    assert tuple(y_low.shape) == (1, 4, 64)
    assert bool(torch.isfinite(y_low).all())
    # the int8 matmul kernel and the quantized matmul run since the
    # matmul family landed: ones quantize exactly
    w = torch.ones((4, 2))
    assert torch.equal(int8_matmul(torch.ones((3, 4)), quantize_weights(w),
                                   use_kernel=True), torch.full((3, 2), 4.0))
    assert torch.equal(quantized_matmul(torch.ones((3, 4)), w),
                       torch.full((3, 2), 4.0))


def test_init_is_seeded_and_shaped():
    a = init_cnn_frontend(7, device="cpu")
    b = init_cnn_frontend(torch.Generator().manual_seed(7), device="cpu")
    assert [blk["w"].shape for blk in a["blocks"]] == [(3, 3, 3, 16),
                                                       (3, 3, 16, 32)]
    assert a["proj"].shape == (32, 64)
    assert all(torch.equal(x["w"], y["w"])
               for x, y in zip(a["blocks"], b["blocks"]))
    assert torch.equal(a["proj"], b["proj"])
    assert not torch.equal(a["proj"],
                           init_cnn_frontend(8, device="cpu")["proj"])


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError, match='device="cpu"'):
        init_cnn_frontend(0)
    with pytest.raises(CudaUnavailableError):
        params_from_numpy({"blocks": [], "proj": np.zeros((2, 2))})
