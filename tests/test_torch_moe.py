"""The port's MoE FFN (``repro_torch.models.moe``) against the reference
(``repro.models.moe``).

The same numpy inputs and the reference's own params (carried across
with ``params_from_numpy``) go through both sides on the CPU.  f32 within
``rtol=1e-4, atol=1e-5`` (the reference invariant's bound); expert
indices and capacity positions exactly, ties and dropped tokens
included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models import moe as j_moe
from repro.models import transformer as j_tr
from repro_torch.configs import base as t_base
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tr

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ERR_FACTOR = 1.5      # test_torch_lm.py's rule


def _both(moe=dict(n_experts=4, top_k=2), **kw):
    base = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
                compute_dtype="float32")
    base.update(kw)
    return (j_base.ModelConfig(moe=j_base.MoEConfig(**moe), **base),
            t_base.ModelConfig(moe=t_base.MoEConfig(**moe), **base))


def _params(jc, seed=0, prefix=()):
    jp = j_moe.init_moe(jc, jax.random.PRNGKey(seed), prefix)
    return jp, t_tr.params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tol)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu_sq"])
@pytest.mark.parametrize("prefix", [(), (3,)])
def test_init_moe_tree_matches_reference(act, prefix):
    jc, tc = _both(activation=act, param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, j_moe.init_moe(jc, jax.random.PRNGKey(0),
                                                 prefix))
    tp = t_moe.init_moe(tc, torch.Generator().manual_seed(0), prefix)
    want, got = dict(_leaves(jp)), dict(_leaves(tp))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        assert tuple(got[path].shape) == a.shape, path
        assert str(got[path].dtype) == f"torch.{a.dtype.name}", path
    assert tuple(tp["experts"]["w_down"].shape)[:len(prefix) + 1] == \
        prefix + (4,)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_top_k_gating_matches_reference(k):
    logits = np.random.default_rng(k).normal(size=(3, 10, 6)).astype(
        np.float32)
    want = j_moe._top_k_gating(jnp.asarray(logits), k)
    got = t_moe._top_k_gating(_t(logits), k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, **F32)
        assert g.dtype == torch.float32


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_gating_ties_take_the_first_expert(k):
    """Exactly tied probabilities (integer logits with repeats) pick the
    lowest tied index, slot after slot, as ``jnp.argmax``."""
    rng = np.random.default_rng(10 + k)
    logits = rng.integers(0, 3, size=(2, 12, 5)).astype(np.float32)
    logits[0, 0] = 1.0                       # a whole row tied
    want = j_moe._top_k_gating(jnp.asarray(logits), k)
    got = t_moe._top_k_gating(_t(logits), k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0][0, 0].tolist() == list(range(k))
    _close(got[1], want[1], **F32)


# (config changes, batch shape, num_groups): each case's capacity regime
MOE_CASES = {
    "ample": (dict(moe=dict(n_experts=4, top_k=2, capacity_factor=4.0)),
              (4, 8), 2),
    "dropped": (dict(moe=dict(n_experts=4, top_k=2, capacity_factor=0.5)),
                (2, 16), 1),
    "cap_one": (dict(moe=dict(n_experts=8, top_k=2)), (3, 1), 1),
    "groups16": (dict(moe=dict(n_experts=4, top_k=2)), (2, 16), 16),
    "groups_not_dividing": (dict(moe=dict(n_experts=4, top_k=2)), (3, 5),
                            4),
    "top4_of16": (dict(moe=dict(n_experts=16, top_k=4)), (2, 32), 16),
    "geglu": (dict(activation="geglu", moe=dict(n_experts=4, top_k=2)),
              (2, 8), 1),
    "gelu": (dict(activation="gelu", moe=dict(n_experts=4, top_k=2)),
             (2, 8), 1),
    "relu_sq": (dict(activation="relu_sq", moe=dict(n_experts=4, top_k=2)),
                (2, 8), 1),
}


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_reference(case, dispatch):
    kw, (b, s), groups = MOE_CASES[case]
    jc, tc = _both(moe_dispatch=dispatch, **kw)
    jp, tp = _params(jc, seed=1)
    x = np.random.default_rng(2).normal(size=(b, s, 32)).astype(np.float32)
    want_o, want_aux = j_moe.apply_moe(jc, jp, jnp.asarray(x),
                                       num_groups=groups)
    got_o, got_aux = t_moe.apply_moe(tc, tp, _t(x), num_groups=groups)
    assert got_o.shape == (b, s, 32) and got_o.dtype == torch.float32
    assert got_aux.dim() == 0 and got_aux.dtype == torch.float32
    _close(got_o, want_o, **F32)
    _close(got_aux, want_aux, **F32)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_tied_router_drops_what_the_reference_drops(dispatch):
    """A zero router ties every expert: each token takes experts 0..k-1,
    capacity drops all but the first ``cap`` tokens of each, and both
    sides zero the same outputs."""
    jc, tc = _both(moe_dispatch=dispatch)
    jp, tp = _params(jc, seed=3)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(4).normal(size=(1, 16, 32)).astype(np.float32)
    want, _ = j_moe.apply_moe(jc, jp, jnp.asarray(x))
    got, _ = t_moe.apply_moe(tc, tp, _t(x))
    _close(got, want, **F32)
    cap = int(1.25 * 2 * 16 / 4)                  # 10 slots an expert
    assert got[0, :cap].abs().amax(-1).gt(0).all()
    assert not got[0, cap:].any()


@pytest.mark.parametrize("groups", [1, 2])
def test_scatter_equals_einsum_dispatch(groups):
    """The reference invariant in the port: both dispatch modes compute
    the same function, drops included."""
    jc, tc = _both(moe=dict(n_experts=4, top_k=2, capacity_factor=0.75))
    _, tp = _params(jc, seed=5)
    x = _t(np.random.default_rng(5).normal(size=(4, 8, 32)).astype(
        np.float32))
    out_e, aux_e = t_moe.apply_moe(tc, tp, x, num_groups=groups)
    out_s, aux_s = t_moe.apply_moe(
        dataclasses.replace(tc, moe_dispatch="scatter"), tp, x,
        num_groups=groups)
    torch.testing.assert_close(out_s, out_e, rtol=2e-4, atol=1e-5)
    assert float(aux_s) == float(aux_e)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_bf16_compute_error_is_the_references(dispatch):
    """bf16 compute, ample capacity (no routing decision near a drop):
    the port's output lies within ``BF16_ERR_FACTOR`` times the
    reference's own bf16 error of the reference's f32 output (relative
    L2), the rule of ``test_torch_lm.py``."""
    jc, tc = _both(compute_dtype="bfloat16", moe_dispatch=dispatch,
                   moe=dict(n_experts=4, top_k=2, capacity_factor=4.0))
    jp, tp = _params(jc, seed=6)
    x = np.random.default_rng(6).normal(size=(2, 8, 32)).astype(np.float32)
    f32 = np.asarray(j_moe.apply_moe(
        dataclasses.replace(jc, compute_dtype="float32"), jp,
        jnp.asarray(x))[0])
    ref = np.asarray(j_moe.apply_moe(jc, jp, jnp.asarray(x))[0], np.float32)
    got = t_moe.apply_moe(tc, tp, _t(x))[0]

    def rel(y):
        return float(np.linalg.norm(y - f32) / np.linalg.norm(f32))

    e_ref, e_port = rel(ref), rel(got.numpy())
    assert 0 < e_ref < 0.05
    assert e_port <= BF16_ERR_FACTOR * e_ref, (e_port, e_ref)


@pytest.mark.parametrize("n", [1, 3, 4, 15, 16, 17, 32, 2048, 16_383,
                               16_384, 20_480])
def test_moe_num_groups_matches_reference(n):
    assert t_tr.moe_num_groups(n) == j_tr.moe_num_groups(n)
