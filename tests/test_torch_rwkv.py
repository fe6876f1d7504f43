"""The port's RWKV-6 block (``repro_torch.models.rwkv``) against the
reference (``repro.models.rwkv``).

The same numpy inputs, a non-zero carried state and predecessor token,
and the reference's own params (carried across with
``params_from_numpy``) go through both sides on the CPU.  f32 within
``rtol=1e-4, atol=1e-5`` (the reference invariant's bound); bf16 compute
under ``test_torch_lm.py``'s ``BF16_ERR_FACTOR`` rule.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models import rwkv as j_rwkv
from repro_torch.configs import base as t_base
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models import transformer as t_tr

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ERR_FACTOR = 1.5      # test_torch_lm.py's rule


def _both(head_size=8, lora=4, **kw):
    base = dict(name="t", family="ssm", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=4, head_dim=8, d_ff=64, vocab_size=64,
                norm="layernorm", activation="relu_sq", rope_style="none",
                compute_dtype="float32")
    base.update(kw)
    rc = dict(head_size=head_size, lora_rank_decay=lora)
    return (j_base.ModelConfig(rwkv=j_base.RWKVConfig(**rc), **base),
            t_base.ModelConfig(rwkv=t_base.RWKVConfig(**rc), **base))


def _carry(tree):
    return t_tr.params_from_numpy(jax.tree.map(np.asarray, tree),
                                  device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tol)


def _inputs(jc, b, s, seed):
    """x, a non-zero predecessor token and a non-zero f32 state."""
    rng = np.random.default_rng(seed)
    H, hs = jc.d_model // jc.rwkv.head_size, jc.rwkv.head_size
    return (rng.normal(size=(b, s, jc.d_model)).astype(np.float32),
            rng.normal(size=(b, jc.d_model)).astype(np.float32),
            0.3 * rng.normal(size=(b, H, hs, hs)).astype(np.float32))


@pytest.mark.parametrize("which", ["tm", "cm"])
@pytest.mark.parametrize("prefix", [(), (3,)])
def test_init_tree_matches_reference(which, prefix):
    jc, tc = _both(param_dtype="bfloat16")
    jinit = j_rwkv.init_rwkv_tm if which == "tm" else j_rwkv.init_rwkv_cm
    tinit = t_rwkv.init_rwkv_tm if which == "tm" else t_rwkv.init_rwkv_cm
    jp = jax.tree.map(np.asarray, jinit(jc, jax.random.PRNGKey(0), prefix))
    tp = tinit(tc, torch.Generator().manual_seed(0), prefix)
    assert sorted(tp) == sorted(jp)
    for key, a in jp.items():
        assert tuple(tp[key].shape) == a.shape, key
        assert str(tp[key].dtype) == f"torch.{a.dtype.name}", key
        if key.startswith("mix_") or key == "w0":   # constants: equal
            np.testing.assert_array_equal(
                tp[key].to(torch.float32).numpy(), a.astype(np.float32))


def test_init_state_matches_reference():
    jc, tc = _both(compute_dtype="bfloat16")
    want = j_rwkv.init_rwkv_state(jc, 3)
    got = t_rwkv.init_rwkv_state(tc, 3)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype) == f"torch.{w.dtype.name}", key
        assert not got[key].any()


def test_shift_and_decay_match_reference():
    jc, tc = _both()
    x, prev, _ = _inputs(jc, 2, 5, 0)
    _close(t_rwkv._shift(_t(x), _t(prev)),
           j_rwkv._shift(jnp.asarray(x), jnp.asarray(prev)), rtol=0, atol=0)
    jp = j_rwkv.init_rwkv_tm(jc, jax.random.PRNGKey(1))
    _close(t_rwkv._decay(tc, _carry(jp), _t(x)),
           j_rwkv._decay(jc, jp, jnp.asarray(x)), **F32)


@pytest.mark.parametrize("head_size,seq", [(8, 1), (8, 7), (16, 5),
                                           (32, 3)])
def test_time_mix_with_carried_state_matches_reference(head_size, seq):
    jc, tc = _both(head_size=head_size)
    jp = j_rwkv.init_rwkv_tm(jc, jax.random.PRNGKey(2))
    x, prev, state = _inputs(jc, 2, seq, head_size + seq)
    want = j_rwkv.rwkv_time_mix(jc, jp, jnp.asarray(x), jnp.asarray(prev),
                                jnp.asarray(state))
    ts = _t(state)
    got = t_rwkv.rwkv_time_mix(tc, _carry(jp), _t(x), _t(prev), ts)
    for name, g, w in zip(("out", "last_x", "state"), got, want):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, **F32)
    assert got[2].dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), state)     # not written


def test_group_norm_is_the_population_variance():
    """One head whose channels differ: ``correction=0``, as ``jnp.var``;
    the n-1 divisor would move every normed value by sqrt(8/7)."""
    jc, tc = _both(head_size=8)
    jp = j_rwkv.init_rwkv_tm(jc, jax.random.PRNGKey(3))
    x, prev, state = _inputs(jc, 1, 4, 3)
    want = j_rwkv.rwkv_time_mix(jc, jp, jnp.asarray(x), jnp.asarray(prev),
                                jnp.asarray(state))[0]
    got = t_rwkv.rwkv_time_mix(tc, _carry(jp), _t(x), _t(prev),
                               _t(state))[0]
    _close(got, want, **F32)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2


@pytest.mark.parametrize("seq", [1, 6])
def test_channel_mix_with_carried_token_matches_reference(seq):
    jc, tc = _both()
    jp = j_rwkv.init_rwkv_cm(jc, jax.random.PRNGKey(4))
    x, prev, _ = _inputs(jc, 3, seq, 4 + seq)
    want = j_rwkv.rwkv_channel_mix(jc, jp, jnp.asarray(x), jnp.asarray(prev))
    got = t_rwkv.rwkv_channel_mix(tc, _carry(jp), _t(x), _t(prev))
    for g, w in zip(got, want):
        _close(g, w, **F32)


def test_seq_vs_step():
    """The reference invariant in the port: the sequence forward equals
    token-by-token steps with the carried predecessor and state."""
    _, tc = _both()
    tp = t_rwkv.init_rwkv_tm(tc, torch.Generator().manual_seed(0))
    x = _t(np.random.default_rng(5).normal(size=(2, 5, 32)).astype(
        np.float32))
    st0 = t_rwkv.init_rwkv_state(tc, 2)
    y_seq, _, state_seq = t_rwkv.rwkv_time_mix(tc, tp, x, st0["tm_x"],
                                               st0["state"])
    prev, state, ys = st0["tm_x"], st0["state"], []
    for t in range(5):
        y_t, prev, state = t_rwkv.rwkv_time_mix(tc, tp, x[:, t:t + 1],
                                                prev, state)
        ys.append(y_t)
    torch.testing.assert_close(y_seq, torch.cat(ys, dim=1), **F32)
    torch.testing.assert_close(state_seq, state, **F32)


@pytest.mark.parametrize("which", ["tm", "cm"])
def test_bf16_compute_error_is_the_references(which):
    jc, tc = _both(compute_dtype="bfloat16")
    jc32 = dataclasses.replace(jc, compute_dtype="float32")
    x, prev, state = _inputs(jc, 2, 6, 6)
    if which == "tm":
        jp = j_rwkv.init_rwkv_tm(jc, jax.random.PRNGKey(6))
        args = (jnp.asarray(x), jnp.asarray(prev), jnp.asarray(state))

        def ref(cfg):
            return j_rwkv.rwkv_time_mix(cfg, jp, *args)[0]

        got = t_rwkv.rwkv_time_mix(tc, _carry(jp), _t(x), _t(prev),
                                   _t(state))[0]
    else:
        jp = j_rwkv.init_rwkv_cm(jc, jax.random.PRNGKey(6))

        def ref(cfg):
            return j_rwkv.rwkv_channel_mix(cfg, jp, jnp.asarray(x),
                                           jnp.asarray(prev))[0]

        got = t_rwkv.rwkv_channel_mix(tc, _carry(jp), _t(x), _t(prev))[0]
    f32 = np.asarray(ref(jc32), np.float32)
    bf16 = np.asarray(ref(jc), np.float32)
    assert got.dtype == torch.bfloat16

    def rel(y):
        return float(np.linalg.norm(y - f32) / np.linalg.norm(f32))

    e_ref, e_port = rel(bf16), rel(got.to(torch.float32).numpy())
    assert 0 < e_ref < 0.05
    assert e_port <= BF16_ERR_FACTOR * e_ref, (e_port, e_ref)
