"""The port's encoder-decoder stack (``repro_torch.models.encdec``; the
seamless-m4t backbone) against the reference (``repro.models.encdec``).

The reference's own params (carried across with
``transformer.params_from_numpy``) and the same numpy embeddings and
tokens go through both sides on the CPU.  f32 within ``rtol=1e-4,
atol=1e-5`` (the reference invariant's bound), logits kept in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import encdec as j_ed
from repro_torch import configs as t_configs
from repro_torch.models import api as t_api
from repro_torch.models import encdec as t_ed
from repro_torch.models import transformer as t_tr

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ERR_FACTOR = 1.5      # test_torch_lm.py's rule
ARCH = "seamless-m4t-large-v2"


def _both(**replace):
    replace.setdefault("logit_dtype", "float32")
    return (dataclasses.replace(j_configs.get_config(ARCH, smoke=True),
                                **replace),
            dataclasses.replace(t_configs.get_config(ARCH, smoke=True),
                                **replace))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


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


def _setup(seed=0, **replace):
    jc, tc = _both(**replace)
    jp = j_ed.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, t_tr.params_from_numpy(_np(jp), device="cpu")


def _inputs(jc, b, s_enc, s_dec, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s_enc, jc.d_model)).astype(np.float32),
            rng.integers(1, jc.vocab_size, (b, s_dec)))


def _same_tree(got, want):
    want, got = dict(_leaves(_np(want))), dict(_leaves(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        _close(got[path], w, **F32)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_reference(param_dtype):
    jc, tc = _both(param_dtype=param_dtype)
    want = dict(_leaves(_np(j_ed.init_params(jc, jax.random.PRNGKey(0)))))
    own = dict(_leaves(t_ed.init_params(tc, 0, device="cpu")))
    via_api = dict(_leaves(t_api.init_params(tc, 0, device="cpu")))
    assert sorted(own) == sorted(want) == sorted(via_api)
    for path, w in want.items():
        assert tuple(own[path].shape) == w.shape, path
        assert str(own[path].dtype) == f"torch.{w.dtype.name}", path
        assert torch.equal(own[path], via_api[path]), path
    assert tuple(own["/enc_blocks/attn/wq"].shape)[0] == jc.enc_layers
    assert tuple(own["/dec_blocks/cross_attn/wk"].shape)[0] == jc.n_layers


@pytest.mark.parametrize("s_enc", [1, 9, 24])
def test_encode_matches_reference(s_enc):
    jc, tc, jp, tp = _setup()
    emb, _ = _inputs(jc, 2, s_enc, 1, s_enc)
    _close(t_ed.encode(tc, tp, _t(emb)),
           j_ed.encode(jc, jp, jnp.asarray(emb)), **F32)


@pytest.mark.parametrize("sq,se", [(5, 13), (13, 5), (1, 20)])
def test_cross_attn_matches_reference(sq, se):
    """Non-causal, Sq != Skv, through the port's ``full_attention``."""
    jc, tc, jp, tp = _setup()
    rng = np.random.default_rng(sq * se)
    x = rng.normal(size=(2, sq, jc.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, se, jc.d_model)).astype(np.float32)
    jx = jax.tree.map(lambda t: t[0], jp["dec_blocks"]["cross_attn"])
    tx = {k: v[0] for k, v in tp["dec_blocks"]["cross_attn"].items()}
    want = j_ed._cross_attn(jc, jx, jnp.asarray(x), jnp.asarray(enc))
    got = t_ed._cross_attn(tc, tx, _t(x), _t(enc))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, **F32)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_cached_cross_attn_matches_reference(compute):
    """The cached form's softmax runs in f32 whatever the compute dtype.
    bf16 under ``test_torch_lm.py``'s rule: the port's relative L2 error
    against the reference's f32 result within ``BF16_ERR_FACTOR`` times
    the reference's own bf16 error."""
    jc, tc, jp, tp = _setup(compute_dtype=compute)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 1, jc.d_model)).astype(np.float32)
    k, v = (rng.normal(size=(3, 11, jc.n_kv_heads, jc.head_dim)).astype(
        np.float32) for _ in range(2))
    jx = jax.tree.map(lambda t: t[1], jp["dec_blocks"]["cross_attn"])
    tx = {key: val[1] for key, val in tp["dec_blocks"]["cross_attn"].items()}
    dt = jnp.dtype(compute)
    want = j_ed._cached_cross_attn(jc, jx, *(jnp.asarray(a).astype(dt)
                                             for a in (x, k, v)))
    got = t_ed._cached_cross_attn(tc, tx, *(_t(a).to(tc.dtype("compute"))
                                            for a in (x, k, v)))
    assert str(got.dtype) == f"torch.{compute}"
    if compute == "float32":
        _close(got, want, **F32)
        return
    jc32 = dataclasses.replace(jc, compute_dtype="float32")
    f32 = np.asarray(j_ed._cached_cross_attn(
        jc32, jx, *(jnp.asarray(a) for a in (x, k, v))))

    def rel(y):
        return float(np.linalg.norm(y - f32) / np.linalg.norm(f32))

    e_ref = rel(np.asarray(want, np.float32))
    e_port = rel(got.to(torch.float32).numpy())
    assert 0 < e_ref < 0.05
    assert e_port <= BF16_ERR_FACTOR * e_ref, (e_port, e_ref)


@pytest.mark.parametrize("collect", [False, True])
def test_decode_full_matches_reference(collect):
    jc, tc, jp, tp = _setup()
    emb, tokens = _inputs(jc, 2, 10, 7, 8)
    j_enc = j_ed.encode(jc, jp, jnp.asarray(emb))
    t_enc = t_ed.encode(tc, tp, _t(emb))
    want_x, want_c = j_ed.decode_full(jc, jp, j_enc,
                                      jnp.asarray(tokens, jnp.int32),
                                      collect_cache=collect)
    got_x, got_c = t_ed.decode_full(tc, tp, t_enc, _t(tokens),
                                    collect_cache=collect)
    _close(got_x, want_x, **F32)
    if collect:
        _same_tree(got_c, want_c)
    else:
        assert got_c is None and want_c is None


@pytest.mark.parametrize("pad_to", [None, 12, 32])
def test_prefill_pads_self_attention_caches_only(pad_to):
    """``pad_to`` pads k/v along time; the frozen xk/xv keep the encoder
    length, as the reference's."""
    jc, tc, jp, tp = _setup()
    emb, tokens = _inputs(jc, 2, 9, 12, 9)
    want_l, want_c, want_s = j_ed.prefill(
        jc, jp, {"embeds": jnp.asarray(emb),
                 "tokens": jnp.asarray(tokens, jnp.int32)}, pad_to=pad_to)
    got_l, got_c, got_s = t_ed.prefill(
        tc, tp, {"embeds": _t(emb), "tokens": _t(tokens)}, pad_to=pad_to)
    assert got_s == want_s == 12
    _close(got_l, want_l, **F32)
    _same_tree(got_c, want_c)
    assert got_c["k"].shape[2] == max(pad_to or 12, 12)
    assert got_c["xk"].shape[2] == 9


@pytest.mark.parametrize("pos", ["scalar", "per_slot"])
def test_decode_step_matches_reference(pos):
    jc, tc, jp, tp = _setup()
    emb, tokens = _inputs(jc, 2, 9, 6, 10)
    want_l, want_c, s = j_ed.prefill(
        jc, jp, {"embeds": jnp.asarray(emb),
                 "tokens": jnp.asarray(tokens, jnp.int32)}, pad_to=10)
    _, got_c, _ = t_ed.prefill(
        tc, tp, {"embeds": _t(emb), "tokens": _t(tokens)}, pad_to=10)
    nxt = np.asarray(jnp.argmax(want_l, -1))[:, None]
    at = s if pos == "scalar" else np.array([s, s])
    before = {k: v.clone() for k, v in got_c.items()}
    for step in range(3):
        want_l, want_c = j_ed.decode_step(jc, jp, want_c,
                                          jnp.asarray(nxt, jnp.int32),
                                          jnp.asarray(at + step))
        got_l, got_c2 = t_ed.decode_step(
            tc, tp, got_c, _t(nxt),
            at + step if pos == "scalar" else _t(at + step))
        _close(got_l, want_l, **F32)
        _same_tree(got_c2, want_c)
        if step == 0:       # the caches passed in are not written
            assert all(torch.equal(got_c[k], before[k]) for k in before)
        got_c = got_c2
        nxt = np.asarray(jnp.argmax(want_l, -1))[:, None]


def test_init_decode_caches_match_reference():
    from repro.models import api as j_api
    jc, tc = _both()
    want = j_api.init_decode_caches(jc, 3, 20)
    got = t_api.init_decode_caches(tc, 3, 20, device="cpu")
    assert sorted(got) == sorted(want) == ["k", "v", "xk", "xv"]
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype) == f"torch.{w.dtype.name}", key
        assert not got[key].any()


def test_prefill_then_step_equals_a_longer_prefill():
    """The port's own invariant: prefill of S+1 decoder tokens gives the
    last-position logits of a prefill of S followed by one step."""
    _, tc, _, tp = _setup()
    emb, tokens = _inputs(tc, 2, 8, 7, 11)
    embeds, tokens = _t(emb), _t(tokens)
    full, _, _ = t_ed.prefill(tc, tp, {"embeds": embeds, "tokens": tokens})
    _, caches, s = t_ed.prefill(tc, tp, {"embeds": embeds,
                                         "tokens": tokens[:, :-1]},
                                pad_to=7)
    step, _ = t_ed.decode_step(tc, tp, caches, tokens[:, -1:], s)
    torch.testing.assert_close(step, full, **F32)
