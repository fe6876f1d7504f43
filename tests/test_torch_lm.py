"""The port's LM serving side (``repro_torch.configs``, ``models.blocks``
LM part, ``models.attention``, ``models.mamba``, ``models.moe``,
``models.rwkv``, ``models.transformer``, ``models.encdec``,
``models.api``, the LM side of ``models.frontends``, ``launch.serve``)
against the reference (``repro``).

Every comparison feeds the same numpy inputs, and the reference's own
params tree carried across with ``params_from_numpy``, to both sides;
the port runs on the CPU, so its Mamba layers run the selective scan's
plain version.  Tolerances: f32 paths within ``rtol=1e-4, atol=1e-5``
(the reference invariant's bound, ``tests/test_model_components.py``:
the same f32 arithmetic, sums in another order).  The LM configs
materialize logits in bf16 (``logit_dtype``), where one f32 rounding
difference can move a logit by one bf16 step, so the tight logit checks
run with ``logit_dtype="float32"`` and the bf16 logits are held within
``rtol=8e-3`` (one bf16 step is at most 2^-7 of the value); served
tokens are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs import base as j_base
from repro.launch import serve as j_serve
from repro.models import api as j_api
from repro.models import attention as j_attn
from repro.models import blocks as j_blocks
from repro.models import frontends as j_front
from repro.models import mamba as j_mamba
from repro.models import transformer as j_tr
from repro.runtime.fault_tolerance import (
    choose_mesh_shape as j_choose_mesh_shape)
from repro_torch import configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.launch import serve as t_serve
from repro_torch.models import api as t_api
from repro_torch.models import attention as t_attn
from repro_torch.models import blocks as t_blocks
from repro_torch.models import frontends as t_front
from repro_torch.models import mamba as t_mamba
from repro_torch.models import transformer as t_tr
from repro_torch.models.frontends import CudaUnavailableError

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_LOGITS = dict(rtol=8e-3, atol=1e-5)
DTYPES = ("param", "compute", "moment", "logit", "attn_score")
# the served smoke configs, all ten architectures: jamba with and
# without MoE (hybrid), the dense ones — llama, chatglm3 (half RoPE), olmo
# (non-parametric LayerNorm, tied embeddings), starcoder2 (LayerNorm and
# GELU) — dbrx (MoE, SwiGLU, LayerNorm) and grok (MoE, GeGLU) under both
# dispatch modes, rwkv6 (ssm), llava (precomputed embeddings) and
# seamless (encoder-decoder, sinusoidal positions)
SERVED = {"jamba": ("jamba-1.5-large-398b", dict(moe=None)),
          "jamba_moe": ("jamba-1.5-large-398b", {}),
          "llama": ("llama3.2-1b", {}),
          "chatglm": ("chatglm3-6b", {}),
          "olmo": ("olmo-1b", {}),
          "starcoder2": ("starcoder2-15b", {}),
          "dbrx": ("dbrx-132b", {}),
          "grok": ("grok-1-314b", {}),
          "grok_scatter": ("grok-1-314b", dict(moe_dispatch="scatter")),
          "rwkv": ("rwkv6-3b", {}),
          "llava": ("llava-next-34b", {}),
          "seamless": ("seamless-m4t-large-v2", {})}
# bf16 compute: each side's relative L2 logit error against the
# reference's f32 model.  The two round in bf16 at different places, so
# their errors differ; at these inputs the port's is 0.95-1.33x the
# reference's (jamba the highest), and a bound of 1.5x still catches a
# port that rounds twice as often as the reference.
BF16_ERR_FACTOR = 1.5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tol)


def _both(arch, smoke=True, **replace):
    return (dataclasses.replace(j_configs.get_config(arch, smoke=smoke),
                                **replace),
            dataclasses.replace(t_configs.get_config(arch, smoke=smoke),
                                **replace))


def _small(**kw):
    """The reference invariant tests' config (``_cfg``), on both sides."""
    base = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
                compute_dtype="float32")
    base.update(kw)
    jkw, tkw = dict(base), dict(base)
    if "mamba" in kw:
        jkw["mamba"] = j_base.MambaConfig(**kw["mamba"])
        tkw["mamba"] = t_base.MambaConfig(**kw["mamba"])
    return j_base.ModelConfig(**jkw), t_base.ModelConfig(**tkw)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", j_configs.ARCH_NAMES)
def test_configs_equal_reference(arch):
    for smoke in (False, True):
        jc, tc = (m.get_config(arch, smoke=smoke)
                  for m in (j_configs, t_configs))
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        for which in DTYPES:
            assert str(tc.dtype(which)) == f"torch.{jc.dtype(which).name}"
        for prop in ("group_size", "attn_layout", "d_inner", "dt_rank"):
            assert getattr(tc, prop) == getattr(jc, prop), prop
        for active in (False, True):
            assert tc.param_count(active) == jc.param_count(active)
        assert t_tr.block_period(tc) == j_tr.block_period(jc)
        assert t_tr.period_pattern(tc) == j_tr.period_pattern(jc)


def test_registry_shapes_and_applicability():
    assert t_configs.ARCH_NAMES == j_configs.ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in t_base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_base.SHAPES.items()}
    for arch in j_configs.ARCH_NAMES:
        for name in j_base.SHAPES:
            assert t_base.shape_applicable(
                t_configs.get_config(arch), t_base.SHAPES[name]) == \
                j_base.shape_applicable(j_configs.get_config(arch),
                                        j_base.SHAPES[name])
    with pytest.raises(KeyError) as want:
        j_configs.get_config("gpt-5")
    with pytest.raises(KeyError) as got:
        t_configs.get_config("gpt-5")
    assert str(got.value) == str(want.value)
    assert set(t_configs.all_configs(smoke=True)) == set(
        j_configs.ARCH_NAMES)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("served", list(SERVED))
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_from_numpy_carries_the_reference_tree(served, param_dtype):
    arch, rep = SERVED[served]
    jc, tc = _both(arch, param_dtype=param_dtype, **rep)
    jp = _np(j_api.init_params(jc, jax.random.PRNGKey(0)))
    tp = t_tr.params_from_numpy(jp, device="cpu")
    want, got = dict(_leaves(jp)), dict(_leaves(tp))
    assert list(got) == list(want)
    for path, a in want.items():
        t = got[path]
        assert str(t.dtype) == f"torch.{a.dtype.name}", path
        np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                      a.astype(np.float32), err_msg=path)
    # the port's own init draws the same tree, key for key and dtype
    own = dict(_leaves(t_api.init_params(tc, 0, device="cpu")))
    assert sorted(own) == sorted(want)
    for path, t in own.items():
        assert tuple(t.shape) == want[path].shape, path
        assert t.dtype == got[path].dtype, path


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm",
                                  "layernorm_nonparam"])
def test_norms_match_reference(norm):
    jc, tc = _small(norm=norm)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    p = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in _np(j_blocks.init_norm(jc)).items()}
    want = j_blocks.apply_norm(jc, jax.tree.map(jnp.asarray, p),
                               jnp.asarray(x))
    got = t_blocks.apply_norm(tc, {k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, **F32)
    assert set(t_blocks.init_norm(tc)) == set(p)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu_sq"])
def test_ffn_matches_reference(act):
    jc, tc = _small(activation=act)
    p = _np(j_blocks.init_ffn(jc, jax.random.PRNGKey(1)))
    x = np.random.default_rng(1).normal(size=(2, 5, 32)).astype(np.float32)
    want = j_blocks.apply_ffn(jc, p, jnp.asarray(x))
    got = t_blocks.apply_ffn(tc, {k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, **F32)


@pytest.mark.parametrize("style", ["full", "half", "none"])
def test_rope_matches_reference(style):
    jc, tc = _small(rope_style=style)
    x = np.random.default_rng(2).normal(size=(2, 7, 4, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10), (2, 7))
    if style == "none":
        tx = _t(x)
        assert t_blocks.apply_rope(tc, tx, None, None) is tx
        return
    jcos, jsin = j_blocks.rope_freqs(jc, jnp.asarray(pos))
    tcos, tsin = t_blocks.rope_freqs(tc, _t(pos))
    _close(tcos, jcos, **F32)
    _close(tsin, jsin, **F32)
    _close(t_blocks.apply_rope(tc, _t(x), tcos, tsin),
           j_blocks.apply_rope(jc, jnp.asarray(x), jcos, jsin), **F32)


def test_embed_and_logits_match_reference():
    for tie in (True, False):
        jc, tc = _small(tie_embeddings=tie, logit_dtype="float32")
        p = _np(j_blocks.init_embed(jc, jax.random.PRNGKey(3)))
        tp = {k: _t(v) for k, v in p.items()}
        tokens = np.random.default_rng(3).integers(0, 64, (2, 6))
        want = j_blocks.embed_tokens(jc, p, jnp.asarray(tokens))
        got = t_blocks.embed_tokens(tc, tp, _t(tokens))
        _close(got, want, rtol=0, atol=0)
        _close(t_blocks.lm_logits(tc, tp, got),
               j_blocks.lm_logits(jc, p, want), **F32)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
# (Sq, Skv, causal, config changes): each takes the branch it names
ATTN_CASES = {
    "naive": (40, 40, True, {}),
    "naive_cross": (24, 56, True, {}),
    "naive_ragged": (2100, 2100, True, {}),       # 2100 % 512 != 0
    "chunked": (2048, 2048, True, {}),
    "chunked_cached": (1024, 4096, True, {}),
    "chunked_full": (2048, 2048, False, {}),
    "chunked_skip": (2048, 2048, True, dict(causal_skip=True)),
    "chunked_bf16_scores": (2048, 2048, True,
                            dict(attn_score_dtype="bfloat16")),
    "chunked_unrolled": (4096, 4096, True, dict(scan_layers=False)),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_full_attention_matches_reference(case):
    sq, skv, causal, kw = ATTN_CASES[case]
    jc, tc = _small(n_heads=2, n_kv_heads=1, head_dim=8, **kw)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, sq, 2, 8)).astype(np.float32)
    k, v = (rng.normal(size=(1, skv, 1, 8)).astype(np.float32)
            for _ in range(2))
    naive = sq * skv <= 4096 * 4096 // 8 or sq % 512 or skv % 1024
    assert bool(naive) == case.startswith("naive")
    want = j_attn.full_attention(jc, *(jnp.asarray(a) for a in (q, k, v)),
                                 causal=causal)
    got = t_attn.full_attention(tc, _t(q), _t(k), _t(v), causal=causal)
    tol = (dict(rtol=2e-2, atol=2e-2) if "bf16" in case else F32)
    _close(got, want, **tol)


@pytest.mark.parametrize("pos", ["scalar", "per_slot"])
def test_decode_attn_matches_reference(pos):
    jc, tc = _small(rope_style="full")
    p = _np(j_attn.init_attn(jc, jax.random.PRNGKey(5)))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 1, 32)).astype(np.float32)
    ck, cv = (rng.normal(size=(3, 20, 2, 8)).astype(np.float32)
              for _ in range(2))
    at = 11 if pos == "scalar" else np.array([4, 11, 19])
    want = j_attn.decode_attn(jc, p, jnp.asarray(x), jnp.asarray(ck),
                              jnp.asarray(cv), jnp.asarray(at))
    tck, tcv = _t(ck), _t(cv)
    got = t_attn.decode_attn(tc, {k: _t(v) for k, v in p.items()}, _t(x),
                             tck, tcv, at if pos == "scalar" else _t(at))
    for g, w in zip(got, want):
        _close(g, w, **F32)
    np.testing.assert_array_equal(tck.numpy(), ck)    # not written


def test_attn_block_and_kv_cache_match_reference():
    jc, tc = _small(rope_style="half")
    p = _np(j_attn.init_attn(jc, jax.random.PRNGKey(6)))
    x = np.random.default_rng(6).normal(size=(2, 9, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    want_o, (want_k, want_v) = j_attn.attn_block(jc, p, jnp.asarray(x),
                                                 jnp.asarray(pos))
    got_o, (got_k, got_v) = t_attn.attn_block(
        tc, {k: _t(v) for k, v in p.items()}, _t(x), _t(pos))
    for g, w in ((got_o, want_o), (got_k, want_k), (got_v, want_v)):
        _close(g, w, **F32)
    jkv = j_attn.init_kv_cache(jc, 2, 16, 3)
    tkv = t_attn.init_kv_cache(tc, 2, 16, 3)
    for key in ("k", "v"):
        assert tuple(tkv[key].shape) == jkv[key].shape
        assert not tkv[key].any()


# ---------------------------------------------------------------------------
# mamba
# ---------------------------------------------------------------------------
MAMBA = dict(family="hybrid", mamba=dict(d_state=4, d_conv=2, expand=2))


@pytest.mark.parametrize("d_conv", [2, 4])
def test_mamba_matches_reference(d_conv):
    jc, tc = _small(family="hybrid",
                    mamba=dict(d_state=4, d_conv=d_conv, expand=2))
    p = _np(j_mamba.init_mamba(jc, jax.random.PRNGKey(7)))
    tp = {k: _t(v) for k, v in p.items()}
    x = np.random.default_rng(7).normal(size=(2, 6, 32)).astype(np.float32)
    _close(t_mamba.mamba_forward(tc, tp, _t(x)),
           j_mamba.mamba_forward(jc, p, jnp.asarray(x)), **F32)
    want_y, want_c = j_mamba.mamba_forward_with_cache(jc, p, jnp.asarray(x))
    got_y, got_c = t_mamba.mamba_forward_with_cache(tc, tp, _t(x))
    _close(got_y, want_y, **F32)
    for key in ("conv", "ssm"):
        _close(got_c[key], want_c[key], **F32)
    # one more token through the decode step, from the prefill's cache
    x1 = np.random.default_rng(8).normal(size=(2, 1, 32)).astype(np.float32)
    want_s, want_sc = j_mamba.mamba_step(jc, p, jnp.asarray(x1), want_c)
    got_s, got_sc = t_mamba.mamba_step(tc, tp, _t(x1), got_c)
    _close(got_s, want_s, **F32)
    for key in ("conv", "ssm"):
        _close(got_sc[key], want_sc[key], **F32)
    zero_j = j_mamba.init_mamba_cache(jc, 2)
    zero_t = t_mamba.init_mamba_cache(tc, 2)
    for key in ("conv", "ssm"):
        assert tuple(zero_t[key].shape) == zero_j[key].shape
        assert str(zero_t[key].dtype) == f"torch.{zero_j[key].dtype.name}"


def test_mamba_seq_vs_step():
    """The reference invariant in the port: the sequence forward (the
    selective scan) equals token-by-token decode."""
    _, tc = _small(**MAMBA)
    tp = t_mamba.init_mamba(tc, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 6, 32)).astype(np.float32))
    y_seq, cache_seq = t_mamba.mamba_forward_with_cache(tc, tp, x)
    cache = t_mamba.init_mamba_cache(tc, 2, dtype=torch.float32)
    ys = []
    for t in range(6):
        y_t, cache = t_mamba.mamba_step(tc, tp, x[:, t:t + 1], cache)
        ys.append(y_t)
    torch.testing.assert_close(y_seq, torch.cat(ys, dim=1), **F32)
    torch.testing.assert_close(cache_seq["ssm"], cache["ssm"], **F32)


def test_scan_operands_are_what_the_layer_scans():
    from repro_torch.kernels.mamba_scan.scan import selective_scan
    _, tc = _small(**MAMBA)
    tp = t_mamba.init_mamba(tc, torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(10).normal(
        size=(2, 6, 32)).astype(np.float32))
    x1f, dt, bp, cp, a = t_mamba.scan_operands(tc, tp, x)
    assert tuple(x1f.shape) == tuple(dt.shape) == (2, 6, tc.d_inner)
    assert tuple(bp.shape) == tuple(cp.shape) == (2, 6, 4)
    assert tuple(a.shape) == (tc.d_inner, 4) and bool((a < 0).all())
    _, h = selective_scan(x1f, dt, bp, cp, a)
    _, cache = t_mamba.mamba_forward_with_cache(tc, tp, x)
    assert torch.equal(h, cache["ssm"])


# ---------------------------------------------------------------------------
# the stack: prefill, decode, caches, serving
# ---------------------------------------------------------------------------
def _served(served, **replace):
    arch, rep = SERVED[served]
    jc, tc = _both(arch, **rep, **replace)
    jp = j_api.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, t_tr.params_from_numpy(_np(jp), device="cpu")


def _batch(cfg, b, s, rng):
    """Numpy prefill inputs: embeddings for an ``embed_inputs`` config,
    token ids otherwise, both for the encoder-decoder."""
    out = {}
    if cfg.embed_inputs:
        out["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    if not cfg.embed_inputs or cfg.family == "encdec":
        out["tokens"] = rng.integers(1, cfg.vocab_size, (b, s))
    return out


def _next(cfg, b, rng):
    """The decode step's input: a token, or an embedding (B, 1, D)."""
    if cfg.embed_inputs and cfg.family != "encdec":
        return rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    return rng.integers(1, cfg.vocab_size, (b, 1))


def _jx(a):
    return jnp.asarray(a, jnp.int32 if a.dtype.kind == "i" else None)


def _jbatch(batch):
    return {k: _jx(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


@pytest.mark.parametrize("served", list(SERVED))
def test_prefill_and_decode_match_reference(served):
    jc, tc, jp, tp = _served(served, logit_dtype="float32")
    rng = np.random.default_rng(11)
    batch = _batch(jc, 2, 12, rng)
    want_l, want_c, want_s = j_api.prefill_step(jc, jp, _jbatch(batch),
                                                pad_to=20)
    got_l, got_c, got_s = t_api.prefill_step(tc, tp, _tbatch(batch),
                                             pad_to=20)
    assert got_s == want_s == 12
    _close(got_l, want_l, **F32)
    want_leaves, got_leaves = dict(_leaves(_np(want_c))), dict(
        _leaves(got_c))
    assert list(got_leaves) == list(want_leaves)
    for path, w in want_leaves.items():
        assert tuple(got_leaves[path].shape) == w.shape, path
        _close(got_leaves[path], w, **F32)
    nxt = _next(jc, 2, rng)
    for pos in (12, np.array([12, 12])):
        want_l2, want_c2 = j_api.decode_step(
            jc, jp, want_c, _jx(nxt), jnp.asarray(pos))
        got_l2, got_c2 = t_api.decode_step(
            tc, tp, got_c, _t(nxt), pos if np.ndim(pos) == 0 else _t(pos))
        _close(got_l2, want_l2, **F32)
        for path, w in _leaves(_np(want_c2)):
            _close(dict(_leaves(got_c2))[path], w, **F32)


@pytest.mark.parametrize("served", list(SERVED))
def test_bf16_logits_match_reference(served):
    jc, tc, jp, tp = _served(served)
    assert tc.dtype("logit") == torch.bfloat16
    batch = _batch(jc, 1, 10, np.random.default_rng(12))
    want, _, _ = j_api.prefill_step(jc, jp, _jbatch(batch))
    got, _, _ = t_api.prefill_step(tc, tp, _tbatch(batch))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), **BF16_LOGITS)


@pytest.mark.parametrize("served", list(SERVED))
def test_bf16_compute_error_is_the_references(served):
    """At ``compute_dtype="bfloat16"`` the port's prefill logits lie
    within ``BF16_ERR_FACTOR`` times the reference's own bf16 error of the
    reference's f32 logits (relative L2; logits kept in f32 so only the
    compute dtype differs)."""
    jc, tc, jp, tp = _served(served, compute_dtype="bfloat16",
                             logit_dtype="float32")
    jc32 = dataclasses.replace(jc, compute_dtype="float32")
    nbatch = _batch(jc, 2, 12, np.random.default_rng(13))
    batch = _jbatch(nbatch)
    f32 = np.asarray(j_api.prefill_step(jc32, jp, batch)[0], np.float32)
    ref = np.asarray(j_api.prefill_step(jc, jp, batch)[0], np.float32)
    got = t_api.prefill_step(tc, tp, _tbatch(nbatch))[0]
    assert got.dtype == torch.float32

    def rel(x):
        return float(np.linalg.norm(x - f32) / np.linalg.norm(f32))

    e_ref, e_port = rel(ref), rel(got.numpy())
    # bf16 can flip a top-k routing choice in the reference itself, a
    # discrete jump (dbrx at these inputs: one row of two moves 0.2956,
    # the other 0.0077); the factor bound is held all the same
    assert 0 < e_ref < (0.5 if jc.moe else 0.05)
    assert e_port <= BF16_ERR_FACTOR * e_ref, (e_port, e_ref)


@pytest.mark.parametrize("served", list(SERVED))
def test_init_decode_caches_match_reference(served):
    jc, tc, _, _ = _served(served)
    want = dict(_leaves(_np(j_api.init_decode_caches(jc, 3, 24))))
    got = dict(_leaves(t_api.init_decode_caches(tc, 3, 24, device="cpu")))
    assert list(got) == list(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert str(got[path].dtype) == f"torch.{w.dtype.name}", path
        assert not got[path].any()


@pytest.mark.parametrize("served", list(SERVED))
def test_serving_loop_gives_the_reference_tokens(served, monkeypatch,
                                                 capsys):
    """The reference ``serve`` and the port's loop, on the same seed,
    prompts and (carried-across) params, emit the same tokens; dead slots
    decode too (and, under MoE, compete for expert capacity), as in the
    reference.  Both command lines refuse an ``embed_inputs`` arch with
    the same message."""
    arch, _ = SERVED[served]
    jc, tc, _, tp = _served(served)
    monkeypatch.setattr(j_serve, "get_config",
                        lambda name, smoke=False: jc)
    argv = ["--arch", arch, "--smoke", "--requests", "6", "--slots", "3",
            "--max-len", "40", "--max-new", "12", "--seed", "0"]
    if jc.embed_inputs:
        monkeypatch.setattr(t_serve, "get_config",
                            lambda name, smoke=False: tc)
        with pytest.raises(SystemExit) as want:
            j_serve.serve(argv)
        with pytest.raises(SystemExit) as got:
            t_serve.serve(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value)
        assert "token-in archs" in str(got.value)
        return
    ref = j_serve.serve(argv)
    requests = t_serve.make_requests(tc, 6, 16, 12,
                                     np.random.default_rng(0))
    got, stats = t_serve.serve_requests(tc, tp, requests, slots=3,
                                        max_len=40, device="cpu")
    assert [r.rid for r in got] == [r.rid for r in ref]
    for g, w in zip(got, ref):
        assert g.generated == [int(t) for t in w.generated], g.rid
        assert g.done and len(g.generated) == 12
    assert stats["tokens"] == 72
    out = capsys.readouterr().out
    assert "[serve] 6 requests, 72 tokens" in out


def test_serve_cli_on_the_cpu(capsys):
    done = t_serve.serve(["--arch", "llama3.2-1b", "--smoke", "--requests",
                          "3", "--slots", "2", "--max-new", "4",
                          "--device", "cpu"])
    assert [len(r.generated) for r in done] == [4, 4, 4]
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out


def test_write_slot_pads_the_time_axis_as_the_reference():
    big = {"a": {"k": torch.zeros(1, 3, 8, 2), "s": torch.zeros(1, 3, 5)},
           "b": torch.zeros(4)}
    small = {"a": {"k": torch.ones(1, 1, 5, 2), "s": torch.ones(1, 1, 5)},
             "b": torch.ones(2, 2)}
    out = t_serve.write_slot(big, small, 1)
    assert out["a"]["k"][:, 1, :5].eq(1).all()
    assert not out["a"]["k"][:, 1, 5:].any() and not out["a"]["k"][:, 0].any()
    assert out["a"]["s"][:, 1].eq(1).all() and not out["b"].any()


# ---------------------------------------------------------------------------
# the LM side of models/frontends.py
# ---------------------------------------------------------------------------
FRONT_SHAPES = {"train": (3, 8), "prefill": (2, 5), "decode": (4, 7)}


@pytest.mark.parametrize("kind", list(FRONT_SHAPES))
@pytest.mark.parametrize("arch", j_configs.ARCH_NAMES)
def test_input_specs_and_make_inputs_match_reference(arch, kind):
    """Abstract specs are ``meta`` tensors of the reference's shapes and
    dtypes; concrete inputs are bitwise the reference's (one numpy rng,
    drawn spec by spec in the same order)."""
    jc, tc = _both(arch, smoke=False)
    b, s = FRONT_SHAPES[kind]
    jshape = j_base.ShapeConfig("t", s, b, kind)
    tshape = t_base.ShapeConfig("t", s, b, kind)
    want = j_front.input_specs(jc, jshape)
    got = t_front.make_inputs(tc, tshape)
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].device.type == "meta", name
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype) == f"torch.{w.dtype.name}", name
    want = j_front.make_inputs(jc, jshape, seed=5, abstract=False)
    got = t_front.make_inputs(tc, tshape, seed=5, abstract=False,
                              device="cpu")
    assert list(got) == list(want)
    for name, w in want.items():
        assert str(got[name].dtype) == f"torch.{w.dtype.name}", name
        np.testing.assert_array_equal(
            got[name].to(torch.float32).numpy(), np.asarray(w, np.float32),
            err_msg=name)


@pytest.mark.parametrize("served", ["rwkv", "llava", "dbrx", "seamless"])
def test_prefill_then_step_equals_a_longer_prefill(served):
    """The port's own invariant, in f32: the last-position logits of a
    prefill over S+1 positions equal those of a prefill over S followed
    by one ``decode_step`` (MoE with capacity for every token, since
    capacity follows the group size)."""
    replace = dict(logit_dtype="float32")
    if served == "dbrx":
        replace["moe"] = t_base.MoEConfig(n_experts=4, top_k=2,
                                          capacity_factor=8.0)
    tc = dataclasses.replace(
        t_configs.get_config(SERVED[served][0], smoke=True), **replace)
    tp = t_api.init_params(tc, 0, device="cpu")
    batch = _tbatch(_batch(tc, 2, 9, np.random.default_rng(14)))
    full, _, _ = t_api.prefill_step(tc, tp, batch)
    key = "tokens" if "tokens" in batch else "embeds"
    head = dict(batch, **{key: batch[key][:, :-1]})
    _, caches, s = t_api.prefill_step(tc, tp, head, pad_to=9)
    step, _ = t_api.decode_step(tc, tp, caches, batch[key][:, -1:], s)
    torch.testing.assert_close(step, full, **F32)


# ---------------------------------------------------------------------------
# what the port does not do yet, and the device rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,replace", [
    ("jamba-1.5-large-398b", {}),                 # MoE FFNs
    ("dbrx-132b", {}),                            # MoE FFNs
    ("rwkv6-3b", {}),                             # rwkv sub-blocks
    ("seamless-m4t-large-v2", {}),                # encoder-decoder
    ("llava-next-34b", {}),                       # precomputed embeddings
])
def test_family_configs_train_and_remesh(arch, replace):
    """These archs serve and train: one ``train_step`` on the CPU gives
    finite metrics, and the 2-D training mesh of the survivors'
    ``elastic_remesh`` has the reference's shape."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.fault_tolerance import elastic_remesh
    cfg = dataclasses.replace(t_configs.get_config(arch, smoke=True),
                              **replace)
    params = t_api.init_params(cfg, 0, device="cpu")
    assert t_api.init_decode_caches(cfg, 1, 8, device="cpu")
    opt = AdamWConfig(warmup_steps=2, total_steps=10)
    state = t_api.init_train_state(cfg, opt, 0, device="cpu")
    batch = t_front.make_inputs(cfg, t_base.ShapeConfig("t", 8, 1, "train"),
                                abstract=False, device="cpu")
    loss, _ = t_api.loss_fn(cfg, params, batch)
    _, metrics = t_api.train_step(cfg, opt, state, batch)
    assert torch.isfinite(loss) and all(
        torch.isfinite(v) for v in metrics.values())
    assert elastic_remesh(4, pool=["cpu"] * 4).devices.shape == \
        j_choose_mesh_shape(4)


def test_training_raises_named_errors():
    """Training's named errors: a batch without labels and optimizer
    moments that do not match the params; the 2-D training mesh is
    built (the reference's shape)."""
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.fault_tolerance import elastic_remesh
    _, tc = _both("llama3.2-1b")
    opt = AdamWConfig(warmup_steps=2, total_steps=10)
    state = t_api.init_train_state(tc, opt, 0, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(KeyError, match="labels"):
        t_api.loss_fn(tc, state.params, {"tokens": tokens})
    bad = state._replace(opt=init_opt_state(opt, {"w": torch.zeros(2)}))
    with pytest.raises(ValueError, match="leaves"):
        t_api.train_step(tc, opt, bad, {"tokens": tokens,
                                        "labels": tokens})
    mesh = elastic_remesh(4, pool=["cpu"] * 4)
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == j_choose_mesh_shape(4)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    _, tc = _both("llama3.2-1b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ed = _both("seamless-m4t-large-v2")
    shape = t_base.ShapeConfig("t", 4, 1, "prefill")
    for call in (lambda: t_api.init_params(tc, 0),
                 lambda: t_api.init_decode_caches(tc, 1, 8),
                 lambda: t_api.init_params(ed, 0),
                 lambda: t_api.init_decode_caches(ed, 1, 8),
                 lambda: t_front.make_inputs(ed, shape, abstract=False),
                 lambda: t_tr.params_from_numpy({"w": np.zeros(2)}),
                 lambda: t_serve.serve_requests(tc, {}, [], slots=1,
                                                max_len=8),
                 lambda: t_serve.serve(["--arch", "llama3.2-1b",
                                        "--smoke"])):
        with pytest.raises(CudaUnavailableError, match='device="cpu"'):
            call()
    assert t_api.init_params(tc, 0, device="cpu")["embed"].device.type == \
        "cpu"
