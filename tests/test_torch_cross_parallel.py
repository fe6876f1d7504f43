"""The encoder-decoder's cross-attention on the "model" axis
(``repro_torch.models.encdec`` under a ``tensor_parallel.Split``): each
model rank its query heads' columns of ``wq``, its kv heads' of
``wk``/``wv`` (``enc_out`` replicated), its rows of ``wo``, as
``param_spec``'s ``"attn" in parent`` splits ``cross_attn``.

* seamless-m4t-large-v2 smoke's cross-attention at tp 2 and 4 against
  the unsplit port and ``repro.models.encdec._cross_attn``: output
  within ``OUT_TOL``, the gradients of ``sum(out * ct)`` (params, the
  decoder stream and ``enc_out``) within ``GRAD_RTOL`` and
  ``GRAD_ATOL_RMS`` of each leaf's RMS.
* The (1, 2) and (2, 2) sharded steps against the reference's jitted
  single-device step (``test_torch_tensor_parallel.check_split_step``:
  no param all-gathered, all-reduces of group tp, each rank its own
  blocks).
* Decode: prefill and 5 steps with ``xk``/``xv`` split by kv head (the
  prefill's layout), and with 2 kv heads at tp 4, where
  ``cache_pspecs`` splits the frozen cache (and the self-attention's)
  by sequence over "model" (``dryrun._rank_caches``): logits within
  ``MODEL_TOL`` of the unsplit port, each rank's cache block the
  unsplit cache's slice, and the only all-gathers q's (and the new
  self-attention rows') and the logits'.
* The dry-run's (2, 4) decode counts alike on ``meta`` and on CPU
  logical devices, rank by rank.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import encdec as j_encdec
from repro.models.frontends import make_inputs as j_make_inputs
from repro_torch.distributed import collectives, tensor_parallel
from repro_torch.distributed.sharding import (ShardingPolicy, cache_pspecs,
                                              device_put, params_pspecs,
                                              to_shardings)
from repro_torch.launch import dryrun as dr
from repro_torch.models import api as t_api
from repro_torch.models import encdec as t_encdec
from repro_torch.models import transformer as t_tr
from repro_torch.optim.adamw import tree_leaves
from test_torch_tensor_parallel import (B, MODEL_TOL, S, STEP_SHAPE, _check,
                                        _mesh, _reference_grads,
                                        _rng_input, _split_grads,
                                        _unsplit_grads, check_split_step)
from test_torch_train import _both, _np, _reference_step

S_ENC = 16


def _params(**more):
    """(reference cfg, port cfg, the port's seeded params as numpy for
    the reference, the params)."""
    jc, tc = _both("seamless", logit_dtype="float32", **more)
    params = t_api.init_params(tc, 0, device="cpu")
    return jc, tc, t_tr.tree_map(lambda t: t.numpy(), params), params


def _paths(tc, params, prefix):
    return [(i, p.path) for i, p in enumerate(tensor_parallel.plan_leaves(
        tc, _mesh(1, 1), params)) if p.path.startswith(prefix)]


@pytest.mark.parametrize("tp", [2, 4])
def test_cross_attention_split_matches_unsplit_and_reference(tp):
    """Group 0's cross-attention: the input is the decoder stream (S
    rows) and ``enc_out`` (``S_ENC`` rows) side by side."""
    jc, tc, jp, params = _params()
    x = _rng_input((B, S + S_ENC, tc.d_model), 21)

    def port(tree, x):
        p = t_tr._group(tree["dec_blocks"], 0)["cross_attn"]
        return t_encdec._cross_attn(tc, p, x[:, :S], x[:, S:])[0]

    def ref(p, x):
        p = jax.tree.map(lambda a: a[0], p["dec_blocks"]["cross_attn"])
        return j_encdec._cross_attn(jc, p, x[:, :S], x[:, S:])[0]

    split = _split_grads(tc, params, tp, port, torch.from_numpy(x))
    unsplit = _unsplit_grads(params, port, torch.from_numpy(x))
    paths = _paths(tc, params, "dec_blocks/cross_attn/")
    _check(split, unsplit, _reference_grads(ref, jp, x), paths)
    assert len(paths) == 4


@pytest.fixture(scope="module")
def reference_step():
    jc, _ = _both("seamless", logit_dtype="float32")
    batch = _np(j_make_inputs(jc, STEP_SHAPE, abstract=False))
    return batch, _reference_step(jc, batch)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_split_step_matches_the_references_single_device_step(
        shape, reference_step):
    check_split_step("seamless", shape, reference_step)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def _prefill(tc, params, tree):
    rng = np.random.default_rng(22)
    batch = {"embeds": torch.from_numpy(rng.normal(
        size=(B, S_ENC, tc.d_model)).astype(np.float32)),
        "tokens": torch.from_numpy(rng.integers(
            0, tc.vocab_size, (B, 8)).astype(np.int32))}
    want, w_c, pos = t_api.prefill_step(tc, params, batch, pad_to=S_ENC)
    got, c, _ = t_api.prefill_step(tc, tree, batch, pad_to=S_ENC)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **MODEL_TOL)
    return want, w_c, c, pos


def _decode(tc, params, tree, want, w_c, c, pos):
    """5 steps on both caches: the events of the split steps, the last
    caches."""
    tok = want.argmax(-1)[:, None]
    events = []
    for step in range(5):
        want_l, w_c = t_api.decode_step(tc, params, w_c, tok, pos + step)
        counter = collectives.CollectiveCounter()
        with collectives.counting(counter):
            got_l, c = t_api.decode_step(tc, tree, c, tok, pos + step)
        events += counter.events
        np.testing.assert_allclose(got_l.numpy(), want_l.numpy(),
                                   err_msg=f"step {step}", **MODEL_TOL)
        tok = want_l.argmax(-1)[:, None]
    return events, w_c, c


@pytest.mark.parametrize("tp", [2, 4])
def test_decode_on_caches_split_by_kv_head(tp):
    """The prefill's ``xk``/``xv`` are ``Split``s of the ranks' kv heads;
    decode attends over them where they lie: only the logits move.  On
    whole caches (the unsplit prefill's) each rank reads its kv heads,
    and the new self-attention rows go back whole."""
    _, tc, _, params = _params()
    tree, _ = tensor_parallel.local_split(tc, params, tp, "cpu")
    want, w_c, c, pos = _prefill(tc, params, tree)
    assert type(c["xk"]) is tensor_parallel.Split
    for label, c in (("split", c), ("whole", w_c)):
        events, w_last, c = _decode(tc, params, tree, want, w_c, c, pos)
        if label == "whole":
            for a, b in zip(tree_leaves(c), tree_leaves(w_last)):
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           **MODEL_TOL)
            continue
        n = tc.n_kv_heads // tp
        for key in ("xk", "xv", "k", "v"):
            for m, part in enumerate(c[key].parts):
                np.testing.assert_allclose(
                    part.numpy(), w_last[key][:, :, :, m * n:(m + 1) * n]
                    .numpy(), err_msg=f"{key} rank {m}", **MODEL_TOL)
        assert {(e.kind, e.result_bytes) for e in events
                if e.kind == "all-gather"} == {("all-gather",
                                                B * tc.vocab_size * 4)}


def test_decode_on_a_frozen_cache_split_by_sequence():
    """2 kv heads at tp 4: ``cache_pspecs`` splits ``xk``/``xv`` (and
    ``k``/``v``) by sequence over "model"; each rank takes every query
    head's softmax partials over its block of the frozen cache, which
    never moves."""
    _, tc, _, params = _params(n_kv_heads=2)
    tp = 4
    tree, _ = tensor_parallel.local_split(tc, params, tp, "cpu")
    want, w_c, _, pos = _prefill(tc, params, tree)
    mesh = _mesh(1, tp)
    cspec = cache_pspecs(tc, mesh, w_c)
    assert tuple(cspec["xk"])[2:4] == ("model", None)
    c = dr._rank_caches(tc, device_put(w_c, to_shardings(mesh, cspec)),
                        mesh, 0, 1)
    assert type(c["xk"]) is tensor_parallel.SeqSplit
    events, w_c, c = _decode(tc, params, tree, want, w_c, c, pos)
    block = S_ENC // tp
    for key in ("xk", "xv", "k", "v"):
        for m, part in enumerate(c[key].parts):
            np.testing.assert_allclose(
                part.numpy(), w_c[key][:, :, m * block:(m + 1) * block]
                .numpy(), err_msg=f"{key} block {m}", **MODEL_TOL)
    kinds = {e.kind for e in events}
    assert "all-to-all" in kinds and kinds <= {"all-gather", "all-to-all",
                                               "all-reduce"}
    # q (self and cross), a new self-attention k or v row, the logits
    f32 = 4
    assert {e.result_bytes for e in events if e.kind == "all-gather"} == {
        B * tc.n_heads * tc.head_dim * f32,
        B * tc.n_kv_heads * tc.head_dim * f32, B * tc.vocab_size * f32}
    # a layer: each rank gathers self q, k and v rows and cross q
    assert sum(e.kind == "all-gather" for e in events) == \
        5 * (4 * tp * tc.n_layers + 1)


def test_decode_counts_alike_on_meta_and_cpu():
    """seamless smoke's decode step on (2, 4) (16 rows, 8 a data rank;
    the caches split by kv head): FLOPs, bytes and collective bytes
    equal on ``meta`` and on CPU logical devices, rank by rank, and the
    data ranks' logits those of the unsplit step."""
    _, tc = _both("seamless", logit_dtype="float32")
    batch, seq, pos = 16, 32, 21
    got = {}
    for dev in ("meta", "cpu"):
        mesh = _mesh(2, 4, dev)
        caches = t_api.init_decode_caches(tc, batch, seq, device=dev)
        if dev == "meta":
            params = t_api.init_params_abstract(tc)
            tokens = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        else:
            params = t_api.init_params(tc, 0, device=dev)
            rng = np.random.default_rng(8)
            caches = t_tr.tree_map(lambda t: torch.from_numpy(rng.normal(
                size=tuple(t.shape)).astype(np.float32)), caches)
            tokens = torch.from_numpy(rng.integers(
                0, tc.vocab_size, (batch, 1)).astype(np.int32))
        pol = ShardingPolicy()
        placed = dr.place((params, caches, {"tokens": tokens}), (
            to_shardings(mesh, params_pspecs(tc, mesh, params, pol)),
            to_shardings(mesh, cache_pspecs(tc, mesh, caches, pol)), None),
            mesh)
        got[dev] = dr.count_step(lambda p, c, b: dr.serve_step(
            tc, mesh, "decode", p, b, caches=c, pos=pos), *placed)
    for r in range(8):
        a, b = got["meta"].summary(r), got["cpu"].summary(r)
        assert (a["flops"], a["bytes_accessed"], a["collectives"]) == \
            (b["flops"], b["bytes_accessed"], b["collectives"]), r
    # each model rank stacks its own blocks of the layers' caches (the
    # work and the memory counted on it, not on the stream's rank)
    stacks = [got["meta"].counter.ranks[r].by_op["stack"] for r in range(8)]
    assert stacks[0] > 0 and len(set(stacks)) == 1, stacks
    outs = got["cpu"].outputs
    assert type(outs[0][1]["xk"]) is tensor_parallel.Split
    want, _ = t_api.decode_step(tc, params, caches, tokens, pos)
    np.testing.assert_allclose(torch.cat([o[0] for o in outs]).numpy(),
                               want.numpy(), **MODEL_TOL)
