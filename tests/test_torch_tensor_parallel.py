"""The "model" axis computes its own shard (``repro_torch.distributed.
tensor_parallel``): each sublayer that ``param_spec`` splits over
"model" runs on every model rank's block, the ranks' outputs summed in
rank order, as GSPMD runs the reference's specs.

* Each split sublayer at tp 2 and 4 on the same seeded numpy inputs:
  forward and gradients (of ``sum(out * cotangent)``; the params' and
  the input's) against the unsplit port function and against the
  reference's JAX function: attention with kv heads split (chatglm3-6b
  smoke at tp 2) and replicated (its 2 kv heads at tp 4), the SwiGLU
  (llama3.2-1b) and GELU (starcoder2-15b) FFN, embed + head + the
  vocabulary-parallel loss with tied (llama) and untied (chatglm)
  weights, and Mamba (jamba's d_inner).  Bars: outputs ``OUT_TOL``
  (f32 sums in another order), gradients ``GRAD_RTOL`` with an atol of
  ``GRAD_ATOL_RMS`` of each leaf's RMS (``test_torch_train``'s).
* The whole sharded step on (1, 2), (2, 2) and (4, 2) for llama,
  chatglm and jamba smoke against the reference's jitted single-device
  ``train_step`` within ``test_torch_train``'s bars
  (``check_split_step``, which ``test_torch_expert_parallel`` runs for
  grok's expert-parallel and expert-hidden steps too); its
  collectives: no param all-gathered over "model" (jamba's MoE experts
  split by expert), all-gathers over "data" only under FSDP, every
  all-reduce of group tp; each model rank computes with its own block
  of every leaf split over "model".
* Prefill and decode split over the model ranks against the unsplit
  port (caches split by kv head, or whole as a cache sharded by
  sequence over "data" too is gathered; a cache split by sequence over
  "model" alone: ``test_torch_expert_parallel``).
* The dry-run's counts: on a (1, 2) llama smoke step every FLOP is a
  split product's, so each model rank counts exactly half of the
  unsplit step's FLOPs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as j_api
from repro.models import attention as j_attn
from repro.models import blocks as j_blocks
from repro.models import mamba as j_mamba
from repro.models.frontends import make_inputs as j_make_inputs
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import shard_train, tensor_parallel
from repro_torch.distributed.sharding import (ShardingPolicy, device_put,
                                              params_pspecs, state_pspecs,
                                              to_shardings)
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api as t_api
from repro_torch.models import attention as t_attn
from repro_torch.models import blocks as t_blocks
from repro_torch.models import mamba as t_mamba
from repro_torch.models import transformer as t_tr
from repro_torch.models.frontends import input_specs, make_inputs
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from test_torch_train import (GRAD_RTOL, METRIC_TOL, PARAM_TOL, TOPT,
                              _both, _grad_atol, _np, _reference_step)

# sublayer outputs: the same f32 products, summed in another order
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
# a two-layer model's logits and caches: the reordered sums of every
# layer on top of each other
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 16
STEP_SHAPE = ShapeConfig("tp_train", 32, 8, "train")


def _mesh(data, model, dev="cpu"):
    return make_host_mesh(data, model, devices=[dev] * (data * model))


def _params(name, **more):
    """(reference cfg, port cfg, reference params (numpy), port params)."""
    jc, tc = _both(name, logit_dtype="float32", **more)
    jp = _np(j_api.init_params(jc, jax.random.PRNGKey(0)))
    return jc, tc, jp, t_tr.params_from_numpy(jp, "cpu")


def _rng_input(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _split_grads(tc, params, tp, fn, x):
    """``fn(tree, x)``'s output and the gradients of ``sum(out * ct)``
    with ``tree`` the split params (``local_split``): (out, grad of x,
    whole grad a leaf in ``tree_leaves`` order)."""
    mesh = _mesh(1, tp)
    placed = device_put(params, to_shardings(
        mesh, params_pspecs(tc, mesh, params)))
    plans = tensor_parallel.plan_leaves(tc, mesh, placed)
    tree, leaves = tensor_parallel.local_split(tc, params, tp, "cpu")
    flat = [(i, m, t) for i, per in enumerate(leaves)
            for m, t in enumerate(per) if t is not None]
    return _grads(fn, tree, x, [t for _, _, t in flat], lambda got: _whole(
        plans, mesh, placed, flat, got, len(leaves), tp))


def _whole(plans, mesh, placed, flat, got, n, tp):
    grads = [[None] * tp for _ in range(n)]
    for (i, m, _), g in zip(flat, got):
        grads[i][m] = g
    acc = []
    tensor_parallel.block_grads(plans, mesh, 0, grads, acc,
                                [t.dtype for t in tree_leaves(placed)])
    return shard_train.whole_grads(placed, acc)


def _unsplit_grads(params, fn, x):
    leaves = tree_leaves(params)
    return _grads(fn, params, x, leaves, lambda got: [
        torch.zeros_like(p) if g is None else g for p, g in zip(leaves,
                                                                 got)])


def _grads(fn, tree, x, wrt, whole):
    x = x.clone().requires_grad_(True) if x.is_floating_point() else x
    for t in wrt:
        t.requires_grad_(True)
    try:
        out = fn(tree, x)
        ct = torch.from_numpy(_rng_input(tuple(out.shape), 99))
        inputs = wrt + ([x] if x.requires_grad else [])
        got = torch.autograd.grad((out * ct).sum(), inputs,
                                  allow_unused=True)
    finally:
        for t in wrt:
            t.requires_grad_(False)
    gx = got[len(wrt)] if x.requires_grad else None
    return out.detach(), gx, whole(list(got[:len(wrt)]))


def _reference_grads(fn, jp, x):
    out = fn(jp, x)
    ct = jnp.asarray(_rng_input(tuple(out.shape), 99))
    args = (1,) if np.issubdtype(np.asarray(x).dtype, np.floating) else ()
    grads = jax.grad(lambda p, x: jnp.sum(fn(p, x) * ct),
                     argnums=(0,) + args)(jp, jnp.asarray(x))
    return (np.asarray(out), np.asarray(grads[1]) if args else None,
            jax.tree.leaves(_np(grads[0])))


def _close_grad(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=GRAD_RTOL,
                               atol=_grad_atol(want), err_msg=what)


def _check(split, unsplit, ref, paths):
    """Outputs and grads: split against unsplit and against the
    reference, on every leaf of ``paths``' positions."""
    (so, sx, sg), (uo, ux, ug), (ro, rx, rg) = split, unsplit, ref
    np.testing.assert_allclose(so.numpy(), uo.numpy(), **OUT_TOL)
    np.testing.assert_allclose(so.numpy(), ro, **OUT_TOL)
    if sx is not None:
        _close_grad(sx, ux.numpy(), "input grad vs unsplit")
        _close_grad(sx, rx, "input grad vs reference")
    for i, path in paths:
        _close_grad(sg[i], ug[i].numpy(), f"{path} vs unsplit")
        _close_grad(sg[i], rg[i], f"{path} vs reference")


def _paths(tc, params, prefix):
    mesh = _mesh(1, 1)
    return [(i, p.path) for i, p in enumerate(
        tensor_parallel.plan_leaves(tc, mesh, params))
        if p.path.startswith(prefix)]


def _sub(tree, sub, key):
    """Group 0 of the stacked ``blocks/<sub>/<key>`` params (a ``Split``
    part by part where split)."""
    return t_tr._group(tree["blocks"], 0)[sub][key]


def _j_sub(jp, sub, key):
    return jax.tree.map(lambda a: a[0], jp["blocks"][sub][key])


# ---------------------------------------------------------------------------
# Sublayers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tp", [2, 4])
def test_attention_split_matches_unsplit_and_reference(tp):
    """chatglm3-6b smoke: 8 query and 2 kv heads; at tp 2 ``wk``/``wv``
    split by kv head, at tp 4 replicated (each rank takes the one kv
    head its 2 query heads use)."""
    jc, tc, jp, params = _params("chatglm")
    kv_split = tc.n_kv_heads % tp == 0
    mesh = _mesh(1, tp)
    specs = params_pspecs(tc, mesh, params)
    assert ("model" in tuple(specs["blocks"]["sub0"]["attn"]["wk"])) == \
        kv_split
    x = _rng_input((B, S, tc.d_model), 1)
    pos = np.broadcast_to(np.arange(S), (B, S))
    tpos = torch.from_numpy(np.array(pos))

    def port(tree, x):
        return t_attn.attn_block(tc, _sub(tree, "sub0", "attn"), x, tpos)[0]

    split = _split_grads(tc, params, tp, port, torch.from_numpy(x))
    unsplit = _unsplit_grads(params, port, torch.from_numpy(x))
    ref = _reference_grads(lambda p, x: j_attn.attn_block(
        jc, _j_sub(p, "sub0", "attn"), x, jnp.asarray(pos))[0], jp, x)
    # only group 0's slice of the stacked leaves has a gradient
    paths = _paths(tc, params, "blocks/sub0/attn/")
    _check(split, unsplit, ref, paths)
    assert len(paths) == 4


@pytest.mark.parametrize("name", ["llama", "starcoder2"])
@pytest.mark.parametrize("tp", [2, 4])
def test_ffn_split_matches_unsplit_and_reference(name, tp):
    """SwiGLU (llama3.2-1b smoke) and GELU (starcoder2-15b smoke):
    ``w_gate``/``w_up``/``w_in`` by columns, ``w_down`` by rows."""
    jc, tc, jp, params = _params(name)
    x = _rng_input((B, S, tc.d_model), 2)

    def port(tree, x):
        return t_blocks.apply_ffn(tc, _sub(tree, "sub0", "ffn"), x)

    split = _split_grads(tc, params, tp, port, torch.from_numpy(x))
    unsplit = _unsplit_grads(params, port, torch.from_numpy(x))
    ref = _reference_grads(lambda p, x: j_blocks.apply_ffn(
        jc, _j_sub(p, "sub0", "ffn"), x), jp, x)
    _check(split, unsplit, ref, _paths(tc, params, "blocks/sub0/ffn/"))


@pytest.mark.parametrize("name", ["llama", "chatglm"])
@pytest.mark.parametrize("tp", [2, 4])
def test_vocabulary_split_matches_unsplit_and_reference(name, tp):
    """embed + head + loss: llama ties ``embed`` to the head, chatglm
    does not; ``embed`` by rows (a rank's range, zeros elsewhere),
    the head by columns, the loss vocabulary-parallel (max, sum of
    exponentials and the target logit over the ranks, z-loss on)."""
    jc, tc, jp, params = _params(name)
    assert tc.tie_embeddings == (name == "llama")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tc.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, tc.vocab_size, (B, S)).astype(np.int32)
    h = _rng_input((B, S, tc.d_model), 4)
    tl, th = torch.from_numpy(labels), torch.from_numpy(h)

    def port(tree, toks):
        x = t_blocks.embed_tokens(tc, tree, toks) + th
        logits = t_blocks.lm_logits(tc, tree, x)
        loss = t_blocks.softmax_xent(logits, tl)
        return torch.stack([loss, torch.mean(x)])

    def ref(p, toks):
        x = j_blocks.embed_tokens(jc, p, toks) + jnp.asarray(h)
        loss = j_blocks.softmax_xent(j_blocks.lm_logits(jc, p, x),
                                     jnp.asarray(labels))
        return jnp.stack([loss, jnp.mean(x)])

    split = _split_grads(tc, params, tp, port, torch.from_numpy(tokens))
    unsplit = _unsplit_grads(params, port, torch.from_numpy(tokens))
    paths = [(i, p) for i, p in _paths(tc, params, "")
             if p in ("embed", "lm_head")]
    _check(split, unsplit, _reference_grads(ref, jp, tokens), paths)
    assert len(paths) == (1 if name == "llama" else 2)


@pytest.mark.parametrize("tp", [2, 4])
def test_mamba_split_matches_unsplit_and_reference(tp):
    """jamba smoke's Mamba layer (d_inner 128): a rank's channels of
    every leaf (``in_proj``'s x1 and z columns moved to it), ``x_proj``'s
    product summed over the ranks, the scan (its plain version here) on
    the rank's channels, ``out_proj`` by rows."""
    jc, tc, jp, params = _params("jamba")
    x = _rng_input((B, S, tc.d_model), 5)

    def port(tree, x):
        return t_mamba.mamba_forward(tc, _sub(tree, "sub1", "mamba"), x)

    split = _split_grads(tc, params, tp, port, torch.from_numpy(x))
    unsplit = _unsplit_grads(params, port, torch.from_numpy(x))
    ref = _reference_grads(lambda p, x: j_mamba.mamba_forward(
        jc, _j_sub(p, "sub1", "mamba"), x), jp, x)
    paths = _paths(tc, params, "blocks/sub1/mamba/")
    _check(split, unsplit, ref, paths)
    assert len(paths) == 9


def test_in_proj_columns_move_to_their_rank():
    """tp = 2: rank 0 stores all of x1 and none of z; each rank
    computes with its x1 and z channels, one of them moved to it."""
    _, tc, _, params = _params("jamba")
    tree, leaves = tensor_parallel.local_split(tc, params, 2, "cpu")
    whole = params["blocks"]["sub1"]["mamba"]["in_proj"]
    di = tc.d_inner
    parts = tree["blocks"]["sub1"]["mamba"].parts
    for m, part in enumerate(parts):
        cols = list(range(m * di // 2, (m + 1) * di // 2))
        cols += [di + c for c in cols]
        assert torch.equal(part["in_proj"], whole[..., cols])


# ---------------------------------------------------------------------------
# The whole step
# ---------------------------------------------------------------------------
STEP_CASES = [(name, shape) for name in ("llama", "chatglm", "jamba")
              for shape in ((1, 2), (2, 2), (4, 2))]


@pytest.fixture(scope="module")
def reference_steps():
    cache = {}

    def get(name):
        if name not in cache:
            jc, _ = _both(name, logit_dtype="float32")
            batch = _np(j_make_inputs(jc, STEP_SHAPE, abstract=False))
            cache[name] = (batch, _reference_step(jc, batch))
        return cache[name]
    return get


@pytest.mark.parametrize("name,shape", STEP_CASES)
def test_split_step_matches_the_references_single_device_step(
        name, shape, reference_steps):
    check_split_step(name, shape, reference_steps(name))


def check_split_step(name, shape, reference):
    """The (dp, tp) step of ``name`` against the reference's jitted
    single-device step (``reference``: its batch, initial state, new
    state, metrics and grads) within ``test_torch_train``'s bars; no
    param is all-gathered over "model" (nor over "data": no FSDP here),
    every all-reduce has group tp, and each model rank computes with
    its own block of every leaf that ``param_spec`` splits over
    "model"."""
    _, tc = _both(name, logit_dtype="float32")
    batch, (state0, want, jm, jg) = reference
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    mesh = _mesh(*shape)
    state = t_tr.train_state_from_numpy(state0, "cpu")
    placed = device_put(state, to_shardings(
        mesh, state_pspecs(tc, mesh, state, ShardingPolicy())))
    counts = dr.count_step(lambda: shard_train.loss_and_grads(
        tc, mesh, placed.params, tbatch))
    loss, parts, grads = counts.outputs
    new, opt_m = shard_train.apply_updates(TOPT, placed, grads)
    tm = dict(parts, loss=loss, **opt_m)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    lr = float(jm["lr"])
    for (path, wg), tg, wp, tp_ in zip(
            jax.tree_util.tree_flatten_with_path(jg)[0],
            shard_train.whole_grads(placed.params, grads),
            jax.tree.leaves(want.params),
            [x.full("cpu") for x in tree_leaves(new.params)]):
        where = jax.tree_util.keystr(path)
        wg = np.asarray(wg, np.float32)
        atol = _grad_atol(wg)
        np.testing.assert_allclose(tg.numpy(), wg, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"grad {where}")
        settled = np.abs(wg) > atol + GRAD_RTOL * np.abs(wg)
        tp_, wp = tp_.float().numpy(), np.asarray(wp, np.float32)
        np.testing.assert_allclose(tp_[settled], wp[settled],
                                   err_msg=f"param {where}", **PARAM_TOL)
        assert np.abs(tp_ - wp).max(initial=0) <= 2 * lr, where
    ev = counts.counter.events
    assert not [e for e in ev if e.kind == "all-gather"]
    assert all(e.group == shape[1] for e in ev if e.kind == "all-reduce")
    assert any(e.kind == "all-reduce" for e in ev)
    plans = tensor_parallel.plan_leaves(tc, mesh, placed.params)
    _, leaves = tensor_parallel.rank_params(tc, placed.params, mesh, 0,
                                            plans)
    for plan, per, whole in zip(plans, leaves, [
            x.full("cpu") for x in tree_leaves(new.params)]):
        if "/moe/experts/" in plan.path:
            assert plan.node is not None, plan.path
        if plan.node is not None and len(plan.blocks) > 1 and all(
                pc == [b] for pc, b in zip(plan.pieces, plan.blocks)):
            for m, t in enumerate(per):
                assert torch.equal(t, whole[plan.blocks[m]]), plan.path


def test_fsdp_gathers_over_data_only():
    """llama smoke at the reference's FSDP widths with an 8192-row
    vocabulary on (2, 2): ``embed`` splits over "model" and "data"; each
    model rank gathers its block over "data" (group 2), nothing more."""
    _, tc = _both("llama", d_model=128, d_ff=512, head_dim=16, fsdp=True,
                  vocab_size=8192)
    mesh = _mesh(2, 2, "meta")
    opt = AdamWConfig()
    state = t_api.init_train_state_abstract(tc, opt)
    spec = state_pspecs(tc, mesh, state, ShardingPolicy(fsdp=True))
    assert tuple(spec.params["embed"]) == ("model", "data")
    placed = dr.place((state, input_specs(tc, ShapeConfig("t", 16, 4,
                                                           "train"))),
                      (to_shardings(mesh, spec), None), mesh)
    counts = dr.count_step(lambda s, b: shard_train.train_step(
        tc, opt, s, b), *placed)
    gathers = [e for e in counts.counter.events if e.kind == "all-gather"]
    emb = 8192 * 128 * 4 // 2
    assert sorted((e.rank, e.group, e.result_bytes) for e in gathers) == [
        (r, 2, emb) for r in range(4)]


def test_split_step_runs_the_scan_on_every_model_rank():
    """jamba smoke on (2, 2): each (data, model) rank launches the scan's
    forward and backward on its channels (the plain versions report the
    kernels' work on the CPU)."""
    _, tc = _both("jamba")
    mesh = _mesh(2, 2)
    state = t_api.init_train_state(tc, TOPT, 0, device="cpu")
    placed = device_put(state, to_shardings(
        mesh, state_pspecs(tc, mesh, state, ShardingPolicy())))
    batch = make_inputs(tc, ShapeConfig("t", 32, 8, "train"), seed=0,
                        abstract=False, device="cpu")
    counts = dr.count_step(lambda: shard_train.train_step(
        tc, TOPT, placed, batch))
    for r in range(4):
        assert counts.summary(r)["kernels"] == {
            "selective_scan": 4, "selective_scan_bwd": 2}, r


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["llama", "jamba"])
@pytest.mark.parametrize("tp", [2, 4])
def test_split_prefill_and_decode_match_the_unsplit_port(name, tp):
    """Prefill (caches of the ranks' kv heads and channels), then four
    decode steps on those caches, and on llama's also whole caches (as
    a cache sharded by sequence over "data" and "model" is gathered):
    logits and caches within ``MODEL_TOL`` of the unsplit port's."""
    _, tc, _, params = _params(name)
    tree, _ = tensor_parallel.local_split(tc, params, tp, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, tc.vocab_size, (B, 8)).astype(np.int32))
    want, wc, pos = t_api.prefill_step(tc, params, {"tokens": tokens},
                                       pad_to=12)
    got, gc, _ = t_api.prefill_step(tc, tree, {"tokens": tokens}, pad_to=12)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **MODEL_TOL)
    caches = {"split": gc}
    if name == "llama":
        caches["whole"] = wc
    for label, c in caches.items():
        w_c, tok = wc, want.argmax(-1)[:, None]
        for step in range(4):
            want_l, w_c = t_api.decode_step(tc, params, w_c, tok, pos + step)
            got_l, c = t_api.decode_step(tc, tree, c, tok, pos + step)
            np.testing.assert_allclose(got_l.numpy(), want_l.numpy(),
                                       err_msg=f"{label} step {step}",
                                       **MODEL_TOL)
            tok = want_l.argmax(-1)[:, None]
        if label == "whole":
            for a, b in zip(tree_leaves(c), tree_leaves(w_c)):
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           **MODEL_TOL)


# ---------------------------------------------------------------------------
# The dry-run's counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", ["none", "block"])
def test_each_model_rank_counts_half_the_split_products(remat):
    """llama smoke, (1, 2) on ``meta``: attention, FFN and head are
    split and no other op has a FLOP formula, so without remat each
    model rank's FLOPs (forward and backward) are exactly half of the
    unsplit (1, 1) step's.  Under the smoke config's ``remat="block"``
    the recompute stops before a group's last product, which unsplit is
    the FFN's ``w_down``; split, that is the last model rank's, so rank
    0 also recomputes its half of ``w_down`` (2 N (F/2) D a layer)."""
    _, tc = _both("llama", remat=remat)
    opt = AdamWConfig()
    batch, seq = 4, 32
    shape = ShapeConfig("t", seq, batch, "train")
    flops = {}
    for tp in (1, 2):
        mesh = _mesh(1, tp, "meta")
        state = t_api.init_train_state_abstract(tc, opt)
        spec = state_pspecs(tc, mesh, state)
        placed = dr.place((state, input_specs(tc, shape)),
                          (to_shardings(mesh, spec), None), mesh)
        counts = dr.count_step(lambda s, b: shard_train.train_step(
            tc, opt, s, b), *placed)
        flops[tp] = [counts.summary(r)["flops"] for r in range(tp)]
    half = flops[1][0] / 2
    again = 0 if remat == "none" else \
        tc.n_layers * 2 * batch * seq * (tc.d_ff // 2) * tc.d_model
    assert half > 0
    assert flops[2] == [half + again, half]


def test_kv_heads_follow_the_query_heads():
    _, tc = _both("chatglm")            # 8 query, 2 kv heads
    assert [tensor_parallel.kv_heads(tc, 2, m) for m in range(2)] == \
        [(0, 1), (1, 2)]
    assert [tensor_parallel.kv_heads(tc, 4, m) for m in range(4)] == \
        [(0, 1), (0, 1), (1, 2), (1, 2)]
    odd = dataclasses.replace(tc, n_heads=12, n_kv_heads=3)  # group 4
    with pytest.raises(ValueError, match="group evenly"):
        tensor_parallel.kv_heads(odd, 2, 1)   # heads 6-11: kv 1, 2
