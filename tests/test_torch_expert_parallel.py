"""MoE on the "model" axis and decode over a sequence-split cache
(``repro_torch.models.moe``, ``models/attention.py``,
``distributed/tensor_parallel.py``), against the unsplit port and the
reference.

* The MoE sublayer split over tp model ranks, under both dispatch modes,
  on seeded numpy inputs: expert parallelism where the experts divide tp
  (grok-1-314b smoke's 4 experts at tp 2 and 4, also with a capacity
  that drops pairs), the expert-hidden split where they do not and
  ``d_ff`` does (the 4 experts at tp 8: 16 hidden columns a rank; dbrx
  smoke with 3 experts at tp 2: 48 of 96).  Its output, aux loss and
  the gradients of the params and the input (of ``sum(out * ct)``, the
  aux loss among the outputs) against the unsplit port and
  ``repro.models.moe.apply_moe``: outputs ``OUT_TOL``, gradients
  ``GRAD_RTOL`` with an atol of ``GRAD_ATOL_RMS`` of each leaf's RMS.
* The sharded step of grok (EP on (1, 2), the hidden split on (1, 8))
  against the reference's jitted single-device ``train_step`` within
  ``test_torch_train``'s bars
  (``test_torch_tensor_parallel.check_split_step``): no param is
  all-gathered over "model", and each model rank computes with its own
  expert block.
* The dry-run's counts: on a (1, 2) grok step on ``meta`` each model
  rank counts half of every product but the router's, which the first
  counts whole (once); replaying the ranks between a sublayer's first
  and last (tp 4 and 8) gives every rank the counts of tracing it.
* Decode on a cache split by sequence over the model ranks (chatglm3-6b
  and jamba smoke, 2 kv heads at tp 4): a prefill, then five steps with
  per-row positions that cross the ranks' blocks, within ``MODEL_TOL``
  of the unsplit port, each rank's block the unsplit cache's slice;
  only q, the new rows, the softmax partials and the logits move (no
  all-gather as large as a rank's block).  The same step counts alike on
  ``meta`` and on CPU logical devices of a (2, 4) mesh, rank by rank.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as j_api
from repro.models import moe as j_moe
from repro.models.frontends import make_inputs as j_make_inputs
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives, shard_train, tensor_parallel
from repro_torch.distributed.sharding import (ShardingPolicy, cache_pspecs,
                                              device_put, params_pspecs,
                                              state_pspecs, to_shardings)
from repro_torch.launch import dryrun as dr
from repro_torch.models import api as t_api
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tr
from repro_torch.models.frontends import input_specs
from repro_torch.optim.adamw import AdamWConfig
from test_torch_tensor_parallel import (B, MODEL_TOL, STEP_SHAPE, S, _check,
                                        _j_sub, _mesh, _params, _paths,
                                        _reference_grads, _rng_input,
                                        _split_grads, _sub, _unsplit_grads,
                                        check_split_step)
from test_torch_train import _both, _np, _reference_step

# case -> (smoke config, tp, MoEConfig fields replaced, expert-parallel)
MOE_CASES = {"ep2": ("grok", 2, {}, True),
             "ep4": ("grok", 4, {}, True),
             "ep2_drops": ("grok", 2, {"capacity_factor": 0.5}, True),
             "hidden8": ("grok", 8, {}, False),
             "hidden_e3": ("dbrx", 2, {"n_experts": 3}, False)}
MOE_GROUPS = 2
_SIDES = {}


def _moe_params(name, mode, moe_kw):
    """(reference cfg, port cfg, reference params (numpy), port params)
    of ``name``'s smoke config under ``mode`` with ``moe_kw``."""
    jc, tc = _both(name, logit_dtype="float32", moe_dispatch=mode)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe_kw))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe_kw))
    jp = _np(j_api.init_params(jc, jax.random.PRNGKey(0)))
    return jc, tc, jp, t_tr.params_from_numpy(jp, "cpu")


@pytest.mark.parametrize("mode", ["einsum", "scatter"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_split_matches_unsplit_and_reference(case, mode):
    name, tp, moe_kw, ep = MOE_CASES[case]
    jc, tc, jp, params = _moe_params(name, mode, moe_kw)
    assert (tc.moe.n_experts % tp == 0) == ep and tc.d_ff % tp == 0
    spec = tuple(params_pspecs(tc, _mesh(1, tp), params)[
        "blocks"]["sub0"]["moe"]["experts"]["w_down"])
    assert spec.index("model") == (1 if ep else 2)
    x = _rng_input((B, S, tc.d_model), 7)
    keep = t_moe._route(tc, _sub(params, "sub0", "moe")["router"],
                        torch.from_numpy(x), MOE_GROUPS)[3]
    if "drops" in case:     # a third of the pairs past their capacity
        assert (~keep).sum() > keep.numel() // 3

    def port(tree, x):
        out, aux = t_moe.apply_moe(tc, _sub(tree, "sub0", "moe"), x,
                                   num_groups=MOE_GROUPS)
        return torch.cat([out.reshape(-1), aux.reshape(1)])

    @jax.jit
    def ref(p, x):
        out, aux = j_moe.apply_moe(jc, _j_sub(p, "sub0", "moe"), x,
                                   num_groups=MOE_GROUPS)
        return jnp.concatenate([out.reshape(-1), aux.reshape(1)])

    # the same config at another tp: the same unsplit and reference sides
    key = (name, mode, tuple(moe_kw.items()))
    if key not in _SIDES:
        _SIDES[key] = (_unsplit_grads(params, port, torch.from_numpy(x)),
                       _reference_grads(ref, jp, x))
    split = _split_grads(tc, params, tp, port, torch.from_numpy(x))
    paths = _paths(tc, params, "blocks/sub0/moe/")
    _check(split, *_SIDES[key], paths)
    assert len(paths) == 4     # the router, w_gate, w_up, w_down


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------
# EP and the hidden split (dbrx and grok on (4, 2):
# test_torch_mesh_train.py)
MOE_STEP_CASES = [("grok", (1, 2)), ("grok", (1, 8))]


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


@pytest.mark.parametrize("name,shape", MOE_STEP_CASES)
def test_moe_split_step_matches_the_references_single_device_step(
        name, shape, reference_steps):
    check_split_step(name, shape, reference_steps(name))


# ---------------------------------------------------------------------------
# The dry-run's counts
# ---------------------------------------------------------------------------
def _meta_step(tc, shape, batch=4, seq=16, reuse=True):
    mesh = _mesh(*shape, dev="meta")
    opt = AdamWConfig()
    state = t_api.init_train_state_abstract(tc, opt)
    spec = state_pspecs(tc, mesh, state)
    placed = dr.place((state, input_specs(tc, ShapeConfig(
        "t", seq, batch, "train"))), (to_shardings(mesh, spec), None), mesh)
    return dr.count_step(lambda s, b: shard_train.train_step(tc, opt, s, b),
                         *placed, reuse_passes=reuse)


@pytest.mark.parametrize("mode", ["einsum", "scatter"])
def test_each_model_rank_counts_half_the_expert_products(mode):
    """grok smoke (MoE in every layer, attention and vocabulary split
    too), no remat, (1, 2) on ``meta``: every FLOP is a split product's
    but the router's (2 N D E forward, twice that backward, a layer),
    which the first model rank counts once, and under ``"scatter"`` the
    combine (2 N k D forward, twice that backward, a layer), which every
    rank runs over all (token, slot) pairs; so each rank counts half of
    the rest of the unsplit step's FLOPs, the expert products' among
    them."""
    _, tc = _both("grok", remat="none", moe_dispatch=mode)
    batch, seq = 4, 16
    flops = {tp: [_meta_step(tc, (1, tp), batch, seq).summary(r)["flops"]
                  for r in range(tp)] for tp in (1, 2)}
    per_layer = 3 * 2 * batch * seq * tc.d_model
    router = tc.n_layers * per_layer * tc.moe.n_experts
    combine = tc.n_layers * per_layer * tc.moe.top_k * (mode == "scatter")
    half = (flops[1][0] - router - combine) / 2
    assert half > 0
    assert flops[2] == [half + combine + router, half + combine]


@pytest.mark.parametrize("name,shape", [("grok", (2, 4)),
                                        ("grok_scatter", (1, 8))])
def test_replayed_moe_ranks_count_as_traced(name, shape):
    """EP at tp 4 and the hidden split at tp 8: the ranks between the
    first and the last replay the first's section, and every rank's
    counts equal those of tracing it."""
    _, tc = _both(name)
    got = {reuse: _meta_step(tc, shape, 8, 16, reuse)
           for reuse in (False, True)}
    assert got[True].counter.replayed
    for r in range(shape[0] * shape[1]):
        a, b = got[False].summary(r), got[True].summary(r)
        assert (a["flops"], a["bytes_accessed"], a["collectives"],
                a["aten_ops"]) == (b["flops"], b["bytes_accessed"],
                                   b["collectives"], b["aten_ops"]), r


# ---------------------------------------------------------------------------
# Decode on a sequence-split cache
# ---------------------------------------------------------------------------
SEQ_TP = 4
SEQ_LEN = 16


@pytest.mark.parametrize("name", ["chatglm", "jamba"])
def test_decode_on_a_sequence_split_cache(name):
    """2 kv heads at tp 4: ``cache_pspecs`` splits the sequence over
    "model"; the dry-run's serving step hands each rank its block
    (``dryrun._rank_caches``), and decode attends over it where it
    lies."""
    _, tc, _, params = _params(name)
    assert tc.n_kv_heads % SEQ_TP and tc.n_heads % SEQ_TP == 0
    tree, _ = tensor_parallel.local_split(tc, params, SEQ_TP, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, tc.vocab_size, (B, 8)).astype(np.int32))
    want, w_c, _ = t_api.prefill_step(tc, params, {"tokens": tokens},
                                      pad_to=SEQ_LEN)
    mesh = _mesh(1, SEQ_TP)
    cspec = cache_pspecs(tc, mesh, w_c)
    assert tuple(cspec["sub0"]["k"])[2:4] == ("model", None)
    c = dr._rank_caches(tc, device_put(w_c, to_shardings(mesh, cspec)),
                        mesh, 0, 1)
    assert type(c["sub0"]["k"]) is tensor_parallel.SeqSplit
    block = SEQ_LEN // SEQ_TP
    tok = want.argmax(-1)[:, None]
    events = []
    for step in range(5):
        # row 0 in the third block; row 1 from the second into the third
        pos = torch.tensor([8 + step, 5 + 2 * step])
        want_l, w_c = t_api.decode_step(tc, params, w_c, tok, pos)
        counter = collectives.CollectiveCounter()
        with collectives.counting(counter):
            got_l, c = t_api.decode_step(tc, tree, c, tok, pos)
        events += counter.events
        np.testing.assert_allclose(got_l.numpy(), want_l.numpy(),
                                   err_msg=f"step {step}", **MODEL_TOL)
        tok = want_l.argmax(-1)[:, None]
    for key in ("k", "v"):
        parts = c["sub0"][key].parts
        for m, part in enumerate(parts):
            np.testing.assert_allclose(
                part.numpy(), w_c["sub0"][key][:, :, m * block:
                                               (m + 1) * block].numpy(),
                err_msg=f"{key} block {m}", **MODEL_TOL)
    kinds = {e.kind for e in events}
    assert "all-to-all" in kinds and kinds <= {"all-gather", "all-to-all",
                                               "all-reduce"}
    # q, a new k or v row, the logits: nothing of the cache
    f32 = 4
    assert {e.result_bytes for e in events if e.kind == "all-gather"} == {
        B * tc.n_heads * tc.head_dim * f32,
        B * tc.n_kv_heads * tc.head_dim * f32, B * tc.vocab_size * f32}
    # each rank gathers q and the new k and v rows of the attention
    # layer; the logits' vocabulary shards are gathered once a step
    n_attn = t_tr._n_groups(tc) * sum(kind == "attn" for kind, _ in
                                      t_tr.period_pattern(tc))
    assert sum(e.kind == "all-gather" for e in events) == \
        5 * (3 * SEQ_TP * n_attn + 1)


def _decode_on(tc, mesh, batch, seq, pos, device):
    """The dry-run's decode step of ``tc`` on ``mesh`` at ``pos``: (fn,
    placed params, caches and tokens, the same whole); seeded values on
    the CPU."""
    caches = t_api.init_decode_caches(tc, batch, seq, device=device)
    if device == "meta":
        params = t_api.init_params_abstract(tc)
        tokens = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    else:
        params = t_tr.init_params(tc, 0, device=device)
        rng = np.random.default_rng(8)
        caches = t_tr.tree_map(lambda t: torch.from_numpy(rng.normal(
            size=tuple(t.shape)).astype(np.float32)).to(t.dtype), caches)
        tokens = torch.from_numpy(rng.integers(
            0, tc.vocab_size, (batch, 1)).astype(np.int32))
    pol = ShardingPolicy()
    whole = (params, caches, {"tokens": tokens})
    placed = dr.place(whole, (
        to_shardings(mesh, params_pspecs(tc, mesh, params, pol)),
        to_shardings(mesh, cache_pspecs(tc, mesh, caches, pol)), None),
        mesh)
    return (lambda p, c, b: dr.serve_step(tc, mesh, "decode", p, b,
                                          caches=c, pos=pos),
            placed, whole)


def test_sequence_split_decode_counts_alike_on_meta_and_cpu():
    """jamba smoke's decode step on (2, 4) (its attention cache split by
    sequence, its MoE by expert; 16 rows, so 8 a data rank with 8 of the
    batch's 16 MoE groups): FLOPs, bytes and collective bytes equal on
    ``meta`` and on CPU logical devices, rank by rank, and the data
    ranks' logits those of the unsplit step within ``MODEL_TOL``."""
    _, tc = _both("jamba", logit_dtype="float32")
    batch, seq, pos = 16, 32, 21
    got = {}
    for dev in ("meta", "cpu"):
        mesh = _mesh(2, 4, dev)
        fn, placed, whole = _decode_on(tc, mesh, batch, seq, pos, dev)
        got[dev] = dr.count_step(fn, *placed)
    for r in range(8):
        a, b = got["meta"].summary(r), got["cpu"].summary(r)
        assert (a["flops"], a["bytes_accessed"], a["collectives"]) == \
            (b["flops"], b["bytes_accessed"], b["collectives"]), r
    assert got["meta"].summary(0)["collectives"]["all-to-all"] > 0
    outs = got["cpu"].outputs
    assert len(outs) == 2
    params, caches, data = whole
    want, _ = t_api.decode_step(tc, params, caches, data["tokens"], pos)
    np.testing.assert_allclose(torch.cat([o[0] for o in outs]).numpy(),
                               want.numpy(), **MODEL_TOL)
