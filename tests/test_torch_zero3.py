"""ZeRO-3 a layer group at a time, and decode caches that stay where
they lie (``repro_torch.distributed.tensor_parallel``: ``Deferred``,
``ZeroPass``, ``ShardGrads``; ``launch/dryrun.py::_rank_caches``).

* A narrow llama on (2, 2) with ``fsdp=True``, its FFN leaves past the
  1 MiB FSDP floor: each layer group's FSDP blocks are gathered over
  "data" when the group runs and its gradient lands on the blocks (a
  reduce-scatter).  The step holds the reference's jitted
  single-device step within ``tests/test_torch_mesh_train.py``'s bars,
  and its loss and gradients equal bitwise the same step without FSDP;
  so does a wider one on (2, 4) whose model ranks share kv heads.
* On ``meta`` (``dryrun.count_step``): one all-gather a group a leaf a
  model rank a pass (two under ``remat="block"``, forward and
  recompute) and one reduce-scatter; doubling the layer count at the
  same width raises the busiest device's temp bytes of the pass by the
  landed gradient's share only, far less than the added groups'
  gathered bytes, where gathering for the whole pass raises it by more
  than those bytes; a prefill, with no gradient, by almost nothing.
* Decode over caches split by sequence: jamba smoke at batch 1 on
  (2, 2) with one kv head (``cache_pspecs`` shards the sequence over
  ("data", "model")), and a llava-like config whose 6 query heads and
  2 kv heads do not divide 4, on (1, 4) (the sequence over "model", the
  attention whole on the first model rank): logits and the new cache
  rows within ``MODEL_TOL`` of the reference's ``decode_step``, each
  block on the rank that holds it, nothing of the cache gathered, and
  the counts alike on ``meta`` (passes and model ranks reused, as the
  production dry-run does) and on CPU logical devices.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import api as j_api
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import shard_train
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import (ShardedTensor, ShardingPolicy,
                                              cache_pspecs, device_put,
                                              params_pspecs, state_pspecs,
                                              to_shardings)
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api as t_api
from repro_torch.models import transformer as t_tr
from repro_torch.models.frontends import input_specs
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from test_torch_tensor_parallel import MODEL_TOL
from test_torch_train import (GRAD_RTOL, METRIC_TOL, PARAM_TOL, TOPT, _both,
                              _grad_atol, _np, _reference_step)

# the FFN leaves (2, 256, 4096) pass the 1 MiB floor; attention's do not
WIDE = dict(d_model=256, d_ff=4096, head_dim=32, logit_dtype="float32")
STEP = ShapeConfig("zero3", 16, 4, "train")
FFN = ("blocks/sub0/ffn/w_down", "blocks/sub0/ffn/w_gate",
       "blocks/sub0/ffn/w_up")
# (replace, (data, model), the per-group leaves): on (2, 4) 2 kv heads
# do not divide 4, so two model ranks share each kv head's columns of
# wk/wv (2, 1024, 512), past the floor: each FSDP block's group slice
# sums two ranks' pieces onto zeros
STEPS = {
    "ffn_2x2": (WIDE, (2, 2), FFN),
    "shared_kv_2x4": (dict(WIDE, d_model=1024, n_heads=4, n_kv_heads=2,
                           head_dim=256, d_ff=1024), (2, 4),
                      ("blocks/sub0/attn/wk", "blocks/sub0/attn/wo",
                       "blocks/sub0/attn/wq", "blocks/sub0/attn/wv")
                      + FFN),
}


def _mesh(data, model, dev="cpu"):
    return make_host_mesh(data, model, devices=[dev] * (data * model))


def _place(tc, mesh, state, fsdp):
    spec = state_pspecs(tc, mesh, state, ShardingPolicy(fsdp=fsdp))
    return device_put(state, to_shardings(mesh, spec))


def _whole(tree):
    return [x.full("cpu") if isinstance(x, ShardedTensor) else x
            for x in tree_leaves(tree)]


@pytest.mark.parametrize("case", list(STEPS))
def test_fsdp_step_gathers_a_group_at_a_time_and_matches_the_reference(
        case):
    wide, shape, per_group = STEPS[case]
    jc, tc = _both("llama", fsdp=True, **wide)
    from repro.models.frontends import make_inputs as j_make_inputs
    from repro.configs.base import ShapeConfig as JShape
    batch = _np(j_make_inputs(jc, JShape(STEP.name, STEP.seq_len,
                                         STEP.global_batch, "train"),
                              abstract=False))
    state0, want, jm, jg = _reference_step(jc, batch)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    mesh = _mesh(*shape)
    state = t_tr.train_state_from_numpy(state0, "cpu")
    placed = _place(tc, mesh, state, True)
    plans = tp.plan_leaves(tc, mesh, placed.params)
    assert sorted(p.path for p in plans if p.per_group) == sorted(per_group)
    assert shard_train.row_split(tc, mesh, tbatch) == (2, None)
    loss, parts, grads = shard_train.loss_and_grads(tc, mesh, placed.params,
                                                    tbatch)
    for p, g in zip(plans, grads):
        assert isinstance(g, tp.ShardGrads) == p.per_group, p.path
    # bitwise the step whose FFN blocks are whole along "data"
    plain = _place(tc, mesh, t_tr.train_state_from_numpy(state0, "cpu"),
                   False)
    p_loss, p_parts, p_grads = shard_train.loss_and_grads(
        tc, mesh, plain.params, tbatch)
    assert torch.equal(loss, p_loss)
    for a, b in zip(shard_train.whole_grads(placed.params, grads),
                    shard_train.whole_grads(plain.params, p_grads)):
        assert torch.equal(a, b)
    new, opt_m = shard_train.apply_updates(TOPT, placed, grads)
    tm = dict(parts, loss=loss, **opt_m)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    lr = float(jm["lr"])
    for (path, wg), tg, wp, tpm in zip(
            jax.tree_util.tree_flatten_with_path(jg)[0],
            shard_train.whole_grads(placed.params, grads),
            jax.tree.leaves(want.params), _whole(new.params)):
        where = jax.tree_util.keystr(path)
        wg = np.asarray(wg, np.float32)
        atol = _grad_atol(wg)
        np.testing.assert_allclose(tg.numpy(), wg, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"grad {where}")
        settled = np.abs(wg) > atol + GRAD_RTOL * np.abs(wg)
        tpm, wp = tpm.float().numpy(), np.asarray(wp, np.float32)
        np.testing.assert_allclose(tpm[settled], wp[settled],
                                   err_msg=f"param {where}", **PARAM_TOL)
        assert np.abs(tpm - wp).max(initial=0) <= 2 * lr, where


def _count(layers, kind, remat="block", whole_pass=False, monkeypatch=None):
    """The dry-run's counter around a (2, 2) meta step of the narrow
    llama with ``layers`` layers: ``kind`` "pass" (``loss_and_grads``)
    or "prefill"; ``whole_pass`` gathers each FSDP leaf for the pass."""
    _, tc = _both("llama", fsdp=True, n_layers=layers, remat=remat, **WIDE)
    if whole_pass:
        plan = tp.plan_leaves
        monkeypatch.setattr(tp, "plan_leaves", lambda *a, **k: [
            dataclasses.replace(p, per_group=False) for p in plan(*a, **k)])
    mesh = _mesh(2, 2, "meta")
    pol = ShardingPolicy(fsdp=True)
    if kind == "pass":
        state = t_api.init_train_state_abstract(tc, AdamWConfig())
        placed = dr.place((state, input_specs(tc, STEP)), (
            to_shardings(mesh, state_pspecs(tc, mesh, state, pol)), None),
            mesh)
        fn = lambda s, b: shard_train.loss_and_grads(  # noqa: E731
            tc, mesh, s.params, b)
    else:
        params = t_api.init_params_abstract(tc)
        placed = dr.place((params, input_specs(tc, STEP)), (
            to_shardings(mesh, params_pspecs(tc, mesh, params, pol)), None),
            mesh)
        fn = lambda p, b: dr.serve_step(  # noqa: E731
            tc, mesh, "prefill", p, b)
    counts = dr.count_step(fn, *placed)
    if whole_pass:
        monkeypatch.undo()
    return tc, counts


def test_gathers_and_temp_bytes_follow_the_groups(monkeypatch):
    """The FFN's three leaves: (G, 256, 4096) split by columns over
    "model" and by rows over "data", a model rank gathers 256 x 2048
    f32 of each a group (2 MiB) and keeps 1 MiB of its gradient."""
    gathered = 256 * 2048 * 4
    for remat, times in (("none", 1), ("block", 2)):
        _, counts = _count(2, "pass", remat)
        for r in range(4):
            ev = [e for e in counts.counter.events if e.rank == r]
            assert sorted((e.kind, e.result_bytes, e.group) for e in ev
                          if e.kind in ("all-gather", "reduce-scatter")) \
                == sorted([("all-gather", gathered, 2)] * (times * 2 * 3)
                          + [("reduce-scatter", gathered // 2, 2)] * 2 * 3)
    temp = {}
    for kind in ("pass", "prefill"):
        for whole in (False, True):
            got = [max(c.counter.peak[r] for r in range(4)) for c in (
                _count(n, kind, whole_pass=whole,
                       monkeypatch=monkeypatch)[1] for n in (2, 4))]
            temp[kind, whole] = got[1] - got[0]
    added = 2 * 3 * gathered      # two more groups' gathered FFN blocks
    landed = added // 2           # their gradient, on a rank's own blocks
    assert temp["pass", True] >= added
    assert temp["pass", False] <= landed + added // 8
    assert temp["prefill", True] >= added
    assert temp["prefill", False] <= added // 16


# ---------------------------------------------------------------------------
# Decode over caches split by sequence
# ---------------------------------------------------------------------------
DECODES = {
    # (TRAINED name, replace, (data, model), batch, cache length, the
    # cache's sequence spec)
    "jamba_seq_data_model": ("jamba", dict(n_kv_heads=1), (2, 2), 1, 32,
                             ("data", "model")),
    "llava_heads_whole": ("llava", dict(n_heads=6, n_kv_heads=2), (1, 4), 2,
                          32, "model"),
}


def _decode_case(name, replace, shape, batch, seq, dev):
    _, tc = _both(name, logit_dtype="float32", **replace)
    mesh = _mesh(*shape, dev)
    caches = t_api.init_decode_caches(tc, batch, seq, device=dev)
    if dev == "meta":
        params = t_api.init_params_abstract(tc)
        tokens = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    else:
        params = t_api.init_params(tc, 0, device=dev)
        rng = np.random.default_rng(31)
        caches = t_tr.tree_map(lambda t: torch.from_numpy(rng.normal(
            size=tuple(t.shape)).astype(np.float32)).to(t.dtype), caches)
        tokens = torch.from_numpy(rng.integers(
            0, tc.vocab_size, (batch, 1)).astype(np.int32))
    pol = ShardingPolicy()
    cspec = cache_pspecs(tc, mesh, caches, pol)
    placed = dr.place((params, caches, {"tokens": tokens}), (
        to_shardings(mesh, params_pspecs(tc, mesh, params, pol)),
        to_shardings(mesh, cspec), None), mesh)
    return tc, mesh, cspec, placed, (params, caches, tokens)


@pytest.mark.parametrize("case", list(DECODES))
def test_decode_over_a_sequence_split_cache(case, monkeypatch):
    name, replace, shape, batch, seq, seq_spec = DECODES[case]
    pos = 21
    tc, mesh, cspec, placed, (params, caches, tokens) = _decode_case(
        name, replace, shape, batch, seq, "cpu")
    assert cspec["sub0"]["k"][2] == seq_spec
    attn = tp.plan_leaves(tc, mesh, placed[0])
    split = any(p.node and p.node.endswith("attn") for p in attn)
    assert split == (name == "jamba")
    # each block stays on the rank that holds it
    local = dr._rank_caches(tc, placed[1], mesh, 0, 1)
    k = placed[1]["sub0"]["k"]
    assert type(local["sub0"]["k"]) is tp.SeqSplit
    assert len(local["sub0"]["k"].parts) == shape[0] * shape[1]
    for part, rank in zip(local["sub0"]["k"].parts,
                          local["sub0"]["k"].group.ranks):
        assert part.data_ptr() == k.shards[rank].data_ptr()
    rows, whole_rows = [], dr._rows
    monkeypatch.setattr(dr, "_rows", lambda st, *a: rows.append(
        tuple(st.shape)) or whole_rows(st, *a))
    with torch.no_grad():
        counts = dr.count_step(lambda p, c, b: dr.serve_step(
            tc, mesh, "decode", p, b, caches=c, pos=pos), *placed)
    assert tuple(k.shape) not in rows
    new = counts.outputs[0][1]
    got = torch.cat([o[0] for o in counts.outputs])
    jc, _ = _both(name, logit_dtype="float32", **replace)
    want, w_caches = j_api.decode_step(
        jc, t_tr.tree_map(lambda t: t.numpy(), params),
        t_tr.tree_map(lambda t: t.numpy(), caches), tokens.numpy(), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    new_k = torch.cat(list(new["sub0"]["k"].parts), dim=2)
    np.testing.assert_allclose(new_k[:, :, pos].numpy(),
                               np.asarray(w_caches["sub0"]["k"])[:, :, pos],
                               **MODEL_TOL)
    # the only all-gathers: q and the new rows (split attention), the
    # logits
    size = new["sub0"]["k"].parts[0].element_size() * tc.head_dim * batch
    assert {e.result_bytes for e in counts.counter.events
            if e.kind == "all-gather"} <= {
        size * tc.n_heads, size * tc.n_kv_heads, batch * tc.vocab_size * 4}
    _, m_mesh, _, meta, _ = _decode_case(name, replace, shape, batch, seq,
                                         "meta")
    with torch.no_grad():
        m = dr.count_step(lambda p, c, b: dr.serve_step(
            tc, m_mesh, "decode", p, b, caches=c, pos=pos), *meta,
            reuse_passes=True)
    for r in range(shape[0] * shape[1]):
        a, b = m.summary(r), counts.summary(r)
        assert (a["flops"], a["bytes_accessed"], a["collectives"]) == \
            (b["flops"], b["bytes_accessed"], b["collectives"]), r

