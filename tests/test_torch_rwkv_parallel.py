"""RWKV-6 on the "model" axis (``repro_torch.models.rwkv`` under a
``tensor_parallel.Split``): each model rank runs whole heads, model
rank m the heads [m H / tp, (m + 1) H / tp) (floors), as
``param_spec`` splits the time-mix's ``w_r``/``w_k``/``w_v``/``w_g``
by columns and ``w_o`` by rows over ``D % tp``, and the channel-mix's
``w_k`` by columns and ``w_v`` by rows.

* The time-mix and the channel-mix of rwkv6-3b smoke (4 heads of 16)
  at tp 2 and 4, where the heads divide tp; at tp 8, where a stored
  block is half a head (ranks alternate 0 and 1 heads); and with
  ``d_model`` 96 at tp 4 (6 heads, 1.5 a block).  Output, ``last_x``
  and the new state against the unsplit port and
  ``repro.models.rwkv``'s functions within ``OUT_TOL``; the gradients
  of ``sum(out * ct)`` (params and input) under ``test_torch_train``'s
  rwkv rule: each leaf's max error against the reference's f64
  gradient within ``RWKV_ERR_FACTOR`` of the reference's own f32
  error, or within ``GRAD_ATOL_RMS`` of the leaf's RMS.
* The sharded step on (1, 2) and (2, 2) against the reference's jitted
  single-device step: metrics within ``METRIC_TOL`` (grad_norm and the
  grads under the rwkv rule), params as ``test_torch_train`` holds them.
* Collectives of a pass's params: none where the heads divide tp;
  otherwise collective-permutes only, whose bytes are the columns a
  rank's heads lack of its stored block.
* Prefill and 5 decode steps at tp 2 and 8 against the unsplit port
  within ``MODEL_TOL`` (the state gathered whole into the cache).
* The dry-run at tp 8 with ``d_model`` 160 (10 heads: 1 and 2 a rank):
  the counts with ranks replayed equal a trace of every rank.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as j_rwkv
from repro.models.frontends import make_inputs as j_make_inputs
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives, shard_train, tensor_parallel
from repro_torch.distributed.sharding import (ShardingPolicy, device_put,
                                              params_pspecs, state_pspecs,
                                              to_shardings)
from repro_torch.launch import dryrun as dr
from repro_torch.models import api as t_api
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models import transformer as t_tr
from repro_torch.models.frontends import input_specs
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from test_torch_tensor_parallel import (B, MODEL_TOL, OUT_TOL, S, STEP_SHAPE,
                                        _j_sub, _mesh, _paths,
                                        _rng_input, _split_grads, _sub,
                                        _unsplit_grads)
from test_torch_train import (GRAD_RTOL, METRIC_TOL, PARAM_TOL,
                              RWKV_ERR_FACTOR, TOPT, _Wide, _both,
                              _grad_atol, _np, _reference_step, _wide_grads)

# (tp, config overrides): heads dividing tp, then not
SUB_CASES = [(2, {}), (4, {}), (8, {}), (4, dict(d_model=96))]
WIDE = {f"{k}_dtype": "float64" for k in ("param", "compute", "logit",
                                          "attn_score")}


def _state(tc, seed):
    H, hs = tc.d_model // tc.rwkv.head_size, tc.rwkv.head_size
    return 0.3 * _rng_input((B, H, hs, hs), seed)


def _ref_out(jc, fn, jp, x):
    out = fn(jc, jp, x)
    return jnp.concatenate([o.ravel() for o in out])


def _ref_grads(jc, fn, sub, x, ct, wide=False):
    """The reference sublayer's output and the gradient of
    ``sum(out * ct)`` (jitted): (out, input grad, {leaf name: grad});
    ``wide``: in f64 throughout (``test_torch_train._wide_grads``'
    widening)."""
    def run(sub, x, ct):
        out, vjp = jax.vjp(lambda p, x: _ref_out(jc, fn, p, x), sub, x)
        return (out,) + vjp(ct)[::-1]

    if wide:
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
            mp.setattr(j_rwkv, "jnp", _Wide(jnp, jnp.float64))
            jc = dataclasses.replace(jc, **WIDE)
            f64 = jnp.float64
            got = jax.jit(run)(
                jax.tree.map(lambda a: jnp.asarray(a, f64), sub),
                jnp.asarray(x, f64), jnp.asarray(ct, f64))
    else:
        got = jax.jit(run)(sub, jnp.asarray(x), jnp.asarray(ct))
    out, gx, gp = _np(got)
    return out, gx, gp


def _rwkv_rule(got, ref32, exact, what):
    got = got.detach().double().numpy()
    err = np.abs(got - exact).max(initial=0)
    ref = np.abs(np.asarray(ref32, np.float64) - exact).max(initial=0)
    assert err <= max(RWKV_ERR_FACTOR * ref, _grad_atol(exact)), \
        (what, err, ref)


def _sublayer(tc, jc, key, x_np, prev, state):
    """(port fn(tree, x), reference fn(cfg, p, x)) of the sublayer of
    group 0 at ``key``: outputs flattened and concatenated (out,
    last_x, and the time-mix's new state)."""
    tprev = torch.from_numpy(prev)
    if key == "rwkv_tm":
        tst = torch.from_numpy(state)

        def port(tree, x):
            out, last, st = t_rwkv.rwkv_time_mix(
                tc, _sub(tree, "sub0", key), x, tprev, tst)
            return torch.cat([out.reshape(-1), last.reshape(-1),
                              t_rwkv.whole_state(st).reshape(-1)])

        def ref(cfg, p, x):
            return j_rwkv.rwkv_time_mix(cfg, p, x,
                                        jnp.asarray(prev, x.dtype),
                                        jnp.asarray(state, x.dtype))
    else:
        def port(tree, x):
            out, last = t_rwkv.rwkv_channel_mix(tc, _sub(tree, "sub0", key),
                                                x, tprev)
            return torch.cat([out.reshape(-1), last.reshape(-1)])

        def ref(cfg, p, x):
            return j_rwkv.rwkv_channel_mix(cfg, p, x,
                                           jnp.asarray(prev, x.dtype))
    return port, ref


def _port_params(**more):
    """(reference cfg, port cfg, the port's seeded params and the same
    as numpy for the reference)."""
    jc, tc = _both("rwkv", logit_dtype="float32", **more)
    params = t_tr.init_params(tc, 0, device="cpu")
    return jc, tc, params, t_tr.tree_map(lambda t: t.numpy(), params)


@pytest.mark.parametrize("key", ["rwkv_tm", "rwkv_cm"])
@pytest.mark.parametrize("tp,more", SUB_CASES)
def test_mix_split_matches_unsplit_and_reference(tp, more, key):
    jc, tc, params, jp = _port_params(**more)
    x = _rng_input((B, S, tc.d_model), 11)
    prev, state = _rng_input((B, tc.d_model), 12), _state(tc, 13)
    port, ref = _sublayer(tc, jc, key, x, prev, state)
    so, sx, sg = _split_grads(tc, params, tp, port, torch.from_numpy(x))
    uo, _, _ = _unsplit_grads(params, port, torch.from_numpy(x))
    ct = _rng_input(tuple(so.shape), 99)      # _split_grads' cotangent
    sub = _j_sub(jp, "sub0", key)
    ro, rx, rg = _ref_grads(jc, ref, sub, x, ct)
    _, ex, eg = _ref_grads(jc, ref, sub, x, ct, wide=True)
    np.testing.assert_allclose(so.numpy(), uo.numpy(), **OUT_TOL)
    np.testing.assert_allclose(so.numpy(), ro, **OUT_TOL)
    _rwkv_rule(sx, rx, ex, "input")
    paths = _paths(tc, params, f"blocks/sub0/{key}/")
    assert len(paths) == (14 if key == "rwkv_tm" else 5)
    for i, path in paths:
        name = path.rsplit("/", 1)[-1]
        # group 0's slice of the stacked leaf; the other is zero
        assert not sg[i][1:].any(), path
        _rwkv_rule(sg[i][0], rg[name], eg[name], path)


def test_heads_follow_the_floor_rule():
    _, tc = _both("rwkv")
    assert [tensor_parallel.rwkv_heads(tc, 8, m) for m in range(8)] == [
        (0, 0), (0, 1), (1, 1), (1, 2), (2, 2), (2, 3), (3, 3), (3, 4)]
    assert tensor_parallel.head_owners(tc, 8) == [1, 3, 5, 7]
    big = dataclasses.replace(tc, d_model=2560, rwkv=dataclasses.replace(
        tc.rwkv, head_size=64))                      # rwkv6-3b at tp 16
    sizes = [b - a for a, b in (tensor_parallel.rwkv_heads(big, 16, m)
                                for m in range(16))]
    assert sizes == [2, 3] * 8


# ---------------------------------------------------------------------------
# Collectives of the params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tp,more", SUB_CASES)
def test_params_move_only_the_columns_a_ranks_heads_lack(tp, more):
    """A pass's compute tree (``rank_params``) on (1, tp): where the heads
    divide tp, every split leaf is the rank's stored block (no move);
    otherwise each owner takes the columns of its heads that another
    rank stores, a collective-permute of exactly those bytes, and
    nothing is all-gathered."""
    _, tc, params, _ = _port_params(**more)
    mesh = _mesh(1, tp)
    placed = device_put(params, to_shardings(
        mesh, params_pspecs(tc, mesh, params)))
    counter = collectives.CollectiveCounter()
    with collectives.counting(counter):
        tree, leaves = tensor_parallel.rank_params(tc, placed, mesh, 0)
    hs, D = tc.rwkv.head_size, tc.d_model
    G = t_tr._n_groups(tc)
    lack = 0
    for m in range(tp):
        a, b = tensor_parallel.rwkv_heads(tc, tp, m)
        lo, hi = a * hs, b * hs
        own = max(0, min(hi, (m + 1) * D // tp) - max(lo, m * D // tp))
        lack += (hi - lo - own) * D * G * 4
    lack *= 5                          # w_r, w_k, w_v, w_g and w_o rows
    moves = [e for e in counter.events if e.kind != "collective-permute"]
    assert not moves
    assert sum(e.result_bytes for e in counter.events) == lack
    assert (lack == 0) == (tc.d_model // hs % tp == 0)
    whole = params["blocks"]["sub0"]
    for m, part in enumerate(tree["blocks"]["sub0"]["rwkv_tm"].parts):
        a, b = tensor_parallel.rwkv_heads(tc, tp, m)
        cols = slice(a * hs, b * hs)
        if a == b:
            assert part["w_r"] is None and part["u"] is None
            continue
        assert torch.equal(part["w_k"], whole["rwkv_tm"]["w_k"][..., cols])
        assert torch.equal(part["w_o"], whole["rwkv_tm"]["w_o"][:, cols])
        assert torch.equal(part["u"], whole["rwkv_tm"]["u"][:, a:b])
    for m, part in enumerate(tree["blocks"]["sub0"]["rwkv_cm"].parts):
        f = tc.d_ff // tp
        assert torch.equal(part["w_k"], whole["rwkv_cm"]["w_k"][
            ..., m * f:(m + 1) * f])


# ---------------------------------------------------------------------------
# The whole step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    jc, tc = _both("rwkv", logit_dtype="float32")
    batch = _np(j_make_inputs(jc, STEP_SHAPE, abstract=False))
    state0, want, jm, jg = _reference_step(jc, batch)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    g64, _ = _wide_grads(jc, tc, state0, batch, tbatch)
    return tc, tbatch, state0, want, jm, jg, g64


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_split_step_matches_the_references_single_device_step(shape,
                                                              reference):
    tc, tbatch, state0, want, jm, jg, g64 = reference
    mesh = _mesh(*shape)
    state = t_tr.train_state_from_numpy(state0, "cpu")
    placed = device_put(state, to_shardings(
        mesh, state_pspecs(tc, mesh, state, ShardingPolicy())))
    counts = dr.count_step(lambda: shard_train.loss_and_grads(
        tc, mesh, placed.params, tbatch))
    loss, parts, grads = counts.outputs
    new, opt_m = shard_train.apply_updates(TOPT, placed, grads)
    tm = dict(parts, loss=loss, **opt_m)
    exact = float(np.sqrt(sum(np.sum(g * g) for g in g64)))
    for k in jm:
        if k == "grad_norm":
            assert abs(float(tm[k]) - exact) <= RWKV_ERR_FACTOR * abs(
                float(jm[k]) - exact)
            continue
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    lr = float(jm["lr"])
    for (path, wg), tg, e, wp, tp_ in zip(
            jax.tree_util.tree_flatten_with_path(jg)[0],
            shard_train.whole_grads(placed.params, grads), g64,
            jax.tree.leaves(want.params),
            [x.full("cpu") for x in tree_leaves(new.params)]):
        where = jax.tree_util.keystr(path)
        _rwkv_rule(tg, wg, e, where)
        wg = np.asarray(wg, np.float32)
        atol = np.abs(tg.numpy() - wg).max()
        settled = np.abs(wg) > atol + GRAD_RTOL * np.abs(wg)
        tp_, wp = tp_.float().numpy(), np.asarray(wp, np.float32)
        np.testing.assert_allclose(tp_[settled], wp[settled],
                                   err_msg=f"param {where}", **PARAM_TOL)
        assert np.abs(tp_ - wp).max(initial=0) <= 2 * lr, where
    ev = counts.counter.events
    assert not [e for e in ev if e.kind == "all-gather"]
    assert all(e.group == shape[1] for e in ev if e.kind == "all-reduce")
    plans = tensor_parallel.plan_leaves(tc, mesh, placed.params)
    nodes = {p.node for p in plans if p.node is not None}
    assert {"blocks/sub0/rwkv_tm", "blocks/sub0/rwkv_cm"} <= nodes


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tp", [2, 8])
def test_split_prefill_and_decode_match_the_unsplit_port(tp):
    """Prefill, then 5 decode steps on its caches (the state gathered
    whole from the head owners, ``tm_x``/``cm_x`` the stream's): logits
    and caches within ``MODEL_TOL`` of the unsplit port's."""
    _, tc, params, _ = _port_params()
    tree, _ = tensor_parallel.local_split(tc, params, tp, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, tc.vocab_size, (B, 8)).astype(np.int32))
    want, w_c, pos = t_api.prefill_step(tc, params, {"tokens": tokens})
    got, c, _ = t_api.prefill_step(tc, tree, {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), want.numpy(), **MODEL_TOL)
    tok = want.argmax(-1)[:, None]
    for step in range(5):
        want_l, w_c = t_api.decode_step(tc, params, w_c, tok, pos + step)
        counter = collectives.CollectiveCounter()
        with collectives.counting(counter):
            got_l, c = t_api.decode_step(tc, tree, c, tok, pos + step)
        np.testing.assert_allclose(got_l.numpy(), want_l.numpy(),
                                   err_msg=f"step {step}", **MODEL_TOL)
        tok = want_l.argmax(-1)[:, None]
    for a, b in zip(tree_leaves(c), tree_leaves(w_c)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **MODEL_TOL)
    # the state's heads and the logits are gathered, nothing else
    H, hs = tc.d_model // tc.rwkv.head_size, tc.rwkv.head_size
    assert {e.result_bytes for e in counter.events
            if e.kind == "all-gather"} == {B * H * hs * hs * 4,
                                           B * tc.vocab_size * 4}


# ---------------------------------------------------------------------------
# The dry-run's counts
# ---------------------------------------------------------------------------
def test_replayed_ranks_of_two_head_counts_count_as_traced():
    """``d_model`` 160 at tp 8 (10 heads: ranks hold 1 or 2), one layer on
    ``meta``: each rank before the last is replayed from the first rank
    of its sections' layouts, and every rank counts as a trace of every
    rank does."""
    _, tc = _both("rwkv", d_model=160, n_layers=1)
    mesh = _mesh(1, 8, "meta")
    opt = AdamWConfig()
    got = {}
    for reuse in (False, True):
        state = t_api.init_train_state_abstract(tc, opt)
        placed = dr.place((state, input_specs(tc, ShapeConfig(
            "t", 16, 4, "train"))), (to_shardings(
                mesh, state_pspecs(tc, mesh, state)), None), mesh)
        got[reuse] = dr.count_step(lambda s, b: shard_train.train_step(
            tc, opt, s, b), *placed, reuse_passes=reuse)
    assert got[True].counter.replayed
    for r in range(8):
        a, b = got[False].summary(r), got[True].summary(r)
        assert (a["flops"], a["bytes_accessed"], a["collectives"],
                a["aten_ops"]) == (b["flops"], b["bytes_accessed"],
                                   b["collectives"], b["aten_ops"]), r
