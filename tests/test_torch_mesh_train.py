"""Training on a mesh (``repro_torch.distributed.shard_train``, the
trainer's ``build``) on logical CPU devices, against the single-device
step.

* A mesh whose data degree is 1 ((1, 2)) splits each attention, FFN,
  Mamba and vocabulary sublayer over its two model ranks
  (``distributed/tensor_parallel.py``), whose row-parallel sums change
  the order of additions as GSPMD's do in the reference: its step
  holds the port's single-device ``api.train_step`` within the bars
  below (metrics, the gathered grads, params), every architecture of
  ``test_torch_train.TRAINED``, and its loss and gradients equal
  bitwise the same split run directly on one device
  (``tensor_parallel.local_split``); so do those of (2, 2) and (4, 2)
  steps, the data ranks' sums taken in the same order.
* A (4, 2) step, and an (8, 1) step with ``fsdp=True``, against the
  reference's jitted single-device step within ``test_torch_train``'s
  bars (metrics ``METRIC_TOL``; the gathered grads ``GRAD_RTOL`` and
  ``GRAD_ATOL_RMS``; params ``PARAM_TOL`` where the reference's
  gradient is settled, ``2 * lr`` everywhere): chatglm3-6b smoke (the
  reference's own sharded-step config, whose ``embed`` is split over
  "model"), llama3.2-1b smoke at the reference's FSDP test widths (also
  with a vocabulary of 8192, where ``embed`` reaches the 1 MiB FSDP
  floor and splits its rows over "data"), and the MoE configs dbrx and grok,
  whose ranks run the whole batch's capacity groups cut to their rows.
  The reference's own mesh step cannot be the bar: it raises at
  ``repro/models/blocks.py:91`` (``jnp.take`` of a model-sharded
  embedding).
* A batch that does not divide dp, and MoE groups that do not divide
  it, run whole, once: on (8, 1) with ``fsdp=True`` (a model degree of
  1) bitwise the single-device step, on (4, 2) within the bars.
* The trainer's CLI (``--device cpu``, a (1, 1) mesh) gives the losses
  of the single-device loop it ran before the mesh.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.models.frontends import make_inputs as j_make_inputs
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import make_pipeline
from repro_torch.distributed import shard_train, tensor_parallel
from repro_torch.distributed.sharding import (P, ShardedTensor,
                                              ShardingPolicy, device_put,
                                              params_pspecs, state_pspecs,
                                              to_shardings)
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api as t_api
from repro_torch.models import transformer as t_tr
from repro_torch.models.frontends import make_inputs
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from test_torch_train import (GRAD_RTOL, METRIC_TOL, PARAM_TOL, TOPT,
                              TRAINED, _both, _grad_atol, _np, _port_grads,
                              _reference_step)

MESH_SHAPE = JShape("mesh_train", 32, 8, "train")
# (TRAINED name, replace, (data, model), fsdp)
FSDP_WIDTHS = dict(d_model=128, d_ff=512, head_dim=16, fsdp=True)
REFERENCE_CASES = {
    "chatglm_4x2": ("chatglm", {}, (4, 2), False),
    "llama_fsdp_8x1": ("llama", FSDP_WIDTHS, (8, 1), True),
    "llama_fsdp_v8192_8x1": ("llama", dict(FSDP_WIDTHS, vocab_size=8192),
                             (8, 1), True),
    "dbrx_4x2": ("dbrx", {}, (4, 2), False),
    "grok_4x2": ("grok", {}, (4, 2), False),
}


def _mesh(data, model):
    return make_host_mesh(data, model, devices=["cpu"] * (data * model))


def _place(tc, mesh, state, fsdp=False):
    spec = state_pspecs(tc, mesh, state, ShardingPolicy(fsdp=fsdp))
    return device_put(state, to_shardings(mesh, spec))


def _whole(tree):
    return [x.full("cpu") if isinstance(x, ShardedTensor) else x
            for x in tree_leaves(tree)]


def _port_batch(tc, batch, seq):
    return make_inputs(tc, ShapeConfig("t", seq, batch, "train"),
                       abstract=False, device="cpu")


def _split_run(tc, params, batch, tp, dp=1):
    """Loss and model-block gradients of the split step of a (dp, tp)
    mesh run directly on one device: each data rank's rows through
    ``local_split``'s tree and ``api.loss_fn``, the gradients taken to
    their blocks in data-rank order and divided by dp, the losses'
    mean."""
    mesh = _mesh(dp, tp)
    placed = device_put(params, to_shardings(
        mesh, params_pspecs(tc, mesh, params)))
    plans = tensor_parallel.plan_leaves(tc, mesh, placed)
    tree, leaves = tensor_parallel.local_split(tc, params, tp, "cpu")
    flat = [(i, m, x) for i, per in enumerate(leaves)
            for m, x in enumerate(per) if x is not None]
    for _, _, x in flat:
        x.requires_grad_(True)
    acc, total = [], None
    for r in range(dp):
        n = batch["labels"].shape[0] // dp
        rows = {k: v.narrow(0, r * n, n) for k, v in batch.items()}
        loss, _ = t_api.loss_fn(tc, tree, rows)
        got = torch.autograd.grad(loss, [x for _, _, x in flat],
                                  allow_unused=True)
        grads = [[None] * tp for _ in leaves]
        for (i, m, _), g in zip(flat, got):
            grads[i][m] = g
        tensor_parallel.block_grads(plans, mesh, r, grads, acc,
                                    [x.dtype for x in tree_leaves(params)])
        total = loss.detach() if total is None else total + loss.detach()
    for _, _, x in flat:
        x.requires_grad_(False)
    if dp > 1:
        total = total / dp
        acc = [[g / dp for g in blocks] for blocks in acc]
    return total, acc


@pytest.mark.parametrize("name", list(TRAINED))
def test_data_degree_one_is_bitwise_the_single_device_step(name):
    """(1, 2): within the bars of the port's single-device step (the
    model ranks' row-parallel sums reorder additions), and bitwise the
    same split run on one device."""
    _, tc = _both(name, logit_dtype="float32")
    state = t_api.init_train_state(tc, TOPT, 0, device="cpu")
    batch = _port_batch(tc, 4, 16)
    mesh = _mesh(1, 2)
    placed = _place(tc, mesh, state)
    loss, _, grads = shard_train.loss_and_grads(tc, mesh, placed.params,
                                                batch)
    want_loss, want_grads = _split_run(tc, state.params, batch, 2)
    assert torch.equal(loss, want_loss)
    for got, want in zip(grads, want_grads):
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    whole = shard_train.whole_grads(placed.params, grads)
    new, metrics = shard_train.train_step(tc, TOPT, placed, batch)
    single_grads = _port_grads(tc, state, batch)
    want, want_m = t_api.train_step(tc, TOPT, state, batch)
    assert set(metrics) == set(want_m)
    for k, v in want_m.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), err_msg=k,
                                   **METRIC_TOL)
    lr = float(want_m["lr"])
    for i, (tg, wg, got, w) in enumerate(zip(
            whole, single_grads, _whole(new.params),
            tree_leaves(want.params))):
        wg = wg.numpy()
        atol = _grad_atol(wg)
        np.testing.assert_allclose(tg.numpy(), wg, rtol=GRAD_RTOL,
                                   atol=atol, err_msg=f"grad {i}")
        settled = np.abs(wg) > atol + GRAD_RTOL * np.abs(wg)
        got, w = got.float().numpy(), w.float().numpy()
        np.testing.assert_allclose(got[settled], w[settled],
                                   err_msg=f"param {i}", **PARAM_TOL)
        assert got.dtype == w.dtype and \
            np.abs(got - w).max(initial=0) <= 2 * lr, i


@pytest.mark.parametrize("name,shape", [("llama", (2, 2)),
                                        ("llama", (4, 2)),
                                        ("chatglm", (4, 2)),
                                        ("jamba_no_moe", (2, 2))])
def test_mesh_step_is_bitwise_the_split_run_on_one_device(name, shape):
    """A (dp, tp) step's loss and every model block's gradient equal the
    same split run directly on one device, the data ranks' sums in the
    same order (``_split_run``)."""
    _, tc = _both(name, logit_dtype="float32")
    state = t_api.init_train_state(tc, TOPT, 0, device="cpu")
    batch = _port_batch(tc, 8, 16)
    mesh = _mesh(*shape)
    loss, _, grads = shard_train.loss_and_grads(
        tc, mesh, _place(tc, mesh, state).params, batch)
    assert shard_train.row_split(tc, mesh, batch) == (shape[0], None)
    want_loss, want_grads = _split_run(tc, state.params, batch, shape[1],
                                       shape[0])
    assert torch.equal(loss, want_loss)
    for got, want in zip(grads, want_grads):
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.fixture(scope="module")
def reference_steps():
    """name -> the reference's jitted single-device step at MESH_SHAPE,
    computed once a case."""
    cache = {}

    def get(case):
        if case not in cache:
            name, replace, _, _ = REFERENCE_CASES[case]
            jc, _ = _both(name, logit_dtype="float32", **replace)
            batch = _np(j_make_inputs(jc, MESH_SHAPE, abstract=False))
            cache[case] = (batch, _reference_step(jc, batch))
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_mesh_step_matches_the_references_single_device_step(
        case, reference_steps, monkeypatch):
    name, replace, (data, model), fsdp = REFERENCE_CASES[case]
    _, tc = _both(name, logit_dtype="float32", **replace)
    batch, (state0, want, jm, jg) = reference_steps(case)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    mesh = _mesh(data, model)
    placed = _place(tc, mesh, t_tr.train_state_from_numpy(state0, "cpu"),
                    fsdp)
    if name == "chatglm":
        assert placed.params["embed"].sharding.spec == P("model", None)
    if "v8192" in case:   # "model" has size 1; FSDP takes the widest dim left
        assert placed.params["embed"].sharding.spec == P("model", "data")
        assert len(placed.params["embed"].blocks()) == 8
    groups = []
    if tc.moe is not None:
        moe = t_tr.apply_moe

        def spy(cfg, p, x, *, num_groups=1):
            groups.append((x.shape[0] * x.shape[1], num_groups))
            return moe(cfg, p, x, num_groups=num_groups)
        monkeypatch.setattr(t_tr, "apply_moe", spy)
    loss, parts, grads = shard_train.loss_and_grads(tc, mesh, placed.params,
                                                    tbatch)
    new, opt_m = shard_train.apply_updates(TOPT, placed, grads)
    tm = dict(parts, loss=loss, **opt_m)
    assert set(tm) == set(jm)
    for k in jm:
        assert tm[k].dtype == torch.float32 and tm[k].dim() == 0, k
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    if tc.moe is not None:
        # 256 tokens: 16 groups over the whole batch, 4 a rank of 64 tokens
        assert groups and set(groups) == {(64, 4)}, groups
    lr = float(jm["lr"])
    grads = shard_train.whole_grads(placed.params, grads)
    for (path, wg), tg, wp, tp in zip(
            jax.tree_util.tree_flatten_with_path(jg)[0], grads,
            jax.tree.leaves(want.params), _whole(new.params)):
        where = jax.tree_util.keystr(path)
        wg = np.asarray(wg, np.float32)
        atol = _grad_atol(wg)
        np.testing.assert_allclose(tg.numpy(), wg, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"grad {where}")
        settled = np.abs(wg) > atol + GRAD_RTOL * np.abs(wg)
        tp, wp = tp.float().numpy(), np.asarray(wp, np.float32)
        np.testing.assert_allclose(tp[settled], wp[settled],
                                   err_msg=f"param {where}", **PARAM_TOL)
        assert np.abs(tp - wp).max(initial=0) <= 2 * lr, where
    assert int(new.opt.step.full()) == int(want.opt.step) == 1


def _count_loss_fns(monkeypatch):
    calls = []
    loss_fn = t_api.loss_fn

    def counted(cfg, params, batch, **kw):
        calls.append(kw)
        return loss_fn(cfg, params, batch, **kw)
    monkeypatch.setattr(t_api, "loss_fn", counted)
    return calls


@pytest.mark.parametrize("name,batch,seq,shape", [
    ("llama", 6, 16, (4, 2)),        # 6 rows do not split over 4 data ranks
    ("dbrx", 4, 6, (4, 2)),          # 24 tokens: one MoE group, not 4
    ("grok", 8, 2, (4, 2)),          # 16 tokens: 16 groups of 1, 4 a rank
    ("llama", 6, 16, (8, 1)),        # the same rows, a model degree of 1
    ("dbrx", 4, 6, (8, 1)),
])
def test_rows_or_groups_that_do_not_divide_run_whole(name, batch, seq,
                                                     shape, monkeypatch):
    _, tc = _both(name, logit_dtype="float32")
    state = t_api.init_train_state(tc, TOPT, 1, device="cpu")
    tbatch = _port_batch(tc, batch, seq)
    mesh = _mesh(*shape)
    dp, tp = shape
    placed = _place(tc, mesh, state, fsdp=tp == 1)
    calls = _count_loss_fns(monkeypatch)
    new, metrics = shard_train.train_step(tc, TOPT, placed, tbatch)
    split = (batch % dp == 0 and (tc.moe is None or
                                  t_tr.moe_num_groups(batch * seq) % dp == 0))
    assert shard_train.row_split(tc, mesh, tbatch)[0] == (dp if split
                                                          else 1)
    assert len(calls) == (dp if split else 1)
    monkeypatch.undo()
    if split or tp > 1:     # before the single step updates ``state``
        _, _, grads = shard_train.loss_and_grads(
            tc, mesh, _place(tc, mesh, state, fsdp=tp == 1).params, tbatch)
        grads = shard_train.whole_grads(placed.params, grads)
        single_grads = _port_grads(tc, state, tbatch)
    want, want_m = t_api.train_step(tc, TOPT, state, tbatch)
    if split:
        assert calls == [{"moe_groups": 4}] * 4
    if split or tp > 1:
        # the bars of test_mesh_step_matches_the_references_single_device_step
        for k, v in want_m.items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       err_msg=k, **METRIC_TOL)
        lr = float(want_m["lr"])
        for i, (tg, wg, got, w) in enumerate(zip(
                grads, single_grads, _whole(new.params),
                tree_leaves(want.params))):
            wg = wg.numpy()
            atol = _grad_atol(wg)
            np.testing.assert_allclose(tg.numpy(), wg, rtol=GRAD_RTOL,
                                       atol=atol, err_msg=f"grad {i}")
            settled = np.abs(wg) > atol + GRAD_RTOL * np.abs(wg)
            got, w = got.float().numpy(), w.float().numpy()
            np.testing.assert_allclose(got[settled], w[settled],
                                       err_msg=f"param {i}", **PARAM_TOL)
            assert np.abs(got - w).max(initial=0) <= 2 * lr, i
        return
    for k, v in want_m.items():
        assert torch.equal(metrics[k], v), k
    for got, w in zip(_whole(new), tree_leaves(want)):
        assert torch.equal(got, w)


def test_the_step_updates_the_blocks_in_place_and_keeps_them_sharded():
    _, tc = _both("chatglm", logit_dtype="float32")
    mesh = _mesh(4, 2)
    placed = _place(tc, mesh, t_api.init_train_state(tc, TOPT, 0,
                                                      device="cpu"))
    ptrs = [[b.data_ptr() for b in x.shards] for x in tree_leaves(placed)]
    before = _whole(placed.params)
    new, _ = shard_train.train_step(tc, TOPT, placed,
                                    _port_batch(tc, 8, 16))
    assert [[b.data_ptr() for b in x.shards]
            for x in tree_leaves(new)] == ptrs
    assert all(isinstance(x, ShardedTensor) for x in tree_leaves(new))
    assert any(not torch.equal(a, b)
               for a, b in zip(before, _whole(new.params)))
    assert not any(b.requires_grad for x in tree_leaves(new)
                   for b in x.shards)
    # a model-split leaf holds two storages, each shared by the 4 data ranks
    emb = new.params["embed"]
    assert emb.sharding.spec == P("model", None) and len(emb.blocks()) == 2
    with pytest.raises(ValueError, match="ShardedTensor"):
        shard_train.train_step(tc, TOPT, t_api.init_train_state(
            tc, TOPT, 0, device="cpu"), _port_batch(tc, 8, 16))


def test_build_gives_the_state_and_step_of_the_reference_trainer():
    cfg = get_config("olmo-1b", smoke=True)
    opt = AdamWConfig(warmup_steps=2, total_steps=4)
    mesh = _mesh(2, 2)
    make_state, step_fn, sshard = t_train.build(
        cfg, opt, mesh, ShardingPolicy(fsdp=cfg.fsdp))
    state = make_state(3)
    whole = t_api.init_train_state(cfg, opt, 3, device="cpu")
    for got, w, shd in zip(tree_leaves(state), tree_leaves(whole),
                           tree_leaves(sshard)):
        assert got.sharding is shd and torch.equal(got.full(), w)
    batch = make_pipeline(cfg.vocab_size, 16, 4, seed=0)[0]
    state, metrics = step_fn(state, batch)
    assert torch.isfinite(metrics["loss"])
    assert int(state.opt.step.full()) == 1


@pytest.mark.parametrize("arch", ["llama3.2-1b", "jamba-1.5-large-398b"])
def test_the_trainer_cli_gives_the_single_device_losses(arch, tmp_path):
    """``--device cpu`` trains on a (1, 1) mesh: the losses of the
    single-device loop the trainer ran before, exactly."""
    steps, batch, seq = 4, 4, 16
    got = t_train.train(["--arch", arch, "--smoke", "--steps", str(steps),
                         "--batch", str(batch), "--seq", str(seq),
                         "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    cfg = get_config(arch, smoke=True)
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=steps,
                      moment_dtype=cfg.moment_dtype)
    state = t_api.init_train_state(cfg, opt, 0, device="cpu")
    data = make_pipeline(cfg.vocab_size, seq, batch, seed=0)
    want = []
    for step in range(steps):
        state, metrics = t_api.train_step(cfg, opt, state, data[step])
        want.append(float(metrics["loss"]))
    assert got == want


def test_fsdp_splits_only_leaves_past_the_1_mib_floor():
    """The FSDP widths of the reference's test leave every leaf below the
    1 MiB floor, so nothing splits over "data"; with an 8192-row
    vocabulary ``embed`` reaches it."""
    def data_split(tc):
        spec = state_pspecs(tc, _mesh(8, 1),
                            t_api.init_train_state_abstract(tc, TOPT),
                            ShardingPolicy(fsdp=True))
        return [s for s in tree_leaves(spec) if "data" in tuple(s)]

    _, tc = _both("llama", **FSDP_WIDTHS)
    assert data_split(tc) == []
    tc = dataclasses.replace(tc, vocab_size=8192)
    assert data_split(tc) == [P("model", "data")] * 3  # embed, mu, nu
