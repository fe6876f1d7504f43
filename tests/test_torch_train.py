"""Training on one device (``repro_torch.models.api``: ``loss_fn``,
``init_train_state``, ``train_step``; ``transformer`` / ``encdec``
``loss_fn`` and remat; ``blocks.softmax_xent``) against the reference
(``repro``), every architecture's smoke config.

The reference's ``TrainState`` (drawn by ``jax.random``) is carried
across with ``transformer.train_state_from_numpy``, the batch is the
reference's ``make_inputs`` (as ``test_models_smoke``), and one step of
the port's ``train_step`` runs on the CPU against the reference's
jitted step (``OPT = AdamWConfig(warmup_steps=2, total_steps=10)``);
the port's Mamba layers run the selective scan's plain forward and
backward through ``SelectiveScan``.  The step runs with f32 logits, as
``test_torch_lm``'s tight checks do (the configs materialize logits in
bf16, where one f32 rounding difference moves a logit by a bf16 step;
the configs' own bf16 losses are held separately).  Bars:

* metrics (``loss``, ``xent``, ``aux``, ``grad_norm``, ``lr``) within
  ``rtol=1e-4, atol=1e-5`` (the same f32 arithmetic, sums in another
  order);
* grads leaf by leaf within ``rtol=1e-4`` and an ``atol`` of 1e-4 of the
  leaf's RMS (``GRAD_ATOL_RMS``): a leaf's grads are of order 1e-5 to
  1e-1 at these widths, where a fixed 1e-5 would pass tiny leaves
  without looking at them;
* params within ``rtol=1e-4, atol=1e-5`` where the reference's |g|
  exceeds that gradient tolerance (the update's sign is settled), and
  within ``2 * lr`` everywhere (Adam's first step is ``g / |g|``: an
  element whose gradient sits at noise level may flip, by ``2 * lr`` at
  most).

RWKV-6's smoke config is the exception: its per-head group norm divides
by ``sqrt(var + 1e-5)`` of nearly constant heads, and f32 rounding moves
its grads by several percent of their RMS in either package (both are
up to 7 % of a leaf's RMS off the f64 gradient at these inputs).  So
the reference's gradient is also taken in f64 throughout (x64 on, every
config dtype and every cast to f32 by name widened, ``_wide_grads``),
and the port's f64 gradient is held against it within ``F64_GRAD_TOL``
of each leaf's RMS.  The port's f32 grads and grad_norm are then held
against the reference's f64 values: each leaf's f32 error within
``RWKV_ERR_FACTOR`` of the reference's own f32 error (as
``BF16_ERR_FACTOR`` in ``test_torch_lm``), or within 1e-4 of the leaf's
RMS.

Remat ``block`` and ``block_dots`` give the step of ``none`` bitwise,
and the abstract state's shapes and dtypes equal the reference's
``eval_shape`` for the full-size configs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs.base import ShapeConfig
from repro.models import api as j_api
from repro.models import blocks as j_blocks
from repro.models import rwkv as j_rwkv
from repro.models import transformer as j_tr
from repro.models.frontends import make_inputs
from repro.optim.adamw import AdamWConfig as JAdamW
from repro_torch import configs as t_configs
from repro_torch.models import api as t_api
from repro_torch.models import blocks as t_blocks
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models import transformer as t_tr
from repro_torch.optim.adamw import AdamWConfig, tree_leaves

OPT = JAdamW(warmup_steps=2, total_steps=10)
TOPT = AdamWConfig(warmup_steps=2, total_steps=10)
TRAIN_SHAPE = ShapeConfig("smoke_train", 32, 2, "train")
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-4
GRAD_ATOL_RMS = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
# rwkv: each leaf's max abs error against the reference's f64 gradient,
# the port's f32 over the reference's f32 (1.41 at most at these inputs)
RWKV_ERR_FACTOR = 1.5
# the port's f64 gradient against the reference's, in units of each
# leaf's RMS (1.1e-10 at most at these inputs)
F64_GRAD_TOL = 1e-8
# every architecture's smoke config; jamba also without MoE and grok
# under the scatter dispatch
TRAINED = {"llama": ("llama3.2-1b", {}),
           "olmo": ("olmo-1b", {}),
           "starcoder2": ("starcoder2-15b", {}),
           "chatglm": ("chatglm3-6b", {}),
           "dbrx": ("dbrx-132b", {}),
           "grok": ("grok-1-314b", {}),
           "grok_scatter": ("grok-1-314b", dict(moe_dispatch="scatter")),
           "jamba": ("jamba-1.5-large-398b", {}),
           "jamba_no_moe": ("jamba-1.5-large-398b", dict(moe=None)),
           "rwkv": ("rwkv6-3b", {}),
           "llava": ("llava-next-34b", {}),
           "seamless": ("seamless-m4t-large-v2", {})}


def _both(name, **more):
    arch, replace = TRAINED[name]
    replace = dict(replace, **more)
    return (dataclasses.replace(j_configs.get_config(arch, smoke=True),
                                **replace),
            dataclasses.replace(t_configs.get_config(arch, smoke=True),
                                **replace))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(jc):
    batch = _np(make_inputs(jc, TRAIN_SHAPE, abstract=False))
    return batch, {k: torch.from_numpy(np.array(v)) for k, v in
                   batch.items()}


def _reference_step(jc, batch):
    """The reference's initial state, its jitted step and its grads."""
    state = j_api.init_train_state(jc, OPT, jax.random.PRNGKey(0))

    def step(s, b):
        grads = jax.grad(lambda p: j_api.loss_fn(jc, p, b)[0])(s.params)
        return j_api.train_step(jc, OPT, s, b), grads
    (new, metrics), grads = jax.jit(step)(state, batch)
    return _np(state), _np(new), _np(metrics), _np(grads)


def _port_grads(tc, state, batch):
    leaves = tree_leaves(state.params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = t_api.loss_fn(tc, state.params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def _grad_atol(g):
    return GRAD_ATOL_RMS * float(np.sqrt(np.mean(
        np.square(g.astype(np.float64)))))


class _Wide:
    """A module whose ``float32`` is ``float64``, all else delegated."""

    def __init__(self, mod, wide):
        self._mod, self.float32 = mod, wide

    def __getattr__(self, name):
        return getattr(self._mod, name)


def _wide_grads(jc, tc, state0, batch, tbatch):
    """The reference's gradient and the port's, each in f64 throughout:
    params and every config dtype in f64, x64 on, and the casts to f32
    by name (norms, the RWKV recurrence, the loss) widened in both
    packages' model modules.  Two lists of numpy arrays in leaf order."""
    wide = {f"{k}_dtype": "float64" for k in (
        "param", "compute", "logit", "attn_score")}
    p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), state0.params)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for m in (j_blocks, j_rwkv, j_tr):
            mp.setattr(m, "jnp", _Wide(jnp, jnp.float64))
        for m in (t_blocks, t_rwkv, t_tr):
            mp.setattr(m, "torch", _Wide(torch, torch.float64))
        jcw = dataclasses.replace(jc, **wide)
        ref = jax.jit(jax.grad(
            lambda p: j_api.loss_fn(jcw, p, batch)[0]))(p64)
        params = jax.tree.map(torch.from_numpy, p64)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = t_api.loss_fn(dataclasses.replace(tc, **wide), params,
                                tbatch)
        port = torch.autograd.grad(loss, leaves)
    return ([np.asarray(g) for g in jax.tree.leaves(ref)],
            [g.numpy() for g in port])


@pytest.mark.parametrize("name", list(TRAINED))
def test_train_step_matches_reference(name):
    jc, tc = _both(name, logit_dtype="float32")
    batch, tbatch = _batch(jc)
    state0, want, jm, jg = _reference_step(jc, batch)
    grads = _port_grads(tc, t_tr.train_state_from_numpy(state0, "cpu"),
                        tbatch)
    state = t_tr.train_state_from_numpy(state0, "cpu")
    new, tm = t_api.train_step(tc, TOPT, state, tbatch)
    assert set(tm) == set(jm)
    g64 = None
    if name == "rwkv":
        g64, port64 = _wide_grads(jc, tc, state0, batch, tbatch)
        for e, p in zip(g64, port64):
            tol = F64_GRAD_TOL * float(np.sqrt(np.mean(np.square(e))))
            np.testing.assert_allclose(p, e, rtol=F64_GRAD_TOL, atol=tol)
    for k in jm:
        assert tm[k].dtype == torch.float32 and tm[k].dim() == 0, k
        if k == "grad_norm" and g64 is not None:
            exact = float(np.sqrt(sum(np.sum(g * g) for g in g64)))
            assert abs(float(tm[k]) - exact) <= RWKV_ERR_FACTOR * abs(
                float(jm[k]) - exact), (float(tm[k]), float(jm[k]), exact)
            continue
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   err_msg=k, **METRIC_TOL)
    lr = float(jm["lr"])
    for i, ((path, wg), tg, wp, tp) in enumerate(zip(
            jax.tree_util.tree_flatten_with_path(jg)[0], grads,
            jax.tree.leaves(want.params), tree_leaves(new.params))):
        where = jax.tree_util.keystr(path)
        wg = np.asarray(wg, np.float32)
        atol = _grad_atol(wg)
        if g64 is None:
            np.testing.assert_allclose(tg.numpy(), wg, rtol=GRAD_RTOL,
                                       atol=atol, err_msg=f"grad {where}")
        else:
            exact = g64[i]
            got = np.abs(tg.numpy() - exact).max()
            ref = np.abs(wg - exact).max()
            assert got <= max(RWKV_ERR_FACTOR * ref, _grad_atol(exact)), \
                (where, got, ref)
            atol = np.abs(tg.numpy() - wg).max()
        settled = np.abs(wg) > atol + GRAD_RTOL * np.abs(wg)
        tp, wp = tp.float().numpy(), np.asarray(wp, np.float32)
        np.testing.assert_allclose(tp[settled], wp[settled],
                                   err_msg=f"param {where}", **PARAM_TOL)
        assert np.abs(tp - wp).max(initial=0) <= 2 * lr, where
    assert int(new.opt.step) == int(want.opt.step) == 1
    for w, t in zip(jax.tree.leaves((want.opt.mu, want.opt.nu)),
                    tree_leaves((new.opt.mu, new.opt.nu))):
        assert t.dtype == getattr(torch, str(w.dtype))


@pytest.mark.parametrize("name", list(TRAINED))
def test_bf16_logit_loss_matches_reference(name):
    """The configs as they are (bf16 logits): the loss and its parts."""
    jc, tc = _both(name)
    batch, tbatch = _batch(jc)
    state = j_api.init_train_state(jc, OPT, jax.random.PRNGKey(0))
    jl, jparts = jax.jit(lambda p, b: j_api.loss_fn(jc, p, b))(
        state.params, batch)
    tl, tparts = t_api.loss_fn(
        tc, t_tr.params_from_numpy(_np(state.params), "cpu"), tbatch)
    np.testing.assert_allclose(float(tl), float(jl), **METRIC_TOL)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   err_msg=k, **METRIC_TOL)


@pytest.mark.parametrize("name", list(TRAINED))
def test_remat_modes_give_the_same_step(name):
    """``block`` (checkpoint) and ``block_dots`` (selective checkpoint)
    recompute what ``none`` keeps: the same loss, grads and step."""
    out = {}
    for remat in ("none", "block", "block_dots"):
        jc, tc = _both(name, remat=remat)
        batch, tbatch = _batch(jc)
        state = t_api.init_train_state(tc, TOPT, 0, device="cpu")
        new, metrics = t_api.train_step(tc, TOPT, state, tbatch)
        out[remat] = (metrics, tree_leaves((new.params, new.opt.mu,
                                            new.opt.nu)))
    for remat in ("block", "block_dots"):
        for k, v in out["none"][0].items():
            assert torch.equal(out[remat][0][k], v), (remat, k)
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b), remat


@pytest.mark.parametrize("arch", j_configs.ARCH_NAMES)
def test_abstract_state_matches_the_references_eval_shape(arch):
    jc, tc = j_configs.get_config(arch), t_configs.get_config(arch)
    want = j_api.init_train_state_abstract(jc, OPT)
    got = t_api.init_train_state_abstract(tc, TOPT)
    want_leaves, got_leaves = jax.tree.leaves(want), tree_leaves(got)
    assert len(want_leaves) == len(got_leaves)
    for w, g in zip(want_leaves, got_leaves):
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == getattr(torch, str(w.dtype))
    assert all(t.device.type == "meta" for t in got_leaves[:-1])
    assert got.opt.step.dtype == torch.int32 and got.opt.step.dim() == 0


def test_loss_is_xent_plus_a_hundredth_of_aux():
    _, tc = _both("jamba")
    jc = _both("jamba")[0]
    tbatch = _batch(jc)[1]
    params = t_api.init_params(tc, 1, device="cpu")
    loss, parts = t_api.loss_fn(tc, params, tbatch)
    assert set(parts) == {"xent", "aux"} and float(parts["aux"]) > 0
    np.testing.assert_allclose(
        float(loss), float(parts["xent"]) + 0.01 * float(parts["aux"]),
        rtol=1e-6)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4, 1e-2])
def test_softmax_xent_matches_the_reference(z_loss):
    from repro.models.blocks import softmax_xent as j_xent
    from repro_torch.models.blocks import softmax_xent
    rng = np.random.default_rng(0)
    logits = (4 * rng.normal(size=(3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    for dt in (np.float32, "bfloat16"):
        jl = jax.numpy.asarray(logits, dt)
        tl = torch.from_numpy(np.array(jl, np.float32)).to(
            torch.float32 if dt is np.float32 else torch.bfloat16)
        want = float(j_xent(jl, jax.numpy.asarray(labels), z_loss=z_loss))
        got = float(softmax_xent(tl, torch.from_numpy(labels),
                                 z_loss=z_loss))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_train_state_carries_the_reference_state():
    jc, tc = _both("jamba")
    state = _np(j_api.init_train_state(jc, OPT, jax.random.PRNGKey(2)))
    got = t_tr.train_state_from_numpy(state, "cpu")
    assert isinstance(got, t_api.TrainState)
    for w, g in zip(jax.tree.leaves(state), tree_leaves(got)):
        assert g.dtype == getattr(torch, str(w.dtype))
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    assert got.opt.step.device.type == "cpu"


def test_train_step_updates_the_state_in_place():
    _, tc = _both("llama")
    state = t_api.init_train_state(tc, TOPT, 0, device="cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(state)]
    before = [t.clone() for t in tree_leaves(state.params)]
    batch = _batch(_both("llama")[0])[1]
    new, _ = t_api.train_step(tc, TOPT, state, batch)
    assert [t.data_ptr() for t in tree_leaves(new)] == ptrs
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(state.params)))
    assert not any(t.requires_grad for t in tree_leaves(new))
