"""Mixed-precision (precision-ladder) plans of the port — the CNN block,
the frontend and the two-tenant server — against the reference, on the
CPU.  Inputs are made with numpy from a seed; weights cross over with
``params_from_numpy``.

Outputs follow the code-flip rule: float sums run in another order in
the two packages, so a value within an ulp of a rounding tie may
quantize to the neighbouring code (a requantized grid has exact ties:
codes of one grid divided by the step of another).  At most 0.1% of the
elements, and never fewer than two, may differ by more than
``rtol=1e-4, atol=1e-5``, and each such element by at most one step of
the grids that feed it; the floor of two keeps the rule meaningful on
tensors of a few hundred elements.  Site widths and members, the
``quant_report`` keys and the est-cycle serving accounting are equal;
measured quantization errors agree within ``rtol=1e-3`` (``atol=1e-6``
for the full-precision sites, whose errors are float rounding noise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import clear_plan_cache as j_clear
from repro.core.plan import plan_network as j_plan_network
from repro.core.resources import ResourceBudget as JBudget
from repro.kernels.conv2d.ref import conv2d_ref as j_conv_ref
from repro.kernels.pool2d.ref import pool2d_ref as j_pool_ref
from repro.models.blocks import apply_cnn_block as j_block
from repro.models.frontends import apply_cnn_frontend as j_apply
from repro.models.frontends import cnn_frontend_site_specs as j_specs
from repro.models.frontends import init_cnn_frontend as j_init
from repro.runtime import AdaptiveServer as JServer
from repro_torch.core.plan import clear_plan_cache as t_clear
from repro_torch.core.plan import plan_network as t_plan_network
from repro_torch.core.resources import ResourceBudget as TBudget
from repro_torch.kernels.activation.lut_poly import RANGES, TABLE_SIZE
from repro_torch.models.blocks import apply_cnn_block as t_block
from repro_torch.models.frontends import apply_cnn_frontend as t_apply
from repro_torch.models.frontends import cnn_frontend_site_specs as t_specs
from repro_torch.models.frontends import params_from_numpy
from repro_torch.runtime.server import AdaptiveServer as TServer

REL_ERR = dict(rtol=1e-3, atol=1e-6)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a, copy=True))


def _tree(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def assert_code_flip(got, want, step, frac=1e-3):
    """The code-flip rule (module docstring): ``step`` bounds one step
    of the grids that feed an element."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    bad = diff > 1e-5 + 1e-4 * np.abs(want)
    assert bad.sum() <= max(frac * bad.size, 2), \
        f"{bad.sum()} of {bad.size} elements"
    assert np.all(diff[bad] <= step + 1e-5), float(diff.max())


def block_step(x, w, kind, pool_mode):
    """One step of the coarsest grid of a lowered block, in its output:
    a flipped int8 code of the input (times the largest weight), of the
    conv output or of the pooled value (activations are 1-Lipschitz),
    plus one LUT table step for the saturating kinds."""
    conv = np.asarray(j_conv_ref(jnp.asarray(x), jnp.asarray(w)))
    pool = np.asarray(j_pool_ref(jnp.asarray(conv), mode=pool_mode))
    step = (np.abs(x).max() * np.abs(w).max() * w.shape[0] * w.shape[1]
            + np.abs(conv).max() + np.abs(pool).max()) / 127
    if kind in RANGES:
        step += 2 * RANGES[kind] / (TABLE_SIZE - 1)
    return float(step)


def frontend_step(jp, images, kind):
    """``block_step`` of the frontend's last block on ``images`` (its
    input from the reference's f32 blocks), carried through the
    projection: each output sums at most one flipped feature per
    channel, weighted by that channel's projection row."""
    x = jnp.asarray(images)
    for bp in jp["blocks"][:-1]:
        x = j_block(bp, x, activation=kind)
    w = np.asarray(jp["blocks"][-1]["w"])
    proj = np.abs(np.asarray(jp["proj"])).sum(axis=0).max()
    return block_step(np.asarray(x), w, kind, "max") * float(proj)


def _reports_agree(trep, jrep, got, want):
    """Equal sites and widths; errors within ``REL_ERR``, widened by how
    far the two outputs lie apart: a flipped code moves a site's error
    by at most ||got - want|| / ||want|| (triangle inequality)."""
    assert sorted(trep) == sorted(jrep)
    apart = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    for site, r in jrep.items():
        assert trep[site].precision_bits == r.precision_bits, site
        np.testing.assert_allclose(trep[site].rel_error, r.rel_error,
                                   rtol=REL_ERR["rtol"],
                                   atol=REL_ERR["atol"] + apart)


# --------------------------------------------------------------------------
# (d) apply_cnn_block: each lowered branch
# --------------------------------------------------------------------------
# name: (activation, pool mode, fuse, vmem KiB, vpu ops, expected plan)
BRANCHES = {
    # int8 conv -> requantized int8 pool -> dequantize -> tanh at 8 bits
    "int8_requant_pool": ("tanh", "max", False, 16, None,
                          [("ip1_vpu", 8), ("pool_vpu", 8),
                           ("act_vpu", 8)]),
    # ... and relu on the int8 codes: one dequantize at the egress
    "relu_on_codes": ("relu", "max", False, 16, None,
                      [("ip1_vpu", 8), ("pool_vpu", 8), ("act_vpu", 8)]),
    # avg pools int8 codes into int32 codes; relu runs on those
    "relu_on_avg_codes": ("relu", "avg", False, 22, None,
                          [("ip1_vpu", 8), ("pool_vpu", 8),
                           ("act_vpu", 8)]),
    # int8 conv, 16-bit pool: the widths disagree, dequantize between
    "widths_disagree": ("relu", "max", False, 26, 40_000,
                        [("ip2_mxu", 8), ("pool_vpu", 16),
                         ("act_vpu", 8)]),
    # the same boundary ahead of the LUT activation
    "widths_disagree_lut": ("tanh", "max", False, 26, 40_000,
                            [("ip2_mxu", 8), ("pool_vpu", 16),
                             ("act_lut", 8)]),
    # Pool2 on int8 codes of an f32 conv (avg: int32 floor average)
    "im2col_avg_codes": ("relu", "avg", False, 64, 20_000,
                         [("ip2_mxu", 32), ("pool_im2col", 8),
                          ("act_vpu", 8)]),
    # the lowered fused site: fake-quant into the f32 kernel ...
    "fused_at_16": ("relu", "max", True, 14, None, [("fused_vpu", 16)]),
    # ... and the int8 rung with its in-register rescale
    "fused_at_8": ("tanh", "max", True, 12, None, [("fused_vpu", 8)]),
    "fused_mxu_at_8": ("relu", "avg", True, 18, 40_000,
                       [("fused_mxu", 8)]),
}


@pytest.mark.parametrize("name", list(BRANCHES))
def test_lowered_block_matches_reference(rng, name):
    kind, mode, fuse, kib, vpu, expected = BRANCHES[name]
    x = rng.normal(size=(2, 12, 12, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 8, 16)) / 8).astype(np.float32)
    budget = dict(vmem_bytes=kib * 1024)
    if vpu is not None:
        budget["vpu_ops_budget"] = vpu
    (jx, tx), (jw, tw) = _both(x), _both(w)
    kw = dict(pool_mode=mode, activation=kind, ladder=(16, 8), fuse=fuse)
    plan_j, plan_t, rep_j, rep_t = {}, {}, {}, {}
    j_clear()
    t_clear()
    want = j_block({"w": jw}, jx, budget=JBudget(**budget), plan=plan_j,
                   quant_report=rep_j, **kw)
    got = t_block({"w": tw}, tx, budget=TBudget(**budget), plan=plan_t,
                  quant_report=rep_t, **kw)
    assert {k: v[0].name for k, v in plan_t.items()} == \
        {k: v[0].name for k, v in plan_j.items()}
    assert [(plan_t[s][0].name.split(".")[1], rep_t[s].precision_bits)
            for s in plan_t] == expected
    assert got.dtype == torch.float32
    assert_code_flip(got.numpy(), np.asarray(want),
                     block_step(x, w, kind, mode))
    _reports_agree(rep_t, rep_j, got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fuse,kib", [(False, 64), (True, 14)],
                         ids=["unfused", "fused"])
def test_lowered_frontend_matches_reference(rng, fuse, kib):
    """The reference's ladder frontend scenario (tests/test_quant.py)
    through both packages."""
    jp = j_init(jax.random.PRNGKey(1), channels=(3, 8, 16), d_model=32)
    tp = _tree(jp)
    imgs = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    jx, tx = _both(imgs)
    rep_j, rep_t, plan_j, plan_t = {}, {}, {}, {}
    j_clear()
    t_clear()
    kw = dict(ladder=(16, 8), fuse=fuse, activation="tanh")
    want = j_apply(jp, jx, budget=JBudget(vmem_bytes=kib * 1024),
                   quant_report=rep_j, plan=plan_j, **kw)
    got = t_apply(tp, tx, budget=TBudget(vmem_bytes=kib * 1024),
                  quant_report=rep_t, plan=plan_t, **kw)
    assert {k: v[0].name for k, v in plan_t.items()} == \
        {k: v[0].name for k, v in plan_j.items()}
    assert any(r.lowered for r in rep_t.values())
    assert_code_flip(got.numpy(), np.asarray(want),
                     frontend_step(jp, imgs, "tanh"))
    _reports_agree(rep_t, rep_j, got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# (e) the serving traces with a squeezed, lowered tenant
# --------------------------------------------------------------------------
def _frontend(key, channels, d_model):
    jp = j_init(jax.random.PRNGKey(key), channels=channels, d_model=d_model)
    return jp, _tree(jp)


def _replay(make, fuse, trace):
    """Register the reference's two tenants in ``make(fuse)`` and replay
    ``trace``: a list of waves of (tenant, sample, arrival)."""
    srv, params = make(fuse)
    heavy, light, (hs, ls) = params
    srv.register("heavy", heavy, hs)
    srv.register("light", light, ls, activation="tanh", ladder=(16, 8),
                 measure_quant=True)
    done = []
    for wave in trace:
        for name, x, at in wave:
            srv.submit(name, x, at=at)
        done += srv.step()
    done += srv.drain()
    return srv, sorted(done, key=lambda c: c.rid)


def _scenario(kind):
    """The reference's squeezed-tenant serving scenarios: its test at
    tests/test_runtime_serving.py:204 and the trace of
    benchmarks/run.py::_run_serving (mix 10:2, 3 waves)."""
    rng = np.random.default_rng(0)
    if kind == "serving_test":
        budget = dict(vpu_ops_budget=15_000_000)
        tenants = ((0, (8, 16), 32), (1, (6, 12), 16))
        shapes = ((32, 32, 8), (24, 24, 6))
        trace = [[("heavy", rng.normal(size=shapes[0]).astype(np.float32),
                   None) for _ in range(10)]
                 + [("light", rng.normal(size=shapes[1]).astype(np.float32),
                     None) for _ in range(2)]]
    else:
        budget = dict(vpu_ops_budget=15_000_000, vmem_bytes=2 * 2**20)
        tenants = ((0, (8, 16), 32), (1, (6, 12), 16))
        shapes = ((32, 32, 8), (24, 24, 6))
        trace = []
        for wave in range(3):
            at = None if wave else 0.0
            trace.append(
                [("heavy", rng.normal(size=shapes[0]).astype(np.float32), at)
                 for _ in range(10)]
                + [("light", rng.normal(size=shapes[1]).astype(np.float32),
                    at) for _ in range(2)])
    params = [_frontend(k, ch, d) for k, ch, d in tenants]
    return budget, params, shapes, trace


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("kind", ["serving_test", "bench_trace"])
def test_squeezed_tenant_serving_matches_reference(kind, fuse):
    budget, params, shapes, trace = _scenario(kind)
    jparams = (params[0][0], params[1][0], shapes)
    tparams = (params[0][1], params[1][1], shapes)
    j_clear()
    jsrv, want = _replay(
        lambda f: (JServer(JBudget(**budget), policy="demand", max_batch=4,
                           fuse=f), jparams), fuse, trace)
    t_clear()
    tsrv, got = _replay(
        lambda f: (TServer(TBudget(**budget), policy="demand", max_batch=4,
                           fuse=f, device="cpu"), tparams), fuse, trace)
    assert [(c.rid, c.tenant, c.batch_size, c.arrival, c.finished)
            for c in got] == \
        [(c.rid, c.tenant, c.batch_size, c.arrival, c.finished)
         for c in want]
    tel_t, tel_j = tsrv.telemetry(), jsrv.telemetry()
    err_t = {n: t.pop("max_quant_rel_err") for n, t in tel_t.items()}
    err_j = {n: t.pop("max_quant_rel_err") for n, t in tel_j.items()}
    assert tel_t == tel_j            # grants, precision_mix, lowered_fraction
    assert err_t["heavy"] == err_j["heavy"] == 0.0
    # the reference's own scenario squeezes the per-op plan only: its
    # fused group fits the light tenant's slice at f32
    lowered = not (kind == "serving_test" and fuse)
    assert (tel_t["light"]["lowered_fraction"] > 0) == lowered
    assert (0.0 < err_t["light"] <= 5e-2) == lowered
    np.testing.assert_allclose(err_t["light"], err_j["light"], **REL_ERR)
    assert {k: vars(v) for k, v in tsrv.shares().items()} == \
        {k: vars(v) for k, v in jsrv.shares().items()}
    # the heavy tenant is full precision: no flips, step 0; the light
    # tenant's grids are bounded over all its samples at once
    light = np.stack([x for wave in trace for n, x, _ in wave
                      if n == "light"])
    steps = {"heavy": 0.0,
             "light": frontend_step(params[1][0], light, "tanh")}
    for g, w in zip(got, want):
        assert_code_flip(g.result.numpy(), np.asarray(w.result),
                         steps[g.tenant])


# --------------------------------------------------------------------------
# (f) the two full-width ladder deployments plan as the reference does
# --------------------------------------------------------------------------
DEPLOYMENTS = {
    # name: (device budget, fuse, the light tenant's plan at batch 2)
    "ladder_fused": (dict(vmem_bytes=32 * 2**20,
                          vpu_ops_budget=1_000_000_000), True,
                     [("fused_vpu", 32), ("fused_mxu", 8)]),
    "ladder_chain": (dict(vmem_bytes=24 * 2**20,
                          vpu_ops_budget=2_000_000_000), False,
                     [("ip1_vpu", 16), ("pool_vpu", 8), ("act_vpu", 16),
                      ("ip1_vpu", 32), ("pool_vpu", 8), ("act_lut", 8)]),
}


def _grants(server_cls, budget_cls, params, budget, fuse, **kw):
    """Register the deployment's two tenants at 224x224x3, queue one
    wave (8 heavy, 2 light) and run one arbitration round: planning
    only, nothing executes."""
    srv = server_cls(budget_cls(**budget), policy="demand", max_batch=4,
                     fuse=fuse, **kw)
    srv.register("heavy", params[0], (224, 224, 3))
    srv.register("light", params[1], (224, 224, 3), activation="tanh",
                 ladder=(16, 8), measure_quant=True)
    img = np.zeros((224, 224, 3), np.float32)
    for name, n in (("heavy", 8), ("light", 2)):
        for _ in range(n):
            srv.submit(name, img)
    return {k: v.fraction for k, v in srv.arbiter.split().items()}


@pytest.mark.parametrize("name", list(DEPLOYMENTS))
def test_full_width_ladder_deployment_plans_match(name):
    budget, fuse, light_plan = DEPLOYMENTS[name]
    jparams = [j_init(jax.random.PRNGKey(k)) for k in (0, 1)]
    tparams = [_tree(p) for p in jparams]
    j_clear()
    t_clear()
    grants_j = _grants(JServer, JBudget, jparams, budget, fuse)
    grants_t = _grants(TServer, TBudget, tparams, budget, fuse,
                       device="cpu")
    assert grants_t == grants_j
    assert grants_t["light"] < 0.4
    for batch in (2, 4):
        shape = (batch, 224, 224, 3)
        tp = t_plan_network(
            t_specs(tparams[1], shape, "float32", activation="tanh",
                    ladder=(16, 8)),
            TBudget(**budget).scaled(grants_t["light"]), fuse=fuse)
        jp = j_plan_network(
            j_specs(jparams[1], shape, jnp.float32, activation="tanh",
                    ladder=(16, 8)),
            JBudget(**budget).scaled(grants_j["light"]), fuse=fuse)
        assert tp.to_json() == jp.to_json()
        if batch == 2:
            assert [(s.ip.name.split(".")[1], s.precision_bits)
                    for s in tp.sites] == light_plan


@pytest.mark.parametrize("kind", ["tanh", "sigmoid", "relu6"])
def test_full_width_fused_plans_never_reach_lut_or_im2col(kind):
    """With fuse=True the lowered light tenant stays fused at full width
    over a sweep of budgets (planning only): the LUT activation and the
    im2col pool are reached only by unfused plans or pool2d(budget=)."""
    tp = _tree(j_init(jax.random.PRNGKey(1)))
    specs = t_specs(tp, (4, 224, 224, 3), "float32", activation=kind,
                    ladder=(16, 8))
    members, lowered = set(), 0
    for vmem in (5, 8, 16, 32, 64, 128):
        for vpu in (50_000_000, 200_000_000, 1_000_000_000, None):
            for mxu in (True, False):
                for bits in (8, 16):
                    kw = dict(vmem_bytes=vmem * 2**20, mxu_available=mxu,
                              precision_bits=bits)
                    if vpu is not None:
                        kw["vpu_ops_budget"] = vpu
                    try:
                        plan = t_plan_network(specs, TBudget(**kw),
                                              fuse=True)
                    except ValueError:
                        continue
                    members |= {s.ip.name for s in plan.sites}
                    lowered += any(s.lowered for s in plan.sites)
    assert lowered > 0
    assert members <= {"cnn_fused.fused_vpu", "cnn_fused.fused_mxu"}
