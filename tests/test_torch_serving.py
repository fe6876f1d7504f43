"""The port's serving runtime (``repro_torch.runtime``, ``device="cpu"``)
against the reference's (``repro.runtime``) on the same request trace.

Request ids, batch sizes, arrivals and est-cycle finish times must be
equal (latency is modeled in the planner's cost units, so equal plans
give equal numbers), the telemetry snapshots equal, and results within
``1e-5`` (the bar ``tests/test_runtime_serving.py`` uses for batched vs
per-request execution)."""
import jax
import numpy as np
import pytest
import torch

from repro.core.plan import clear_plan_cache as j_clear
from repro.core.resources import ResourceBudget as JBudget
from repro.models.frontends import init_cnn_frontend as j_init
from repro.runtime import AdaptiveServer as JServer
from repro.runtime import BudgetArbiter as JArbiter
from repro_torch.core.plan import clear_plan_cache as t_clear
from repro_torch.core.resources import MeshSpec
from repro_torch.core.resources import ResourceBudget as TBudget
from repro_torch.models.frontends import CudaUnavailableError, params_from_numpy
from repro_torch.runtime.arbiter import BudgetArbiter as TArbiter
from repro_torch.runtime.batching import Request, ShapeBucketQueue
from repro_torch.runtime.server import AdaptiveServer as TServer

TENANTS = {"big": (dict(channels=(3, 16, 32), d_model=64), (16, 16, 3)),
           "small": (dict(channels=(3, 8, 16), d_model=32), (12, 12, 3))}


def _run_trace(server, params, rng_seed, fuse_label):
    """Register both tenants, then a skewed trace: a burst for "big",
    a trickle for "small", a step in between, timed arrivals, drain."""
    for name, (_, shape) in TENANTS.items():
        server.register(name, params[name], shape)
    rng = np.random.default_rng(rng_seed)
    done = []
    for name, count, at in (("big", 6, 0.0), ("small", 2, 10.0)):
        shape = TENANTS[name][1]
        for _ in range(count):
            server.submit(name, rng.normal(size=shape).astype(np.float32),
                          at=at)
    done += server.step()
    stack = rng.normal(size=(3,) + TENANTS["small"][1]).astype(np.float32)
    server.submit("small", stack)                 # fans out to 3 requests
    server.submit("big", rng.normal(size=TENANTS["big"][1])
                  .astype(np.float32), at=5e5)
    done += server.drain()
    return sorted(done, key=lambda c: c.rid)


@pytest.fixture(scope="module")
def params():
    jp, tp = {}, {}
    for i, (name, (kw, _)) in enumerate(TENANTS.items()):
        jp[name] = j_init(jax.random.PRNGKey(i), **kw)
        tp[name] = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp[name]), "cpu")
    return jp, tp


@pytest.mark.parametrize("policy", ["demand", "static"])
def test_server_trace_matches_reference(params, policy):
    jp, tp = params
    budget = dict(vpu_ops_budget=40_000_000)
    j_clear()
    t_clear()
    jsrv = JServer(JBudget(**budget), policy=policy, max_batch=4)
    tsrv = TServer(TBudget(**budget), policy=policy, max_batch=4,
                   device="cpu")
    want = _run_trace(jsrv, jp, 0, policy)
    got = _run_trace(tsrv, tp, 0, policy)
    assert [(c.rid, c.tenant, c.batch_size, c.arrival, c.finished)
            for c in got] == \
        [(c.rid, c.tenant, c.batch_size, c.arrival, c.finished)
         for c in want]
    assert all(c.ok for c in want)
    for g, w in zip(got, want):
        assert g.latency == w.latency
        assert tuple(g.result.shape) == np.asarray(w.result).shape
        np.testing.assert_allclose(g.result.numpy(), np.asarray(w.result),
                                   rtol=1e-5, atol=1e-5)
    assert tsrv.telemetry() == jsrv.telemetry()
    assert {k: vars(v) for k, v in tsrv.shares().items()} == \
        {k: vars(v) for k, v in jsrv.shares().items()}
    assert tsrv.queue_stats() == jsrv.queue_stats()
    assert tsrv.clock == jsrv.clock
    assert tsrv.arbiter.rebalances == jsrv.arbiter.rebalances


def test_server_fused_and_unfused_agree_bitwise(params):
    _, tp = params
    out = {}
    for fuse in (True, False):
        t_clear()
        srv = TServer(max_batch=4, fuse=fuse, device="cpu")
        out[fuse] = _run_trace(srv, tp, 1, fuse)
    for a, b in zip(out[True], out[False]):
        assert a.rid == b.rid and torch.equal(a.result, b.result)


def test_server_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError, match='device="cpu"'):
        TServer()
    assert TServer(device="cpu").device.type == "cpu"


def test_server_named_errors(params):
    _, tp = params
    srv = TServer(device="cpu")
    srv.register("t", tp["small"], (12, 12, 3))
    with pytest.raises(ValueError, match="already registered"):
        srv.register("t", tp["small"], (12, 12, 3))
    with pytest.raises(ValueError, match="expects samples of shape"):
        srv.submit("t", np.zeros((10, 10, 3), np.float32))
    with pytest.raises(ValueError, match="unknown policy"):
        TServer(policy="fifo", device="cpu")
    # a mesh of two devices (no longer refused): a mesh-mode arbiter
    arb = TArbiter(mesh=MeshSpec(devices=2))
    assert arb.mesh == MeshSpec(devices=2)
    arb.register("a")
    assert arb.split()["a"].devices == 2


def test_unknown_activation_and_pool_mode_refused_at_spec_time(params):
    """Both servers refuse ``activation="swish"`` at ``register`` with
    the reference's ``ValueError`` and admit nothing; ``register`` takes
    no pool mode, so ``pool_mode="median"`` is held where the server's
    specs come from (``cnn_block_site_specs``) and at ``apply_cnn_block``
    in both packages, with one message."""
    from repro.models import blocks as j_blocks
    from repro_torch.models import blocks as t_blocks
    jp, tp = params
    errors = []
    for srv, p in ((JServer(max_batch=4), jp["small"]),
                   (TServer(max_batch=4, device="cpu"), tp["small"])):
        with pytest.raises(ValueError) as e:
            srv.register("t", p, (12, 12, 3), activation="swish")
        errors.append(str(e.value))
        assert srv.tenants == {} and srv.pending() == 0
    assert errors == ["unknown activation 'swish'; have ('relu', 'relu6', "
                      "'sigmoid', 'tanh', 'gelu')"] * 2
    xs, ws = (2, 12, 12, 3), (3, 3, 3, 8)
    for bad in (dict(pool_mode="median"), dict(activation="swish"),
                dict(pool_mode="median", activation="swish")):
        errors = []
        for blocks in (j_blocks, t_blocks):
            with pytest.raises(ValueError) as e:
                blocks.cnn_block_site_specs(xs, ws, x_dtype="float32", **bad)
            errors.append(str(e.value))
        assert errors[0] == errors[1], bad
    x = np.zeros(xs, np.float32)
    w = np.zeros(ws, np.float32)
    errors = []
    for blocks, arr in ((j_blocks, np.asarray), (t_blocks, torch.from_numpy)):
        with pytest.raises(ValueError) as e:
            blocks.apply_cnn_block({"w": arr(w)}, arr(x), pool_mode="median")
        errors.append(str(e.value))
    assert errors == ["unknown pool mode 'median'"] * 2


# --------------------------------------------------------------------------
# Arbiter and batching: same decisions as the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("policy,threshold", [("demand", 0.02),
                                              ("demand", 0.3),
                                              ("static", 0.02)])
def test_arbiter_matches_reference(policy, threshold):
    kw = dict(policy=policy, rebalance_threshold=threshold,
              demand_alpha=0.7)
    ja, ta = JArbiter(JBudget(), **kw), TArbiter(TBudget(), **kw)
    for arb in (ja, ta):
        arb.register("a", floor=0.2)
        arb.register("b", floor=0.1)
    rng = np.random.default_rng(5)
    for _ in range(6):
        for name in ("a", "b"):
            cost = float(rng.integers(1, 1000))
            ja.observe(name, cost)
            ta.observe(name, cost)
        js, ts = ja.split(), ta.split()
        assert {k: vars(v) for k, v in ts.items()} == \
            {k: vars(v) for k, v in js.items()}
    assert ta.rebalances == ja.rebalances
    for name in ("a", "b"):
        assert ta.budget_for(name) == TBudget(**vars(ja.budget_for(name)))


def test_arbiter_admission_errors():
    arb = TArbiter(TBudget())
    arb.register("a", floor=0.7)
    with pytest.raises(ValueError, match="jointly need"):
        arb.register("b", floor=0.5)
    assert set(arb.split()) == {"a"}
    static = TArbiter(TBudget(), policy="static")
    static.register("a", floor=0.65)
    with pytest.raises(ValueError, match="static even split"):
        static.register("b", floor=0.1)
    with pytest.raises(KeyError, match="no grant yet"):
        TArbiter().budget_for("nobody")


def test_bucket_queue_is_fifo_per_shape():
    q = ShapeBucketQueue()
    for rid, (tenant, shape) in enumerate([("t1", (4, 4)), ("t1", (4, 4)),
                                           ("t2", (4, 4)), ("t1", (8, 8))]):
        q.push(Request(rid=rid, tenant=tenant, x=torch.zeros(shape),
                       arrival=0.0))
    assert len(q) == 4 and q.pending("t1") == 3
    keys = q.keys()
    assert len(keys) == 3
    assert [r.rid for r in q.pop_batch(keys[0], max_batch=8)] == [0, 1]
    assert q.stats()["pops"] == 1 and q.pending("t1") == 1


# --------------------------------------------------------------------------
# calibration= and autotune=: the calibrated server matches the reference
# --------------------------------------------------------------------------
def _serving_table(cal, res):
    """A table fitted on the same synthetic samples in either package:
    dedicated fits for the members the two ladder tenants plan (fused
    priced dear, so the calibrated plans differ from the analytical
    ones), and the global fit for the rest."""
    rng = np.random.default_rng(5)
    table = cal.CalibrationTable()
    members = {"conv2d.ip1_vpu": 2e-5, "conv2d.ip2_mxu": 4e-5,
               "pool2d.pool_vpu": 1e-5, "activation.act_vpu": 1e-5,
               "activation.act_lut@int8": 5e-6, "cnn_fused.fused_vpu": 4e-4,
               "cnn_fused.fused_mxu": 3e-4, "pool2d.pool_vpu@int8": 1e-5}
    for m, a in members.items():
        for _ in range(4):
            comp = float(rng.uniform(1e3, 1e6))
            hbm = int(rng.integers(1 << 12, 1 << 22))
            fp = res.Footprint(vmem_bytes=1024, hbm_bytes=hbm, mxu_passes=0,
                               vpu_ops=100,
                               est_cycles=comp + res.hbm_cycles(hbm))
            table.record(m, fp, a * comp + 2e-6 * hbm + rng.uniform(5, 20))
    return table.fit()


def test_calibrated_server_matches_reference():
    from repro.core import calibrate_cost as j_cal
    from repro.core import resources as j_res
    from repro_torch.core import calibrate_cost as t_cal
    from repro_torch.core import resources as t_res
    from repro_torch.core.plan import plan_network as t_plan_network
    from test_torch_ladder import _replay, _scenario, assert_code_flip
    from test_torch_ladder import frontend_step

    budget, params, shapes, trace = _scenario("serving_test")
    jt, tt = _serving_table(j_cal, j_res), _serving_table(t_cal, t_res)
    assert tt.to_json() == jt.to_json() and tt.key() == jt.key()
    jparams = (params[0][0], params[1][0], shapes)
    tparams = (params[0][1], params[1][1], shapes)
    for fuse in (True, False):
        j_clear()
        jsrv, want = _replay(lambda f: (JServer(
            JBudget(**budget), policy="demand", max_batch=4, fuse=f,
            calibration=jt), jparams), fuse, trace)
        t_clear()
        tsrv, got = _replay(lambda f: (TServer(
            TBudget(**budget), policy="demand", max_batch=4, fuse=f,
            calibration=tt, device="cpu"), tparams), fuse, trace)
        assert [(c.rid, c.tenant, c.batch_size, c.arrival, c.finished)
                for c in got] == \
            [(c.rid, c.tenant, c.batch_size, c.arrival, c.finished)
             for c in want]
        assert [c.latency for c in got] == [c.latency for c in want]
        tel_t, tel_j = tsrv.telemetry(), jsrv.telemetry()
        err_t = {n: t.pop("max_quant_rel_err") for n, t in tel_t.items()}
        err_j = {n: t.pop("max_quant_rel_err") for n, t in tel_j.items()}
        assert tel_t == tel_j        # grants, unit costs, precision mix
        assert {t["calibration_key"] for t in tel_t.values()} == {tt.key()}
        assert {n: t.unit_cost for n, t in tsrv.tenants.items()} == \
            {n: t.unit_cost for n, t in jsrv.tenants.items()}
        assert {k: vars(v) for k, v in tsrv.shares().items()} == \
            {k: vars(v) for k, v in jsrv.shares().items()}
        assert tsrv.arbiter.calibration is tt
        assert err_t["heavy"] == err_j["heavy"] == 0.0
        light = np.stack([x for wave in trace for n, x, _ in wave
                          if n == "light"])
        steps = {"heavy": 0.0,
                 "light": frontend_step(params[1][0], light, "tanh")}
        for g, w in zip(got, want):
            assert_code_flip(g.result.numpy(), np.asarray(w.result),
                             steps[g.tenant])
        # the analytical model prices the tenants otherwise
        for name, t in tsrv.tenants.items():
            one = tsrv._specs(t.params, (1,) + t.input_shape, "float32",
                              t.pool_window, t.activation, t.ladder)
            assert t.unit_cost != t_plan_network(
                one, tsrv.budget, fuse=fuse).calibrated_cycles(None)
        if not fuse:
            continue
        # autotune=True: the tuned tilings change no bit of any result
        t_clear()
        _, tuned = _replay(lambda f: (TServer(
            TBudget(**budget), policy="demand", max_batch=4, fuse=f,
            calibration=tt, autotune=True, device="cpu"), tparams), fuse,
            trace)
        assert [(c.rid, c.finished) for c in tuned] == \
            [(c.rid, c.finished) for c in got]
        assert all(torch.equal(a.result, b.result)
                   for a, b in zip(tuned, got))
