"""The port's SLO scheduler (``repro_torch.runtime.scheduler``) and the
arbiter's SLO inputs against the reference's (``repro.runtime``).

Three parts:

* the reference's ``tests/test_scheduler.py``, re-run against the port
  (``device="cpu"``): admission, continuous batching, EDF and priority
  preemption, load shedding, queue-depth caps, the dual-clock telemetry
  contract and state round trips;
* one seeded trace fed to both schedulers under the same auto-advancing
  fake wall clock, over preemption, shedding and queue-depth rejection,
  ``slo_pressure`` 0 and 2 and ``grant_quantum`` 0 and 1/16: outcomes,
  stats, completions, state, telemetry, grants and miss rates equal, and
  results within ``1e-5`` (the bar of ``tests/test_runtime_serving.py``);
  the reference runs its Pallas kernels in interpret mode;
* seeded random sequences of ``observe``, ``record_outcome``, ``split``
  and ``preempt`` on both arbiters: equal shares, exactly, and equal
  errors for the same bad inputs.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.plan import clear_plan_cache as j_clear
from repro.core.resources import ResourceBudget as JBudget
from repro.models.frontends import init_cnn_frontend as j_init
from repro.runtime import AdaptiveServer as JServer
from repro.runtime import BudgetArbiter as JArbiter
from repro.runtime import SLOScheduler as JScheduler
from repro.runtime import SLOSpec as JSpec
from repro_torch.core.plan import clear_plan_cache as t_clear
from repro_torch.core.resources import ResourceBudget
from repro_torch.models.frontends import init_cnn_frontend, params_from_numpy
from repro_torch.obs import EVENTS
from repro_torch.runtime import (AdaptiveServer, BudgetArbiter, Request,
                                 SLOScheduler, SLOSpec)

DEVICE = ResourceBudget(vpu_ops_budget=15_000_000)
SHAPE = (12, 12, 6)


class FakeWall:
    """Manually advanced monotonic clock."""

    def __init__(self, step: float = 0.0):
        self.t = 0.0
        self.step = step      # auto-advance per reading (0 = manual)

    def __call__(self) -> float:
        t = self.t
        self.t += self.step
        return t

    def advance(self, dt: float) -> None:
        self.t += dt


def _frontend(key=0, channels=(6, 12), d_model=16):
    return init_cnn_frontend(key, channels=channels, d_model=d_model,
                             device="cpu")


def _server(**kw):
    return AdaptiveServer(DEVICE, max_batch=4, device="cpu", **kw)


def _deployment(wall=None, **slo_kwargs):
    srv = _server(policy="demand")
    sched = (SLOScheduler(srv, wall=wall) if wall is not None
             else SLOScheduler(srv))
    sched.register("t", _frontend(), SHAPE,
                   slo=SLOSpec(**(slo_kwargs or {"deadline_s": 60.0})))
    return srv, sched


def _sample(rng, shape=SHAPE):
    return rng.normal(size=shape).astype(np.float32)


# --------------------------------------------------------------------------
# The reference's tests/test_scheduler.py, against the port
# --------------------------------------------------------------------------
def test_slospec_validates_fields():
    with pytest.raises(ValueError):
        SLOSpec(deadline_s=0.0)
    with pytest.raises(ValueError):
        SLOSpec(deadline_s=-1.0)
    with pytest.raises(ValueError):
        SLOSpec(deadline_s=1.0, max_queue_depth=0)
    spec = SLOSpec(deadline_s=1.0, priority=3, max_queue_depth=2)
    assert (spec.deadline_s, spec.priority, spec.max_queue_depth) \
        == (1.0, 3, 2)


def test_register_requires_slospec_and_submit_validates():
    sched = SLOScheduler(_server())
    with pytest.raises(TypeError):
        sched.register("t", _frontend(), SHAPE, slo=1.5)
    sched.register("t", _frontend(), SHAPE, slo=SLOSpec(deadline_s=1.0))
    rng = np.random.default_rng(0)
    with pytest.raises(KeyError):
        sched.submit("ghost", _sample(rng))
    with pytest.raises(ValueError):
        sched.submit("t", _sample(rng, (8, 8, 3)))


def test_scheduler_refuses_server_with_queued_requests(rng):
    srv = _server()
    srv.register("t", _frontend(), SHAPE)
    srv.submit("t", _sample(rng))
    with pytest.raises(ValueError):
        SLOScheduler(srv)


def test_batches_fill_to_max_batch(rng):
    srv, sched = _deployment()
    rids = [sched.submit("t", _sample(rng)) for _ in range(6)]
    comps = sched.run()
    assert len(comps) == 6
    assert sched.launches == 2            # 4 + 2, not 6 singles
    assert all(sched.outcomes[r] == "ok" for r in rids)
    assert sched.pending() == 0


def test_deferred_arrival_waits_for_its_clock(rng):
    srv, sched = _deployment()
    early = sched.submit("t", _sample(rng))
    late = sched.submit("t", _sample(rng), at=sched.now + 1e9)
    comps = sched.run()
    assert len(comps) == 2
    assert sched.launches == 2            # the late arrival missed batch 1
    assert {c.rid for c in comps} == {early, late}
    assert sched.now >= 1e9


def test_earliest_deadline_jumps_queue_without_priority(rng):
    """Equal priorities: the tighter-deadline bucket launches first —
    an EDF reorder, not a preemption."""
    sched = SLOScheduler(_server())
    sched.register("loose", _frontend(0), SHAPE,
                   slo=SLOSpec(deadline_s=100.0))
    sched.register("tight", _frontend(1), SHAPE,
                   slo=SLOSpec(deadline_s=0.5))
    sched.submit("loose", _sample(rng))
    sched.submit("tight", _sample(rng))
    comps = sched.run()
    assert comps[0].tenant == "tight"
    assert sched.preemptions == 0


def test_priority_preempts_queued_bucket_and_moves_grant(rng):
    EVENTS.clear()
    srv = _server()
    sched = SLOScheduler(srv)
    sched.register("bulk", _frontend(0), SHAPE,
                   slo=SLOSpec(deadline_s=60.0, priority=0))
    sched.register("rt", _frontend(1), SHAPE,
                   slo=SLOSpec(deadline_s=60.0, priority=2))
    sched.submit("bulk", _sample(rng))       # queued first (FIFO baseline)
    sched.submit("rt", _sample(rng))
    comps = sched.run()
    assert comps[0].tenant == "rt"           # jumped the earlier bucket
    assert sched.preemptions >= 1
    assert srv.tenants["rt"].telemetry.preemptions >= 1
    assert srv.arbiter.preemptions >= 1      # grant actually moved
    evs = EVENTS.recent(kind="scheduler.preempt")
    assert evs and evs[-1]["winner"] == "rt" and evs[-1]["victim"] == "bulk"
    assert EVENTS.recent(kind="arbiter.preempt")


def test_expired_requests_are_shed_not_executed(rng):
    EVENTS.clear()
    wall = FakeWall()
    srv, sched = _deployment(wall=wall, deadline_s=0.5)
    rids = [sched.submit("t", _sample(rng)) for _ in range(8)]
    sched.run(max_launches=sched.launches + 1)   # first 4 served at t=0
    wall.advance(1.0)                            # the rest expire queued
    comps = sched.run()
    assert comps == []
    assert sched.sheds == 4
    assert sorted(sched.outcomes[r] for r in rids) \
        == ["ok"] * 4 + ["shed"] * 4
    assert sched.pending() == 0
    assert srv.tenants["t"].telemetry.shed == 4
    assert srv.arbiter.miss_rate("t") > 0.0      # sheds feed the EWMA
    assert EVENTS.recent(kind="scheduler.shed")


def test_max_queue_depth_rejects_overflow(rng):
    srv, sched = _deployment(deadline_s=60.0, max_queue_depth=2)
    rids = [sched.submit("t", _sample(rng)) for _ in range(5)]
    comps = sched.run()
    assert len(comps) == 2
    assert sched.rejections == 3
    outcomes = [sched.outcomes[r] for r in rids]
    assert outcomes.count("rejected") == 3 and outcomes.count("ok") == 2
    assert srv.tenants["t"].telemetry.shed == 3  # rejections count as shed


def test_telemetry_reports_both_clocks(rng):
    srv, sched = _deployment(deadline_s=60.0)
    for _ in range(4):
        sched.submit("t", _sample(rng))
    sched.run()
    snap = srv.tenants["t"].telemetry.snapshot()
    assert snap["p95_cycles"] > 0.0              # modeled est-cycles clock
    assert snap["wall_p95_s"] >= 0.0             # measured wall clock
    assert snap["slo_tracked"] == 4
    assert snap["deadline_misses"] == 0
    assert snap["deadline_miss_rate"] == 0.0


def test_wall_clock_judges_misses_not_the_model_clock(rng):
    # auto-advancing wall + shedding disabled: every request is judged
    # LATE on the wall even though the modeled est-cycles latency is tiny
    wall = FakeWall(step=0.1)
    srv = _server()
    sched = SLOScheduler(srv, wall=wall, shed_margin_s=-1e9)
    sched.register("t", _frontend(), SHAPE, slo=SLOSpec(deadline_s=0.05))
    rids = [sched.submit("t", _sample(rng)) for _ in range(4)]
    comps = sched.run()
    assert len(comps) == 4                       # executed, not shed
    assert all(sched.outcomes[r] == "miss" for r in rids)
    assert all(c.ok for c in comps)
    snap = srv.tenants["t"].telemetry.snapshot()
    assert snap["deadline_misses"] == 4
    assert snap["deadline_miss_rate"] == 1.0
    assert srv.arbiter.miss_rate("t") > 0.0


def test_grant_quantum_bounds_budget_key_space():
    arb = BudgetArbiter(ResourceBudget(), rebalance_threshold=0.0,
                        demand_alpha=1.0, grant_quantum=1 / 8)
    arb.register("a", floor=0.05)
    arb.register("b", floor=0.05)
    arb.observe("a", 700.0)
    arb.observe("b", 300.0)
    shares = arb.split()
    for s in shares.values():
        on_grid = abs(s.fraction / (1 / 8) - round(s.fraction / (1 / 8))) \
            < 1e-9
        assert on_grid or s.fraction == pytest.approx(s.floor)
        assert s.fraction >= s.floor
    assert sum(s.fraction for s in shares.values()) <= 1.0 + 1e-9


def test_grant_quantum_validation():
    with pytest.raises(ValueError):
        BudgetArbiter(ResourceBudget(), grant_quantum=1.0)
    with pytest.raises(ValueError):
        BudgetArbiter(ResourceBudget(), grant_quantum=-0.1)


def test_slo_pressure_amplifies_missing_tenant():
    arb = BudgetArbiter(ResourceBudget(), rebalance_threshold=0.0,
                        demand_alpha=1.0, slo_pressure=4.0, miss_alpha=1.0)
    arb.register("a")
    arb.register("b")
    arb.observe("a", 500.0)
    arb.observe("b", 500.0)
    even = arb.split()
    assert even["a"].fraction == pytest.approx(even["b"].fraction)
    arb.observe("a", 500.0)
    arb.observe("b", 500.0)
    arb.record_outcome("a", served=4, missed=4)  # a is missing deadlines
    shares = arb.split()
    assert shares["a"].fraction > shares["b"].fraction


def test_state_dict_roundtrip(rng):
    srv, sched = _deployment(deadline_s=2.5)
    sched.submit("t", _sample(rng))
    sched.run()
    state = sched.state_dict()
    assert state["slos"]["t"]["deadline_s"] == 2.5
    assert state["launches"] == sched.launches

    srv2 = _server()
    srv2.register("t", _frontend(), SHAPE)
    sched2 = SLOScheduler(srv2)
    sched2.load_state(state)
    assert sched2.slos["t"] == sched.slos["t"]
    assert sched2.launches == sched.launches


def test_load_state_rejects_unregistered_tenant():
    sched = SLOScheduler(_server())
    with pytest.raises(ValueError):
        sched.load_state({"slos": {"ghost": {"deadline_s": 1.0,
                                             "priority": 0,
                                             "max_queue_depth": None}}})


# --------------------------------------------------------------------------
# One seeded trace through both schedulers under the same fake wall
# --------------------------------------------------------------------------
# scenario -> (per tenant (deadline_s, priority, max_queue_depth), the fake
# wall's step a reading, the wall advance between the two runs, the
# scheduler's shed_margin_s)
PARITY = {
    "preempt": ({"bulk": (60.0, 0, None), "rt": (60.0, 2, None)}, 0.01, 0.0,
                0.0),
    "shed": ({"bulk": (0.3, 0, None), "rt": (2.0, 1, None)}, 0.02, 1.0, 0.0),
    "reject": ({"bulk": (60.0, 0, 2), "rt": (60.0, 1, 3)}, 0.0, 0.0, 0.0),
    "miss": ({"bulk": (0.15, 0, None), "rt": (0.5, 1, None)}, 0.02, 0.0,
             -1e9),
}
# the verdict each scenario must hand out at least once (every scenario
# also preempts: the real-time requests queue behind the bulk burst)
PARITY_SHOWS = {"preempt": "ok", "shed": "shed", "reject": "rejected",
                "miss": "miss"}
PACKAGES = {"reference": (JServer, JScheduler, JSpec, JBudget, j_clear, {}),
            "port": (AdaptiveServer, SLOScheduler, SLOSpec, ResourceBudget,
                     t_clear, {"device": "cpu"})}


def make_parity_params():
    """The two tenants' frontends, drawn by the reference and carried
    across as numpy."""
    jp = {"bulk": j_init(jax.random.PRNGKey(0), channels=(6, 12),
                         d_model=16),
          "rt": j_init(jax.random.PRNGKey(1), channels=(6, 12), d_model=16)}
    tp = {name: params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), "cpu")
        for name, p in jp.items()}
    return {"reference": jp, "port": tp}


@pytest.fixture(scope="module")
def parity_params():
    return make_parity_params()


def parity_run(package, params, scenario, slo_pressure, grant_quantum):
    """Serve the scenario's trace through one package's scheduler: a bulk
    burst queued ahead of two real-time requests, deferred arrivals of
    both, two launches, the wall moved on, three more real-time requests,
    then run to the end.  Returns (server, scheduler, completions)."""
    server, scheduler, spec, budget, clear, kw = PACKAGES[package]
    slos, step, advance, margin = PARITY[scenario]
    clear()
    wall = FakeWall(step)
    srv = server(budget(vpu_ops_budget=15_000_000), policy="demand",
                 max_batch=4, slo_pressure=slo_pressure,
                 grant_quantum=grant_quantum, **kw)
    sched = scheduler(srv, wall=wall, shed_margin_s=margin)
    for name, act in (("bulk", "relu"), ("rt", "tanh")):
        deadline, priority, depth = slos[name]
        sched.register(name, params[name], SHAPE, activation=act,
                       slo=spec(deadline_s=deadline, priority=priority,
                                max_queue_depth=depth))
    rng = np.random.default_rng(11)
    unit = srv.tenants["bulk"].unit_cost
    for _ in range(6):
        sched.submit("bulk", _sample(rng))
    for _ in range(2):
        sched.submit("rt", _sample(rng))
    for i in range(3):
        sched.submit("bulk", _sample(rng), at=(i + 1) * 0.6 * unit)
    sched.submit("rt", _sample(rng), at=0.9 * unit)
    comps = sched.run(max_launches=sched.launches + 2)
    wall.advance(advance)
    sched.submit("rt", np.stack([_sample(rng) for _ in range(3)]))
    comps += sched.run()
    return srv, sched, comps


def parity_runs(params, scenario, slo_pressure, grant_quantum):
    return {package: parity_run(package, params[package], scenario,
                                slo_pressure, grant_quantum)
            for package in PACKAGES}


@pytest.mark.parametrize("grant_quantum", [0.0, 1 / 16], ids=["q0", "q16"])
@pytest.mark.parametrize("slo_pressure", [0.0, 2.0], ids=["p0", "p2"])
@pytest.mark.parametrize("scenario", sorted(PARITY))
def test_scheduler_trace_matches_reference(parity_params, scenario,
                                           slo_pressure, grant_quantum):
    runs = parity_runs(parity_params, scenario, slo_pressure, grant_quantum)
    (jsrv, jsched, want), (tsrv, tsched, got) = (runs["reference"],
                                                 runs["port"])
    assert PARITY_SHOWS[scenario] in tsched.outcomes.values()
    assert tsched.preemptions >= 1
    assert tsched.outcomes == jsched.outcomes
    assert tsched.stats() == jsched.stats()
    assert tsched.state_dict() == jsched.state_dict()
    assert tsched.now == jsched.now
    assert [(c.rid, c.tenant, c.arrival, c.finished, c.batch_size, c.ok)
            for c in got] == \
        [(c.rid, c.tenant, c.arrival, c.finished, c.batch_size, c.ok)
         for c in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.result.numpy(), np.asarray(w.result),
                                   rtol=1e-5, atol=1e-5)
    assert tsrv.telemetry() == jsrv.telemetry()
    assert {k: vars(v) for k, v in tsrv.arbiter.shares().items()} == \
        {k: vars(v) for k, v in jsrv.arbiter.shares().items()}
    for name in ("bulk", "rt"):
        assert tsrv.arbiter.miss_rate(name) == jsrv.arbiter.miss_rate(name)
    assert (tsrv.arbiter.rebalances, tsrv.arbiter.preemptions) == \
        (jsrv.arbiter.rebalances, jsrv.arbiter.preemptions)
    assert tsrv.clock == jsrv.clock


# --------------------------------------------------------------------------
# The arbiter's SLO inputs: same decisions, same errors
# --------------------------------------------------------------------------
def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except (KeyError, ValueError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("kw", [
    dict(slo_pressure=2.0, grant_quantum=1 / 16),
    dict(slo_pressure=0.5, miss_alpha=0.3, rebalance_threshold=0.0),
    dict(policy="static", grant_quantum=0.1),
    dict(slo_pressure=4.0, miss_alpha=1.0, demand_alpha=1.0),
], ids=["pressure_quantum", "alpha", "static", "sharp"])
@pytest.mark.parametrize("seed", range(3))
def test_arbiter_slo_inputs_match_reference(kw, seed):
    kw = {"rebalance_threshold": 0.02, **kw}
    ja, ta = JArbiter(JBudget(), **kw), BudgetArbiter(ResourceBudget(), **kw)
    for arb in (ja, ta):
        for name, floor in (("a", 0.15), ("b", 0.1), ("c", 0.05)):
            arb.register(name, floor=floor)
    names = ["a", "b", "c", "ghost"]
    rng = np.random.default_rng(seed)
    ops = ("observe", "record", "split", "preempt")
    for _ in range(60):
        op = ops[int(rng.integers(len(ops)))]
        if op == "observe":
            name, cost = names[int(rng.integers(3))], float(rng.integers(1, 900))
            got = [_outcome(a.observe, name, cost) for a in (ja, ta)]
        elif op == "record":
            name = names[int(rng.integers(4))]
            served, missed = (int(x) for x in rng.integers(-1, 6, size=2))
            got = [_outcome(a.record_outcome, name, served=served,
                            missed=missed) for a in (ja, ta)]
        elif op == "split":
            got = [_outcome(lambda a=a: {k: vars(v)
                                          for k, v in a.split().items()})
                   for a in (ja, ta)]
        else:
            winner, victim = (names[int(i)] for i in rng.integers(4, size=2))
            got = [_outcome(a.preempt, winner, victim) for a in (ja, ta)]
        assert got[0] == got[1], op
        assert {k: vars(v) for k, v in ta.shares().items()} == \
            {k: vars(v) for k, v in ja.shares().items()}
        assert [ta.miss_rate(n) for n in names] == \
            [ja.miss_rate(n) for n in names]
    assert (ta.rebalances, ta.preemptions) == (ja.rebalances, ja.preemptions)


@pytest.mark.parametrize("kw", [dict(slo_pressure=-0.1), dict(miss_alpha=0.0),
                                dict(miss_alpha=1.5), dict(grant_quantum=1.0),
                                dict(grant_quantum=-0.1)],
                         ids=["pressure", "alpha0", "alpha15", "quantum1",
                              "quantum_neg"])
def test_arbiter_slo_argument_errors_match_reference(kw):
    assert _outcome(BudgetArbiter, ResourceBudget(), **kw) == \
        _outcome(JArbiter, JBudget(), **kw)
    assert _outcome(BudgetArbiter, ResourceBudget(), **kw)[0] == "ValueError"


def test_server_slo_seams(rng):
    """The seams the scheduler and part 2's guards use: ``mesh`` is
    None, completions are ``ok``, ``_execute`` takes
    ``deadline_budget_s=``, ``on_budget_shrink`` scales the budget the
    next batch plans under and refuses a bad fraction."""
    srv = _server(slo_pressure=1.0, miss_alpha=0.25, grant_quantum=0.125)
    assert srv.mesh is None
    assert (srv.arbiter.slo_pressure, srv.arbiter.miss_alpha,
            srv.arbiter.grant_quantum) == (1.0, 0.25, 0.125)
    srv.register("t", _frontend(), SHAPE)
    srv._apply_shares(srv.arbiter.split())
    comps = srv._execute([Request(rid=0, tenant="t",
                                  x=torch.from_numpy(_sample(rng)),
                                  arrival=0.0)], deadline_budget_s=0.5)
    assert len(comps) == 1 and comps[0].ok
    EVENTS.clear()
    before = srv.budget
    srv.on_budget_shrink(0.5)
    assert srv.budget == before.scaled(0.5)
    assert srv.arbiter.budget == srv.budget
    assert EVENTS.recent(kind="budget.shrunk")
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="fraction must be in"):
            srv.on_budget_shrink(bad)
