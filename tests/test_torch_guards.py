"""The port's execution guards (``repro_torch.runtime.guards``) against
the reference's (``repro.runtime.guards``).

Every case of the reference's ``tests/test_guards.py``, re-run against
the port on the CPU: backoff-schedule properties (deadline-bounded,
monotone, seed-deterministic — property-based), every
``execute_guarded`` outcome path, and guarded serving through
``AdaptiveServer(device="cpu")``.  Then:

* ``backoff_schedule`` gives equal floats in both packages under one
  seed;
* one guarded serving trace under one fault schedule through both
  servers (the reference's Pallas kernels in interpret mode): the same
  completions, ``ok`` flags, telemetry and ``fault.injected`` /
  ``retry.attempt`` / ``guard.rejected`` events, results within
  ``rtol=1e-4, atol=1e-5``;
* what is no injected fault propagates through a guard: a
  ``RuntimeError`` (a CUDA launch failure) or a ``ValueError`` /
  ``TypeError`` (a kernel's refusal of its operands) raised inside
  ``attempt``, with no retry and no completion.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.core.plan import clear_plan_cache as j_clear
from repro.core.resources import ResourceBudget as JBudget
from repro.models.frontends import init_cnn_frontend as j_init
from repro.obs import EVENTS as J_EVENTS
from repro.runtime import AdaptiveServer as JServer
from repro.runtime.faults import INJECTOR as J_INJECTOR
from repro.runtime.faults import FaultSpec as JFaultSpec
from repro.runtime.guards import GuardPolicy as JPolicy
from repro.runtime.guards import backoff_schedule as j_backoff
from repro_torch.core.plan import clear_plan_cache as t_clear
from repro_torch.core.resources import ResourceBudget
from repro_torch.models.frontends import init_cnn_frontend, params_from_numpy
from repro_torch.obs import EVENTS
from repro_torch.runtime import AdaptiveServer
from repro_torch.runtime.faults import (INJECTOR, DeviceLost, FaultSpec,
                                        InjectedFault)
from repro_torch.runtime.guards import (MAX_DEVICE_RETRIES, GuardPolicy,
                                        backoff_schedule, execute_guarded,
                                        screen_finite)

DEVICE = ResourceBudget(vpu_ops_budget=15_000_000)

POLICY_STRATEGY = dict(
    max_retries=st.integers(min_value=0, max_value=8),
    base=st.floats(min_value=1e-4, max_value=0.1),
    factor=st.floats(min_value=1.0, max_value=4.0),
    jitter=st.floats(min_value=0.0, max_value=1.0),
    remaining=st.floats(min_value=0.0, max_value=1.0),
    seed=st.integers(min_value=0, max_value=2**16),
)
# backoff_schedule is pure and fast; under a loaded run (six workers) a
# worker can stall for over a second between two draws, which trips
# Hypothesis's per-example deadline and its too_slow health check
# without saying anything of the property.  The examples stay at 50.
BACKOFF_SETTINGS = dict(max_examples=50, deadline=None,
                        suppress_health_check=[HealthCheck.too_slow])


def _policy(max_retries, base, factor, jitter):
    return GuardPolicy(max_retries=max_retries, backoff_base_s=base,
                       backoff_factor=factor, backoff_jitter=jitter)


# --------------------------------------------------------------------------
# backoff_schedule: the three properties the retry loop relies on
# --------------------------------------------------------------------------
@settings(**BACKOFF_SETTINGS)
@given(**POLICY_STRATEGY)
def test_backoff_total_never_exceeds_deadline(max_retries, base, factor,
                                              jitter, remaining, seed):
    delays = backoff_schedule(_policy(max_retries, base, factor, jitter),
                              remaining, seed=seed)
    assert len(delays) <= max_retries
    assert sum(delays) <= remaining + 1e-12


@settings(**BACKOFF_SETTINGS)
@given(**POLICY_STRATEGY)
def test_backoff_is_monotone_nondecreasing(max_retries, base, factor,
                                           jitter, remaining, seed):
    delays = backoff_schedule(_policy(max_retries, base, factor, jitter),
                              remaining, seed=seed)
    assert all(b >= a for a, b in zip(delays, delays[1:]))
    assert all(d >= 0.0 for d in delays)


@settings(**BACKOFF_SETTINGS)
@given(**POLICY_STRATEGY)
def test_backoff_is_deterministic_under_seed(max_retries, base, factor,
                                             jitter, remaining, seed):
    p = _policy(max_retries, base, factor, jitter)
    assert (backoff_schedule(p, remaining, seed=seed)
            == backoff_schedule(p, remaining, seed=seed))


def test_backoff_unbounded_without_deadline():
    p = GuardPolicy(max_retries=3, backoff_base_s=1.0, backoff_factor=2.0)
    assert backoff_schedule(p, None) == [1.0, 2.0, 4.0]
    # and the truncation really is at the first overdrawing delay
    assert backoff_schedule(p, 3.5) == [1.0, 2.0]


# --------------------------------------------------------------------------
# Policy validation + screening
# --------------------------------------------------------------------------
def test_policy_validation():
    with pytest.raises(ValueError, match="on_nonfinite"):
        GuardPolicy(on_nonfinite="panic")
    with pytest.raises(ValueError, match="max_retries"):
        GuardPolicy(max_retries=-1)
    with pytest.raises(ValueError, match="backoff_factor"):
        GuardPolicy(backoff_factor=0.5)
    with pytest.raises(ValueError, match="backoff_jitter"):
        GuardPolicy(backoff_jitter=2.0)


def test_screen_finite():
    assert screen_finite(np.ones((2, 2)))
    assert not screen_finite(np.array([1.0, float("nan")]))
    assert not screen_finite(np.array([1.0, float("inf")]))


# --------------------------------------------------------------------------
# execute_guarded: one test per terminal path (fake clock + sleep)
# --------------------------------------------------------------------------
class _Clock:
    """Deterministic wall/sleep pair: sleep() advances wall()."""

    def __init__(self):
        self.t = 0.0
        self.slept = []

    def wall(self):
        return self.t

    def sleep(self, d):
        self.slept.append(d)
        self.t += d


def _run(attempt, policy, **kw):
    clk = _Clock()
    y, report = execute_guarded(attempt, policy, wall=clk.wall,
                                sleep=clk.sleep, **kw)
    return y, report, clk


def test_clean_attempt_passes_through():
    y, report, clk = _run(lambda retry_f32=False: np.ones(2), GuardPolicy())
    assert report.outcome == "ok" and report.retries == 0
    assert clk.slept == [] and y is not None


def test_transient_fault_retries_and_recovers():
    calls = []

    def attempt(retry_f32=False):
        calls.append(retry_f32)
        if len(calls) == 1:
            raise InjectedFault("boom")
        return np.ones(2)

    y, report, clk = _run(attempt, GuardPolicy(max_retries=2,
                                               backoff_base_s=0.01))
    assert y is not None and report.outcome == "ok"
    assert report.retries == 1 and not report.retried_f32
    assert clk.slept == [0.01]          # the retry paid its backoff delay
    assert calls == [False, False]      # ladder untouched for plain faults


def test_nonfinite_reject_fails_immediately():
    EVENTS.clear()
    calls = []

    def attempt(retry_f32=False):
        calls.append(retry_f32)
        return np.array([float("nan")])

    y, report, _ = _run(attempt, GuardPolicy(on_nonfinite="reject",
                                             max_retries=4), tenant="a")
    assert y is None and report.outcome == "rejected"
    assert report.retries == 0 and len(calls) == 1
    evs = EVENTS.recent(kind="guard.rejected")
    assert evs and evs[-1]["tenant"] == "a"


def test_nonfinite_retry_f32_flips_the_ladder_off():
    calls = []

    def attempt(retry_f32=False):
        calls.append(retry_f32)
        return np.ones(2) if retry_f32 else np.array([float("nan")])

    y, report, _ = _run(attempt, GuardPolicy(on_nonfinite="retry_f32",
                                             backoff_base_s=0.001))
    assert y is not None and report.outcome == "ok"
    assert report.retried_f32 and calls == [False, True]


def test_screening_off_lets_nonfinite_through():
    y, report, _ = _run(lambda retry_f32=False: np.array([float("nan")]),
                        GuardPolicy(screen_outputs=False))
    assert y is not None and report.outcome == "ok"


def test_retry_budget_exhausted_is_rejected():
    def attempt(retry_f32=False):
        raise InjectedFault("always")

    y, report, clk = _run(attempt, GuardPolicy(max_retries=2,
                                               backoff_base_s=0.01))
    assert y is None and report.outcome == "rejected"
    assert report.retries == 2 and len(clk.slept) == 2
    assert "retries exhausted" in report.reason


def test_hopeless_deadline_is_shed_not_retried():
    calls = []

    def attempt(retry_f32=False):
        calls.append(1)
        raise InjectedFault("always")

    # remaining 0: the whole schedule truncates away — one attempt, shed
    y, report, clk = _run(attempt, GuardPolicy(max_retries=3,
                                               backoff_base_s=0.01),
                          remaining_s=0.0)
    assert y is None and report.outcome == "shed"
    assert len(calls) == 1 and clk.slept == []


def test_deadline_passing_mid_retry_sheds():
    """The live deadline check: the schedule fit at entry, but wall time
    spent in failing attempts eats it before the next retry."""
    clk = _Clock()

    def attempt(retry_f32=False):
        clk.t += 0.4                     # each attempt burns real time
        raise InjectedFault("slow failure")

    y, report = execute_guarded(
        attempt, GuardPolicy(max_retries=3, backoff_base_s=0.1,
                             backoff_factor=1.0),
        remaining_s=0.6, wall=clk.wall, sleep=clk.sleep)
    assert y is None and report.outcome == "shed"
    assert "hopeless" in report.reason
    assert report.retries == 1           # one retry fit, the second did not


def test_device_loss_degrades_and_retries_free():
    lost = []
    calls = []

    def attempt(retry_f32=False):
        calls.append(1)
        if len(calls) == 1:
            raise DeviceLost("corpse", device=3)
        return np.ones(2)

    y, report, clk = _run(attempt, GuardPolicy(max_retries=0),
                          on_device_loss=lambda e: lost.append(e.device))
    assert y is not None and report.outcome == "ok"
    assert lost == [3]
    assert report.retries == 1 and clk.slept == []   # structural: no backoff


def test_device_loss_without_hook_is_rejected():
    def attempt(retry_f32=False):
        raise DeviceLost("corpse", device=0)

    y, report, _ = _run(attempt, GuardPolicy())
    assert y is None and report.outcome == "rejected"


def test_device_loss_retries_are_bounded():
    calls = []

    def attempt(retry_f32=False):
        calls.append(1)
        raise DeviceLost("unkillable corpse", device=0)

    y, report, _ = _run(attempt, GuardPolicy(max_retries=8),
                        on_device_loss=lambda e: None)
    assert y is None and report.outcome == "rejected"
    assert len(calls) == MAX_DEVICE_RETRIES + 1


def test_failing_degradation_rejects():
    def attempt(retry_f32=False):
        raise DeviceLost("corpse", device=0)

    def bad_hook(e):
        raise ValueError("cannot shrink past the last tenant")

    y, report, _ = _run(attempt, GuardPolicy(), on_device_loss=bad_hook)
    assert y is None and report.outcome == "rejected"
    assert "degradation failed" in report.reason


# --------------------------------------------------------------------------
# Guarded serving through AdaptiveServer
# --------------------------------------------------------------------------
def _guarded_server(policy):
    srv = AdaptiveServer(DEVICE, max_batch=2, device="cpu")
    srv.register("a", init_cnn_frontend(0, channels=(6, 12), d_model=16,
                                        device="cpu"),
                 (12, 12, 6))
    srv.set_guard("a", policy)
    return srv


def test_set_guard_validates_and_clears():
    srv = _guarded_server(GuardPolicy())
    assert srv.guard_for("a") is not None
    srv.set_guard("a", None)
    assert srv.guard_for("a") is None
    with pytest.raises(KeyError):
        srv.set_guard("ghost", GuardPolicy())


def test_poisoned_batch_is_rejected_not_served():
    srv = _guarded_server(GuardPolicy(on_nonfinite="reject"))
    rng = np.random.default_rng(0)
    with INJECTOR.armed([FaultSpec("nan_output", step=0)]):
        for _ in range(2):
            srv.submit("a", rng.normal(size=(12, 12, 6)).astype(np.float32))
        comps = srv.drain()
    assert len(comps) == 2
    assert all(not c.ok and c.result is None for c in comps)
    tel = srv.telemetry()["a"]
    assert tel["guard_rejected"] == 2 and tel["requests"] == 0
    assert srv.tenants["a"].lane_free == 0.0     # rejected work bills no lane


def test_transient_kernel_fault_is_absorbed_by_retry():
    srv = _guarded_server(GuardPolicy(max_retries=2, backoff_base_s=0.001))
    rng = np.random.default_rng(0)
    with INJECTOR.armed([FaultSpec("kernel_exception", step=0)]):
        for _ in range(2):
            srv.submit("a", rng.normal(size=(12, 12, 6)).astype(np.float32))
        comps = srv.drain()
    assert len(comps) == 2 and all(c.ok for c in comps)
    tel = srv.telemetry()["a"]
    assert tel["guard_retries"] == 1 and tel["guard_rejected"] == 0


def test_unguarded_tenant_lets_faults_propagate():
    srv = _guarded_server(GuardPolicy())
    srv.set_guard("a", None)             # back to bare execution
    rng = np.random.default_rng(0)
    with INJECTOR.armed([FaultSpec("kernel_exception", step=0)]):
        srv.submit("a", rng.normal(size=(12, 12, 6)).astype(np.float32))
        with pytest.raises(InjectedFault):
            srv.step()


def test_screen_finite_on_tensors():
    assert screen_finite(torch.ones((2, 2)))
    assert not screen_finite(torch.tensor([1.0, float("nan")]))
    assert not screen_finite(torch.tensor([[1.0], [float("-inf")]]))


# --------------------------------------------------------------------------
# Parity with the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 99, 2**16])
@pytest.mark.parametrize("kw", [
    dict(max_retries=5, backoff_base_s=0.005, backoff_factor=2.0,
         backoff_jitter=0.3),
    dict(max_retries=8, backoff_base_s=0.01, backoff_factor=1.5,
         backoff_jitter=1.0),
    dict(max_retries=3, backoff_base_s=0.1, backoff_factor=3.0)])
@pytest.mark.parametrize("remaining", [None, 0.05, 1.0])
def test_backoff_schedule_equals_the_reference(kw, seed, remaining):
    assert (backoff_schedule(GuardPolicy(**kw), remaining, seed=seed)
            == j_backoff(JPolicy(**kw), remaining, seed=seed))


PARITY_SHAPE = (12, 12, 6)
PARITY_POLICIES = {"a": dict(max_retries=2, backoff_base_s=1e-4),
                   "b": dict(on_nonfinite="retry_f32", max_retries=2,
                             backoff_base_s=1e-4)}
PARITY_SCHEDULE = [("kernel_exception", dict(step=1)),
                   ("nan_output", dict(step=2)),
                   ("nan_output", dict(step=4, tenant="b")),
                   ("kernel_exception", dict(p=0.15, once=False)),
                   ("latency_spike", dict(p=0.3, once=False, param=3.0)),
                   ("budget_shrink", dict(step=6, param=0.8))]
GUARD_EVENTS = ("fault.injected", "retry.attempt", "guard.rejected")


def _parity_run(make_server, policy_cls, spec_cls, injector, events, jp,
                waves):
    srv = make_server()
    for name in ("a", "b"):
        srv.register(name, jp[name], PARITY_SHAPE)
        srv.set_guard(name, policy_cls(**PARITY_POLICIES[name]))
    events.clear()
    comps = []
    with injector.armed([spec_cls(k, **kw) for k, kw in PARITY_SCHEDULE],
                        seed=3):
        for wave in waves:
            for name, x in wave:
                srv.submit(name, x)
            comps.extend(srv.step())
    evs = [(e["kind"], {k: v for k, v in e.items()
                        if k not in ("kind", "t", "ts", "seq")})
           for e in events.recent() if e["kind"] in GUARD_EVENTS]
    return srv, sorted(comps, key=lambda c: c.rid), evs


def test_guarded_trace_matches_the_reference():
    """One guarded two-tenant trace under one seeded fault schedule
    (injected kernel exceptions, NaN outputs under "reject" and
    "retry_f32", latency spikes, a budget shrink) through both servers."""
    rng = np.random.default_rng(5)
    waves = [[(("a", "b")[rng.integers(2)],
               rng.normal(size=PARITY_SHAPE).astype(np.float32))
              for _ in range(int(rng.integers(2, 6)))] for _ in range(8)]
    jp = {"a": j_init(jax.random.PRNGKey(0), channels=(6, 12), d_model=16),
          "b": j_init(jax.random.PRNGKey(1), channels=(6, 12), d_model=16)}
    tp = {k: params_from_numpy(jax.tree_util.tree_map(np.asarray, v),
                               device="cpu") for k, v in jp.items()}
    j_clear()
    jsrv, jcomps, jev = _parity_run(
        lambda: JServer(JBudget(vpu_ops_budget=15_000_000), max_batch=4),
        JPolicy, JFaultSpec, J_INJECTOR, J_EVENTS, jp, waves)
    t_clear()
    tsrv, tcomps, tev = _parity_run(
        lambda: AdaptiveServer(DEVICE, max_batch=4, device="cpu"),
        GuardPolicy, FaultSpec, INJECTOR, EVENTS, tp, waves)
    assert [(c.rid, c.tenant, c.ok, c.finished, c.batch_size)
            for c in tcomps] == [(c.rid, c.tenant, c.ok, c.finished,
                                  c.batch_size) for c in jcomps]
    assert any(not c.ok for c in tcomps) and any(c.ok for c in tcomps)
    for t, j in zip(tcomps, jcomps):
        if t.ok:
            np.testing.assert_allclose(t.result.numpy(), np.asarray(j.result),
                                       rtol=1e-4, atol=1e-5)
        else:
            assert t.result is None and j.result is None
    assert tev == jev
    kinds = {k for k, _ in tev}
    assert kinds == set(GUARD_EVENTS)
    assert tsrv.telemetry() == jsrv.telemetry()
    assert (dataclasses.asdict(tsrv.budget)
            == dataclasses.asdict(jsrv.budget))


# --------------------------------------------------------------------------
# What is no injected fault propagates
# --------------------------------------------------------------------------
@pytest.mark.parametrize("err", [
    RuntimeError("flash_attention: CUDA launch failed (1): invalid argument"),
    ValueError("q must start on a 16-byte boundary"),
    TypeError("x dtype torch.float64 is not supported by the CUDA kernel")],
    ids=["launch_failure", "operand_refusal", "dtype_refusal"])
def test_real_errors_propagate_through_the_guard(err):
    EVENTS.clear()
    calls = []

    def attempt(retry_f32=False):
        calls.append(retry_f32)
        raise err

    clk = _Clock()
    with pytest.raises(type(err)) as ei:
        execute_guarded(attempt, GuardPolicy(max_retries=4),
                        wall=clk.wall, sleep=clk.sleep,
                        on_device_loss=lambda e: None)
    assert ei.value is err and calls == [False] and clk.slept == []
    assert not EVENTS.recent(kind="retry.attempt")
    assert not EVENTS.recent(kind="guard.rejected")


def test_guarded_server_lets_a_launch_failure_propagate(monkeypatch):
    import repro_torch.runtime.server as server_mod
    srv = _guarded_server(GuardPolicy(max_retries=3))

    def boom(*a, **kw):
        raise RuntimeError("fused_cnn_vpu: CUDA launch failed (700)")

    monkeypatch.setattr(server_mod, "apply_cnn_frontend", boom)
    srv.submit("a", np.zeros((12, 12, 6), np.float32))
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        srv.step()
    tel = srv.telemetry()["a"]
    assert tel["guard_retries"] == 0 and tel["guard_rejected"] == 0


def test_device_loss_on_one_device_matches_the_reference():
    """On one device a scheduled ``device_loss`` marks the corpse and the
    batch serves (no mesh slice overlaps it); a ``DeviceLost`` raised
    into the guard is rejected, the degradation raising the arbiter's
    "mesh-mode only" — in both packages."""
    from repro.runtime.guards import execute_guarded as j_guarded
    from repro.runtime.faults import DeviceLost as JDeviceLost
    jsrv = JServer(JBudget(vpu_ops_budget=15_000_000), max_batch=2)
    jsrv.register("a", j_init(jax.random.PRNGKey(0), channels=(6, 12),
                              d_model=16), (12, 12, 6))
    jsrv.set_guard("a", JPolicy())
    tsrv = _guarded_server(GuardPolicy())
    x = np.random.default_rng(0).normal(size=(12, 12, 6)).astype(np.float32)
    for srv, inj, spec in ((tsrv, INJECTOR, FaultSpec),
                           (jsrv, J_INJECTOR, JFaultSpec)):
        with inj.armed([spec("device_loss", step=0, param=0)]):
            srv.submit("a", x)
            comps = srv.step()
            assert inj.lost == {0}
        assert len(comps) == 1 and comps[0].ok
    reports = []
    for srv, guarded, lost_cls, policy in (
            (tsrv, execute_guarded, DeviceLost, GuardPolicy()),
            (jsrv, j_guarded, JDeviceLost, JPolicy())):
        def attempt(retry_f32=False):
            raise lost_cls("device 0 lost", device=0)

        y, report = guarded(attempt, policy, tenant="a",
                            on_device_loss=lambda e: srv.on_device_loss(
                                e.device))
        assert y is None
        reports.append((report.outcome, report.retries, report.reason))
    assert reports[0] == reports[1]
    assert reports[0][0] == "rejected" and "mesh-mode only" in reports[0][2]
