"""The port's fault injector (``repro_torch.runtime.faults``) against the
reference's (``repro.runtime.faults``).

Every case of the reference's ``tests/test_faults.py``, re-run against
the port on the CPU (``device="cpu"``): schedule validation, the
zero-cost disabled path, deterministic firing (step- and
probability-triggered), the seam protocol (device loss, output
poisoning, latency scaling) and the bit-transparency of an armed but
never-firing injector at the server.  Then parity: one ``p=`` schedule
under one seed fires at the same polls in both packages, and
``perturb_output`` never writes the caller's tensor.
"""
import numpy as np
import pytest
import torch

from repro.runtime.faults import FaultInjector as JInjector
from repro.runtime.faults import FaultSpec as JSpec
from repro_torch.core.resources import ResourceBudget
from repro_torch.models.frontends import init_cnn_frontend
from repro_torch.obs import EVENTS
from repro_torch.runtime import AdaptiveServer
from repro_torch.runtime.faults import (FAULT_KINDS, INJECTOR, SEAM_OF,
                                        DeviceLost, FaultInjector, FaultSpec)

DEVICE = ResourceBudget(vpu_ops_budget=15_000_000)


def _frontend(key=0):
    return init_cnn_frontend(key, channels=(6, 12), d_model=16,
                             device="cpu")


# --------------------------------------------------------------------------
# Schedule validation
# --------------------------------------------------------------------------
def test_every_kind_has_a_seam():
    assert set(SEAM_OF) == set(FAULT_KINDS)


def test_spec_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("gamma_ray", step=0)


def test_spec_needs_a_trigger():
    with pytest.raises(ValueError, match="step=.*or p="):
        FaultSpec("nan_output")
    with pytest.raises(ValueError, match="p must be in"):
        FaultSpec("nan_output", p=1.5)


def test_arm_rejects_non_spec_entries():
    inj = FaultInjector()
    with pytest.raises(TypeError, match="FaultSpec"):
        inj.arm([{"kind": "nan_output", "step": 0}])


# --------------------------------------------------------------------------
# The disabled path: no state moves, values pass through untouched
# --------------------------------------------------------------------------
def test_disabled_injector_is_inert():
    inj = FaultInjector()
    assert not inj.enabled
    assert inj.poll("execute") == []
    assert inj.counters() == {}          # poll did not even count
    inj.check_devices(0, 8)              # no lost set: no-op
    y = torch.ones((2, 3))
    assert inj.perturb_output("output", y) is y
    assert inj.scale_latency(123.0) == 123.0
    assert inj.counters() == {}


def test_arming_an_empty_schedule_stays_disabled():
    inj = FaultInjector()
    inj.arm([])
    assert not inj.enabled


def test_disarm_restores_the_transparent_state():
    inj = FaultInjector()
    inj.arm([FaultSpec("nan_output", step=0)])
    inj.poll("output")
    inj.lose(1)
    inj.disarm()
    assert not inj.enabled
    assert inj.counters() == {} and inj.fired == [] and inj.lost == set()


# --------------------------------------------------------------------------
# Firing semantics
# --------------------------------------------------------------------------
def test_step_trigger_fires_on_the_nth_poll_and_retires():
    inj = FaultInjector()
    with inj.armed([FaultSpec("kernel_exception", step=2)]):
        assert inj.poll("execute") == []          # step 0
        assert inj.poll("execute") == []          # step 1
        due = inj.poll("execute")                 # step 2: fires
        assert [f.kind for f in due] == ["kernel_exception"]
        assert inj.poll("execute") == []          # once=True retired it
        assert inj.counters() == {"execute": 4}
        assert inj.fired == [("kernel_exception", "execute", 2, None)]


def test_seams_count_independently():
    inj = FaultInjector()
    with inj.armed([FaultSpec("nan_output", step=1)]):
        inj.poll("execute")                       # advances only "execute"
        assert inj.poll("output") == []           # output is at step 0
        assert [f.kind for f in inj.poll("output")] == ["nan_output"]


def test_tenant_filter():
    inj = FaultInjector()
    with inj.armed([FaultSpec("nan_output", p=1.0, tenant="a", once=False)]):
        assert inj.poll("output", "b") == []      # wrong tenant: no fire
        assert [f.kind for f in inj.poll("output", "a")] == ["nan_output"]


def test_probability_trigger_replays_under_the_seed():
    def trace(seed):
        inj = FaultInjector()
        with inj.armed([FaultSpec("nan_output", p=0.5, once=False)],
                       seed=seed):
            return [bool(inj.poll("output")) for _ in range(32)]

    a, b = trace(7), trace(7)
    assert a == b                        # same seed: identical replay
    assert any(a) and not all(a)         # and the coin actually flips
    assert trace(8) != a                 # different seed: different trace


def test_fault_injected_events_are_logged():
    EVENTS.clear()
    inj = FaultInjector()
    with inj.armed([FaultSpec("latency_spike", step=0, param=3.0)]):
        inj.scale_latency(100.0, "a")
    evs = EVENTS.recent(kind="fault.injected")
    assert len(evs) == 1
    assert evs[0]["fault"] == "latency_spike"
    assert evs[0]["seam"] == "lane" and evs[0]["tenant"] == "a"


# --------------------------------------------------------------------------
# The seam effects
# --------------------------------------------------------------------------
def test_check_devices_raises_only_on_overlap():
    inj = FaultInjector()
    with inj.armed([FaultSpec("device_loss", step=0, param=3)]):
        inj.lose(3)
        inj.check_devices(0, 3)          # slice below the corpse: fine
        with pytest.raises(DeviceLost) as ei:
            inj.check_devices(2, 4)
        assert ei.value.device == 3


def test_perturb_output_nan_vs_inf():
    inj = FaultInjector()
    with inj.armed([FaultSpec("nan_output", step=0),
                    FaultSpec("collective_corrupt", step=0)]):
        y1 = inj.perturb_output("output", torch.ones((2, 3)))
        y2 = inj.perturb_output("collective", torch.ones((2, 3)))
    assert torch.isnan(y1[0, 0]) and int(torch.isfinite(y1).sum()) == 5
    assert torch.isposinf(y2[0, 0])


def test_scale_latency_param_and_default():
    inj = FaultInjector()
    with inj.armed([FaultSpec("latency_spike", step=0, param=2.5),
                    FaultSpec("latency_spike", step=1)]):
        assert inj.scale_latency(100.0) == pytest.approx(250.0)
        assert inj.scale_latency(100.0) == pytest.approx(400.0)  # default 4x


# --------------------------------------------------------------------------
# Bit-transparency at the server: armed-but-never-firing == disarmed
# --------------------------------------------------------------------------
def _serve_wave(rng_seed=0):
    srv = AdaptiveServer(DEVICE, max_batch=2, device="cpu")
    srv.register("a", _frontend(0), (12, 12, 6))
    rng = np.random.default_rng(rng_seed)
    for _ in range(4):
        srv.submit("a", rng.normal(size=(12, 12, 6)).astype(np.float32))
    comps = srv.drain()
    return srv, sorted(comps, key=lambda c: c.rid)


def test_never_firing_schedule_is_bit_transparent():
    assert not INJECTOR.enabled          # suite hygiene: nobody left it armed
    _, base = _serve_wave()
    with INJECTOR.armed([FaultSpec(k, step=10**9) for k in FAULT_KINDS]):
        srv, armed = _serve_wave()
        polls = INJECTOR.counters()
    assert polls.get("execute", 0) > 0   # the seams really were polled
    assert len(armed) == len(base) == 4
    for b, a in zip(base, armed):
        assert a.ok and a.finished == b.finished
        assert torch.equal(a.result, b.result)
    tel = srv.telemetry()["a"]
    assert tel["guard_rejected"] == 0 and tel["degradations"] == 0


# --------------------------------------------------------------------------
# Parity with the reference, and the copy that perturb_output writes
# --------------------------------------------------------------------------
SCHEDULES = {
    "one_p": [("nan_output", dict(p=0.3, once=False))],
    "mixed": [("kernel_exception", dict(p=0.2, once=False)),
              ("budget_shrink", dict(step=3, param=0.5)),
              ("nan_output", dict(p=0.5, tenant="b")),
              ("latency_spike", dict(p=0.4, once=False, param=2.0))],
}
SEAMS = ("execute", "output", "lane")


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_p_schedule_fires_at_the_same_polls_in_both_packages(name, seed):
    """The seeded draws run in schedule order in both: one sequence of
    polls over the seams and tenants fires the same specs at the same
    polls, and ``fired`` and the counters agree."""
    specs = SCHEDULES[name]
    t_inj, j_inj = FaultInjector(), JInjector()
    t_inj.arm([FaultSpec(k, **kw) for k, kw in specs], seed=seed)
    j_inj.arm([JSpec(k, **kw) for k, kw in specs], seed=seed)
    rng = np.random.default_rng(seed)
    try:
        for _ in range(200):
            seam = SEAMS[rng.integers(len(SEAMS))]
            tenant = (None, "a", "b")[rng.integers(3)]
            got = [(s.kind, s.step, s.p, s.param)
                   for s in t_inj.poll(seam, tenant)]
            want = [(s.kind, s.step, s.p, s.param)
                    for s in j_inj.poll(seam, tenant)]
            assert got == want
        assert t_inj.fired == j_inj.fired and t_inj.fired
        assert t_inj.counters() == j_inj.counters()
    finally:
        t_inj.disarm()
        j_inj.disarm()


def test_perturb_output_writes_a_copy():
    inj = FaultInjector()
    y = torch.ones((2, 3))
    with inj.armed([FaultSpec("nan_output", step=0)]):
        z = inj.perturb_output("output", y)
    assert torch.isnan(z[0, 0]) and z.data_ptr() != y.data_ptr()
    assert torch.equal(y, torch.ones((2, 3)))   # the caller's tensor
