"""The port's metrics registry (``repro_torch.obs.metrics``) against the
reference's (``repro.obs.metrics``).

The reference's ``tests/test_metrics_properties.py`` (real
``hypothesis`` when installed, else the deterministic fallback shim that
``conftest.py`` installs) and the registry and ``system_metrics`` cases
of ``tests/test_obs.py``, re-run against the port; then the same
registry operations in both packages render the same text, and after the
same served trace the tenant, arbiter and scheduler lines of
``system_metrics(...).render()`` are byte-equal (the default namespace
is the reference's, ``"repro"``).  The planner, event-log and tracer
lines count process-wide singletons of each package, so they are held
only within the port.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.metrics import system_metrics as j_system_metrics
from repro_torch.core.plan import clear_plan_cache
from repro_torch.core.resources import ResourceBudget
from repro_torch.models.frontends import init_cnn_frontend
from repro_torch.obs import (EVENTS, TRACER, Histogram, MetricsRegistry,
                             log_event, percentile, system_metrics)
from repro_torch.runtime import AdaptiveServer
from repro_torch.runtime.telemetry import TenantTelemetry
from test_torch_scheduler import make_parity_params, parity_runs

_VALUES = st.lists(st.floats(min_value=-1e6, max_value=1e6),
                   min_size=1, max_size=40)
_Q = st.floats(min_value=0.0, max_value=100.0)


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts and ends with the tracer off and the event log
    empty — the singletons must not leak across tests."""
    TRACER.disable()
    TRACER.clear()
    EVENTS.clear()
    yield
    TRACER.disable()
    TRACER.clear()
    EVENTS.clear()


# --------------------------------------------------------------------------
# The reference's tests/test_metrics_properties.py, against the port
# --------------------------------------------------------------------------
@settings(max_examples=50)
@given(xs=_VALUES, q=_Q)
def test_percentile_within_data_range(xs, q):
    p = percentile(xs, q)
    assert min(xs) <= p <= max(xs)


@settings(max_examples=50)
@given(xs=_VALUES, q1=_Q, q2=_Q)
def test_percentile_monotone_in_q(xs, q1, q2):
    lo, hi = sorted((q1, q2))
    assert percentile(xs, lo) <= percentile(xs, hi)


@settings(max_examples=50)
@given(xs=_VALUES)
def test_percentile_endpoints_are_min_and_max(xs):
    assert percentile(xs, 0) == pytest.approx(min(xs))
    assert percentile(xs, 100) == pytest.approx(max(xs))


@settings(max_examples=50)
@given(xs=_VALUES, q=_Q)
def test_percentile_matches_numpy_linear(xs, q):
    want = float(np.percentile(np.asarray(xs, dtype=np.float64), q,
                               method="linear"))
    assert percentile(xs, q) == pytest.approx(want, rel=1e-9, abs=1e-6)


@settings(max_examples=50)
@given(xs=_VALUES, q=_Q)
def test_percentile_invariant_to_input_order(xs, q):
    assert percentile(xs, q) == percentile(list(reversed(xs)), q)


@settings(max_examples=50)
@given(xs=_VALUES, q=_Q)
def test_telemetry_and_histogram_agree_with_estimator(xs, q):
    tel = TenantTelemetry(name="t", max_batch=4)
    tel.latencies.extend(xs)
    hist = Histogram()
    hist.observe_many(xs)
    want = percentile(xs, q)
    assert tel.latency_percentile(q) == pytest.approx(want)
    assert hist.quantile(q / 100.0) == pytest.approx(want)


def test_percentile_edge_cases():
    assert percentile([], 50) == 0.0
    assert percentile([7.0], 99) == 7.0
    assert percentile([1.0, 2.0], -5) == 1.0
    assert percentile([1.0, 2.0], 200) == 2.0


# --------------------------------------------------------------------------
# The registry and system_metrics cases of tests/test_obs.py
# --------------------------------------------------------------------------
def test_registry_counter_gauge_histogram_and_render():
    reg = MetricsRegistry(namespace="t")
    reg.counter("reqs", "served requests", tenant="a").inc(3)
    reg.gauge("depth").set(2.5)
    h = reg.histogram("lat", "latency")
    h.observe_many([1.0, 2.0, 3.0, 4.0])
    snap = reg.snapshot()
    assert snap["reqs"][0]["value"] == 3
    assert snap["lat"][0]["count"] == 4
    text = reg.render()
    assert "# TYPE t_reqs counter" in text
    assert 't_reqs{tenant="a"} 3' in text
    assert "# TYPE t_lat summary" in text
    assert "t_lat_count 4" in text
    assert 't_lat{quantile="0.5"} 2.5' in text


def test_registry_is_idempotent_but_kind_conflicts_raise():
    reg = MetricsRegistry()
    c = reg.counter("x")
    assert reg.counter("x") is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x")


def test_registry_labels_may_shadow_registration_args():
    reg = MetricsRegistry(namespace="t")
    reg.counter("events", "event-log entries",
                kind="watchdog.timeout", name="n", help_="h").inc(2)
    text = reg.render()
    assert 'kind="watchdog.timeout"' in text and 'name="n"' in text


def test_system_metrics_counts_logged_events_by_kind():
    log_event("watchdog.timeout", timeout_s=0.1)
    log_event("watchdog.timeout", timeout_s=0.2)
    text = system_metrics().render()
    assert 'repro_events_total{kind="watchdog.timeout"} 2' in text


def test_counter_rejects_negative_increment():
    reg = MetricsRegistry()
    with pytest.raises(ValueError, match="only go up"):
        reg.counter("c").inc(-1)


def test_system_metrics_includes_tenant_shard_columns():
    clear_plan_cache()
    srv = AdaptiveServer(ResourceBudget(), max_batch=2, device="cpu")
    srv.register("t", init_cnn_frontend(0, channels=(6, 12), d_model=16,
                                        device="cpu"), (12, 12, 6))
    rng = np.random.default_rng(0)
    srv.submit("t", rng.normal(size=(12, 12, 6)).astype(np.float32))
    srv.drain()
    text = srv.metrics().render()
    assert 'repro_tenant_shard_degree{tenant="t"} 1' in text
    assert 'repro_tenant_comm_cycles_share{tenant="t"} 0' in text
    assert 'repro_tenant_requests_total{tenant="t"} 1' in text
    assert srv.queue_stats()["popped_requests"] == 1


# --------------------------------------------------------------------------
# Same operations, same text as the reference
# --------------------------------------------------------------------------
def _fill(reg, rng):
    """A seeded mix of every metric kind, labels with characters the
    exposition escapes, and a histogram past its window."""
    for i in range(5):
        reg.counter("reqs_total", "served requests",
                    tenant=f"t{i % 2}").inc(float(rng.integers(0, 9)))
        reg.gauge("depth", 'queue "depth"\nnow', tenant="a\\b").set(
            float(rng.normal()))
    reg.gauge("up").inc(3.0)
    reg.gauge("up").dec(0.5)
    reg.histogram("lat", "latency", window=16, tenant="t0").observe_many(
        rng.exponential(size=40).tolist())
    reg.histogram("empty")
    return reg


@pytest.mark.parametrize("namespace", ["repro", "svc"])
def test_registry_text_and_snapshot_equal_reference(namespace):
    got = _fill(MetricsRegistry(namespace), np.random.default_rng(3))
    want = _fill(JRegistry(namespace), np.random.default_rng(3))
    assert got.render() == want.render()
    assert got.snapshot() == want.snapshot()


def _shared_lines(text):
    """The lines of one server's or scheduler's own state."""
    return [line for line in text.splitlines()
            if any(f"repro_{p}" in line for p in
                   ("tenant_", "scheduler_", "arbiter_", "server_"))]


@pytest.mark.parametrize("scenario", ["preempt", "shed", "miss"])
def test_system_metrics_render_equals_reference(scenario):
    runs = parity_runs(make_parity_params(), scenario, 2.0, 1 / 16)
    (jsrv, jsched, _), (tsrv, tsched, _) = runs["reference"], runs["port"]
    want = j_system_metrics(scheduler=jsched).render()
    got = tsched.metrics().render()
    assert _shared_lines(got) == _shared_lines(want)
    assert 'repro_scheduler_preemptions_total 1' in got
    assert _shared_lines(tsrv.metrics().render()) == \
        _shared_lines(jsrv.metrics().render())
    assert system_metrics(scheduler=tsched).render() == got
    reg = MetricsRegistry()
    assert tsched.metrics(registry=reg) is reg
    for line in ("repro_planner_plan_hits_total", "repro_plan_cache_size",
                 "repro_tracer_enabled 0"):
        assert line in got


def test_packages_export_the_registry_and_the_scheduler():
    from repro_torch.obs import DriftMonitor, MetricsRegistry as M
    from repro_torch.runtime import SLOScheduler, SLOSpec, TenantShare
    assert M is MetricsRegistry
    assert DriftMonitor.__module__ == "repro_torch.obs.drift"
    assert SLOScheduler.__module__ == "repro_torch.runtime.scheduler"
    assert SLOSpec(deadline_s=1.0).priority == 0
    assert TenantShare.__module__ == "repro_torch.runtime.arbiter"
