"""The port's measurement-calibrated cost model
(``repro_torch.core.calibrate_cost``, ``repro_torch.obs.drift``) against
the reference's (``repro.core.calibrate_cost``, ``repro.obs.drift``).

Every case of the reference's ``tests/test_calibrate_cost.py`` and its
four drift cases (``tests/test_obs.py``) runs here on the same numpy
inputs through both packages.  The bars:

* fits, ``fingerprint()`` and ``key()`` bitwise equal (both fit with
  numpy ``lstsq`` in float64);
* ``to_json()`` byte-equal, and a table either package writes loads in
  the other with an equal ``key()`` and JSON;
* plans under the same fitted table (member flip, fusion flip,
  feasibility unchanged) byte-equal as ``to_json()``;
* ``fixed_network_cost`` exactly equal;
* ``collect_plan_samples(device="cpu")`` covers the same sample keys
  and axes as the reference (the measured times differ by nature);
* ``timeit_us`` calls warmup + repeat times.
"""
import json
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import calibrate_cost as j_cal
from repro.core import plan as j_plan
from repro.core import resources as j_res
from repro.models.blocks import cnn_block_site_specs as j_block_specs
from repro.models.frontends import cnn_frontend_site_specs as j_specs
from repro.models.frontends import init_cnn_frontend as j_init
from repro.obs import drift as j_drift
from repro.obs import trace as j_trace
from repro_torch.core import calibrate_cost as t_cal
from repro_torch.core import plan as t_plan
from repro_torch.core import resources as t_res
from repro_torch.models.blocks import cnn_block_site_specs as t_block_specs
from repro_torch.models.frontends import CudaUnavailableError
from repro_torch.models.frontends import cnn_frontend_site_specs as t_specs
from repro_torch.models.frontends import params_from_numpy
from repro_torch.obs import drift as t_drift
from repro_torch.obs import trace as t_trace

J = types.SimpleNamespace(cal=j_cal, plan=j_plan, res=j_res,
                          block_specs=j_block_specs, drift=j_drift,
                          events=j_trace.EVENTS)
T = types.SimpleNamespace(cal=t_cal, plan=t_plan, res=t_res,
                          block_specs=t_block_specs, drift=t_drift,
                          events=t_trace.EVENTS)


def both(fn):
    """``fn`` run on the reference's namespace, then on the port's."""
    return fn(J), fn(T)


def _fp(ns, compute=1000.0, hbm=4096, vmem=1024):
    """A footprint whose analytical axes are exactly (compute, hbm)."""
    return ns.res.Footprint(vmem_bytes=vmem, hbm_bytes=hbm, mxu_passes=0,
                            vpu_ops=100,
                            est_cycles=compute + ns.res.hbm_cycles(hbm))


def _plane_samples(a, b, c, points):
    return [(comp, hbm, 0.0, a * comp + b * hbm + c) for comp, hbm in points]


def _block_specs(ns, site="cal"):
    specs, _ = ns.block_specs((2, 16, 16, 4), (3, 3, 4, 16),
                              x_dtype="float32", site=site)
    return tuple(specs)


def _const_fit(ns, us):
    return ns.cal.AffineFit(us_per_compute_cycle=0.0, us_per_hbm_byte=0.0,
                            overhead_us=float(us), n_samples=3)


def _fit_dict(fit):
    return None if fit is None else fit.to_dict()


def _same_table(jt, tt):
    """Bitwise the same table: JSON bytes, fits, identity."""
    assert tt.to_json() == jt.to_json()
    assert {m: f.to_dict() for m, f in tt.fits.items()} == \
        {m: f.to_dict() for m, f in jt.fits.items()}
    assert _fit_dict(tt.global_fit) == _fit_dict(jt.global_fit)
    assert tt.fingerprint() == jt.fingerprint()
    assert tt.key() == jt.key()


def _clear():
    j_plan.clear_plan_cache()
    t_plan.clear_plan_cache()


# --------------------------------------------------------------------------
# Fit recovery
# --------------------------------------------------------------------------
def test_affine_fit_recovers_known_plane():
    a, b, c = 2.5e-3, 4.0e-7, 12.0
    rows = _plane_samples(a, b, c, [(100, 0), (500, 1 << 16),
                                    (2000, 1 << 20), (4000, 1 << 14)])
    jf, tf = both(lambda ns: ns.cal._affine_fit(rows))
    assert tf.to_dict() == jf.to_dict()
    assert tf.us_per_compute_cycle == pytest.approx(a, rel=1e-6)
    assert tf.us_per_hbm_byte == pytest.approx(b, rel=1e-6)
    assert tf.overhead_us == pytest.approx(c, rel=1e-6)
    assert tf.n_samples == 4


def test_affine_fit_clamps_coefficients_nonnegative():
    rows = [(100.0, 1 << 20, 0.0, 50.0), (200.0, 1 << 16, 0.0, 80.0),
            (400.0, 1 << 10, 0.0, 140.0), (800.0, 1 << 4, 0.0, 260.0)]
    jf, tf = both(lambda ns: ns.cal._affine_fit(rows))
    assert tf.to_dict() == jf.to_dict()
    assert min(tf.us_per_compute_cycle, tf.us_per_hbm_byte,
               tf.overhead_us, tf.us_per_comm_cycle) >= 0.0


def test_fit_recovery_through_table_records():
    a, b, c = 1.5e-3, 2.0e-7, 5.0

    def run(ns):
        table = ns.cal.CalibrationTable()
        for comp, hbm in [(100, 1 << 12), (1000, 1 << 16), (5000, 1 << 18)]:
            table.record("conv2d.ip1_vpu", _fp(ns, comp, hbm),
                         a * comp + b * hbm + c)
        table.fit()
        fp = _fp(ns, 3000, 1 << 15)
        return table, table.predict_us("conv2d.ip1_vpu", fp.compute_cycles,
                                       fp.hbm_bytes)

    (jt, jus), (tt, tus) = both(run)
    _same_table(jt, tt)
    assert tus == jus
    assert tus == pytest.approx(a * 3000 + b * (1 << 15) + c, rel=1e-6)


# --------------------------------------------------------------------------
# <min_samples fallback
# --------------------------------------------------------------------------
def test_sparse_member_gets_no_dedicated_fit():
    def run(ns):
        table = ns.cal.CalibrationTable()
        table.record("conv2d.ip1_vpu", _fp(ns, 100), 10.0)
        table.record("conv2d.ip1_vpu", _fp(ns, 200), 20.0)
        for comp, us in ((100, 1.0), (200, 2.0), (300, 3.0)):
            table.record("pool2d.pool_vpu", _fp(ns, comp), us)
        return table.fit()

    jt, tt = both(run)
    _same_table(jt, tt)
    assert "conv2d.ip1_vpu" not in tt.fits
    assert "pool2d.pool_vpu" in tt.fits
    assert tt.fit_for("conv2d.ip1_vpu") is tt.global_fit
    assert tt.global_fit.n_samples == 5


def test_min_samples_is_tunable():
    def run(ns):
        table = ns.cal.CalibrationTable()
        table.record("m.a", _fp(ns, 100), 10.0)
        table.record("m.a", _fp(ns, 200), 20.0)
        sparse = "m.a" in table.fit().fits
        key3 = table.key()
        dense = "m.a" in table.fit(min_samples=2).fits
        return sparse, dense, key3, table.key(), table.to_json()

    jr, tr = both(run)
    assert tr == jr
    assert tr[:2] == (False, True) and tr[2] != tr[3]


def test_unseen_member_falls_back_to_global_then_identity():
    def run(ns):
        table = ns.cal.CalibrationTable()
        fp = _fp(ns, 1000)
        identity = table.calibrated_cycles(fp, "conv2d.never_seen")
        assert identity == fp.est_cycles
        table.record("m.a", _fp(ns, 100), 7.0)
        table.fit()
        us = table.predict_us("conv2d.never_seen", fp.compute_cycles,
                              fp.hbm_bytes)
        return identity, us, table.calibrated_cycles(fp, "conv2d.never_seen")

    jr, tr = both(run)
    assert tr == jr
    assert tr[1] is not None
    assert tr[2] == pytest.approx(tr[1] * 1e-6 * t_res.CLOCK_HZ)


def test_empty_table_is_identity_everywhere():
    def run(ns):
        table = ns.cal.CalibrationTable()
        out = []
        for fp in (_fp(ns, 10), _fp(ns, 1e6, hbm=1 << 24)):
            assert table.calibrated_cycles(fp, "anything") == fp.est_cycles
            out.append(table.calibrated_cycles(fp, "anything"))
        assert table.fit_for("anything") is None
        return out

    jr, tr = both(run)
    assert tr == jr


# --------------------------------------------------------------------------
# Monotonicity + nonnegativity
# --------------------------------------------------------------------------
def test_calibrated_cost_nondecreasing_in_compute_and_hbm():
    def run(ns):
        table = ns.cal.CalibrationTable()
        for comp, hbm, us in [(100, 1 << 10, 5.0), (1000, 1 << 14, 30.0),
                              (4000, 1 << 18, 150.0)]:
            table.record("m.a", _fp(ns, comp, hbm=hbm), us)
        table.fit()
        return [table.calibrated_cycles(_fp(ns, c, hbm=h), "m.a")
                for c, h in ((500, 1 << 12), (900, 1 << 12),
                             (500, 1 << 16))]

    jr, (base, more_compute, more_hbm) = both(run)
    assert [base, more_compute, more_hbm] == jr
    assert more_compute >= base and more_hbm >= base and base >= 0.0


def test_predictions_clamped_nonnegative():
    def run(ns):
        table = ns.cal.CalibrationTable(fits={"m.a": _const_fit(ns, 0.0)})
        return (table.predict_us("m.a", 0.0, 0.0),
                table.calibrated_cycles(_fp(ns, 1), "m.a"))

    jr, tr = both(run)
    assert tr == jr == (0.0, 0.0)


# --------------------------------------------------------------------------
# member_key: lowered rungs are distinct members
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bits,native", [(None, 32), (32, 32), (8, 32),
                                         (16, 32), (8, 16), (16, 16)])
def test_member_key_suffixes_only_lowered_widths(bits, native):
    got = t_cal.member_key("conv2d.ip1_vpu", bits, native)
    assert got == j_cal.member_key("conv2d.ip1_vpu", bits, native)
    lowered = bits is not None and bits < native
    assert got == ("conv2d.ip1_vpu" + (f"@int{bits}" if lowered else ""))


def test_record_keys_lowered_variant_separately():
    def run(ns):
        table = ns.cal.CalibrationTable()
        table.record("conv2d.ip1_vpu", _fp(ns, 100), 10.0, bits=8,
                     native_bits=32)
        table.record("conv2d.ip1_vpu", _fp(ns, 100), 10.0, bits=32,
                     native_bits=32)
        return (table.sample_count("conv2d.ip1_vpu@int8"),
                table.sample_count("conv2d.ip1_vpu"), table.to_json())

    jr, tr = both(run)
    assert tr == jr
    assert tr[:2] == (1, 1)


# --------------------------------------------------------------------------
# Persistence: versioned JSON, bit-exact, across packages
# --------------------------------------------------------------------------
def _fitted_table(ns):
    table = ns.cal.CalibrationTable()
    rng = np.random.default_rng(7)
    for m in ("conv2d.ip1_vpu", "pool2d.pool_vpu",
              "cnn_fused.fused_vpu@int8"):
        for _ in range(4):
            comp = float(rng.uniform(50, 5000))
            hbm = int(rng.integers(1 << 10, 1 << 20))
            table.record(m, _fp(ns, comp, hbm=hbm),
                         float(0.001 * comp + 2e-7 * hbm + rng.uniform(1, 3)))
    return table.fit()


def test_json_round_trip_bit_exact():
    jt, tt = both(_fitted_table)
    _same_table(jt, tt)
    text = tt.to_json()
    assert t_cal.CalibrationTable.from_json(text).to_json() == text


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_table_written_by_either_package_loads_in_the_other(writer,
                                                            tmp_path):
    jt, tt = both(_fitted_table)
    src, dst = ((jt, t_cal), (tt, j_cal))[writer == "port"]
    path = tmp_path / "cal.json"
    src.save(path)
    loaded = dst.CalibrationTable.load(path)
    assert loaded.key() == src.key()
    assert loaded.to_json() == src.to_json()
    back = type(src).from_json(loaded.to_json())
    assert back == src and back.key() == src.key()


def test_schema_v1_table_loads_with_zero_comm_axis():
    d = json.loads(_fitted_table(J).to_json())
    d["version"] = 1
    for s in d["samples"]:
        del s["comm_cycles"]
    for f in list(d["fits"].values()) + [d["global_fit"]]:
        del f["us_per_comm_cycle"]
    text = json.dumps(d)
    jt, tt = both(lambda ns: ns.cal.CalibrationTable.from_json(text))
    _same_table(jt, tt)
    assert all(s.comm_cycles == 0.0 for s in tt.samples)
    assert all(f.us_per_comm_cycle == 0.0 for f in tt.fits.values())


def test_save_load_round_trip_equality_and_identity(tmp_path):
    table = _fitted_table(T)
    path = tmp_path / "cal.json"
    table.save(path)
    loaded = t_cal.CalibrationTable.load(path)
    ref = j_cal.CalibrationTable.load(path)
    assert loaded == table
    assert loaded.key() == table.key() == ref.key()
    for m in ("conv2d.ip1_vpu", "cnn_fused.fused_vpu@int8", "unseen.m"):
        assert loaded.calibrated_cycles(_fp(T, 777, hbm=1 << 13), m) \
            == table.calibrated_cycles(_fp(T, 777, hbm=1 << 13), m) \
            == ref.calibrated_cycles(_fp(J, 777, hbm=1 << 13), m)


@pytest.mark.parametrize("version", [t_cal.CALIBRATION_SCHEMA_VERSION + 1,
                                     None, 0])
def test_unknown_schema_version_rejected(version):
    d = json.loads(_fitted_table(T).to_json())
    d["version"] = version
    for ns in (J, T):
        with pytest.raises(ValueError, match="schema version") as e:
            ns.cal.CalibrationTable.from_json(json.dumps(d))
        assert str(e.value).startswith(
            f"calibration table schema version {version!r}")
    assert t_cal.CALIBRATION_SCHEMA_VERSION == \
        j_cal.CALIBRATION_SCHEMA_VERSION == 2
    assert t_cal._ACCEPTED_SCHEMA_VERSIONS == \
        j_cal._ACCEPTED_SCHEMA_VERSIONS == (1, 2)
    assert t_cal.MEASURE_REPEAT == j_cal.MEASURE_REPEAT


# --------------------------------------------------------------------------
# Identity: fits move the key, samples do not
# --------------------------------------------------------------------------
def test_recording_does_not_move_fingerprint_but_fit_does():
    def run(ns):
        table = _fitted_table(ns)
        key0 = table.key()
        table.record("conv2d.ip1_vpu", _fp(ns, 123), 99.0)
        key1 = table.key()
        table.fit()
        return key0, key1, table.key()

    jr, tr = both(run)
    assert tr == jr
    assert tr[0] == tr[1] != tr[2]


def test_tables_with_identical_fits_share_identity():
    t1, t2 = _fitted_table(T), _fitted_table(T)
    assert t1.key() == t2.key() == _fitted_table(J).key()
    assert t_cal.calibration_key(t1) == t_cal.calibration_key(t2) \
        == j_cal.calibration_key(_fitted_table(J))
    assert t_cal.calibration_key(None) is None
    assert t1.key()[0] == t_cal.CALIBRATION_SCHEMA_VERSION


# --------------------------------------------------------------------------
# Timing substrate
# --------------------------------------------------------------------------
@pytest.mark.parametrize("warmup,repeat,calls", [(2, 5, 7), (0, 1, 1),
                                                 (1, 0, 2)])
def test_timeit_us_calls_warmup_plus_repeat_and_is_positive(warmup, repeat,
                                                            calls):
    for ns in (J, T):
        seen = []
        us = ns.cal.timeit_us(lambda: seen.append(1), warmup=warmup,
                              repeat=repeat)
        assert len(seen) == calls
        assert us >= 0.0


def test_timeit_us_passes_arguments_and_blocks_on_cpu_tensors():
    got = []

    def fn(x, *, scale):
        got.append(scale)
        return {"y": [x * scale]}

    us = t_cal.timeit_us(fn, torch.ones(3), scale=2.0, warmup=1, repeat=3)
    assert got == [2.0] * 4 and us >= 0.0


# --------------------------------------------------------------------------
# Planner integration: plans byte-equal under the same table
# --------------------------------------------------------------------------
def _plan_both(specs_of, budget_kw, table_of, **kw):
    _clear()
    return both(lambda ns: ns.plan.plan_network(
        specs_of(ns), ns.res.ResourceBudget(**budget_kw),
        calibration=table_of(ns), **kw))


def test_calibration_flips_fusion_choice():
    def specs(ns):
        return _block_specs(ns, "flip")

    ja, ta = _plan_both(specs, {}, lambda ns: None, fuse=True)
    assert ta.to_json() == ja.to_json()
    assert [s.spec.family for s in ta.sites] == ["cnn_fused"]
    jp, tp = _plan_both(specs, {}, lambda ns: ns.cal.CalibrationTable(
        fits={"cnn_fused.fused_vpu": _const_fit(ns, 1e6)}), fuse=True)
    assert tp.to_json() == jp.to_json()
    assert all(s.spec.family != "cnn_fused" for s in tp.sites)
    assert len(tp.sites) == 3
    jf, tf = _plan_both(specs, {}, lambda ns: ns.cal.CalibrationTable(
        fits={"cnn_fused.fused_vpu": _const_fit(ns, 1e-3)}), fuse=True)
    assert tf.to_json() == jf.to_json()
    assert [s.spec.family for s in tf.sites] == ["cnn_fused"]


def test_calibration_flips_member_ranking():
    def specs(ns):
        return _block_specs(ns, "rank")

    jb, tb = _plan_both(specs, {}, lambda ns: None, fuse=False)
    winner = next(s.ip.name for s in tb.sites if s.spec.family == "conv2d")
    jr, tr = _plan_both(specs, {}, lambda ns: ns.cal.CalibrationTable(
        fits={winner: _const_fit(ns, 1e6)}), fuse=False)
    assert tr.to_json() == jr.to_json()
    assert next(s.ip.name for s in tr.sites
                if s.spec.family == "conv2d") != winner


def test_calibration_does_not_change_feasibility():
    def table(ns):
        return ns.cal.CalibrationTable(
            fits={"cnn_fused.fused_vpu": _const_fit(ns, 1e6),
                  "conv2d.ip1_vpu": _const_fit(ns, 1e6)})

    def specs(ns):
        return _block_specs(ns, "feas")

    assert t_plan.network_min_fraction(specs(T), t_res.ResourceBudget()) \
        == j_plan.network_min_fraction(specs(J), j_res.ResourceBudget())
    jp, tp = _plan_both(specs, {}, table)
    assert tp.to_json() == jp.to_json()
    for s in tp.sites:
        assert s.footprint.fits(t_res.ResourceBudget().scaled(s.fraction))
    for tbl in (lambda ns: None, table):
        for ns in (J, T):
            with pytest.raises(ValueError, match="no feasible IP"):
                ns.plan.plan_network(specs(ns),
                                     ns.res.ResourceBudget(vmem_bytes=1024),
                                     calibration=tbl(ns))


def test_plan_calibrated_cycles_sums_per_site_predictions():
    jp, tp = _plan_both(lambda ns: _block_specs(ns, "sum"), {},
                        lambda ns: None)
    jt, tt = both(_fitted_table)
    want = sum(
        tt.calibrated_cycles(
            s.footprint, t_cal.member_key(s.ip.name, s.precision_bits,
                                          s.spec.native_bits))
        / max(s.footprint.outputs_per_pass, 1)
        for s in tp.sites)
    assert tp.calibrated_cycles(tt) == pytest.approx(want)
    assert tp.calibrated_cycles(tt) == jp.calibrated_cycles(jt)
    assert tp.calibrated_cycles(None) == pytest.approx(tp.total_cycles)


def test_footprint_calibrated_cycles_identity_and_table_paths():
    def run(ns):
        fp = _fp(ns, 2000, hbm=1 << 16)
        table = ns.cal.CalibrationTable(fits={"m.a": _const_fit(ns, 10.0)})
        return (fp.calibrated_cycles(None, "m.a"),
                fp.calibrated_cycles(table, "m.a"), fp.compute_cycles)

    jr, tr = both(run)
    assert tr == jr
    assert tr[0] == _fp(T, 2000, hbm=1 << 16).est_cycles
    assert tr[1] == pytest.approx(10.0 * 1e-6 * t_res.CLOCK_HZ)
    assert tr[2] == pytest.approx(2000.0)


def _frontend_table(ns):
    """A table with a dedicated fit for every member the small frontend
    plans, plus members it does not (global fallback)."""
    rng = np.random.default_rng(11)
    table = ns.cal.CalibrationTable()
    members = ("conv2d.ip1_vpu", "conv2d.ip2_mxu", "pool2d.pool_vpu",
               "pool2d.pool_im2col", "activation.act_vpu",
               "activation.act_lut@int8", "cnn_fused.fused_vpu",
               "cnn_fused.fused_mxu", "conv2d.ip1_vpu@int16")
    for i, m in enumerate(members):
        for _ in range(3 + i % 2):
            comp = float(rng.uniform(1e3, 1e6))
            hbm = int(rng.integers(1 << 12, 1 << 22))
            table.record(m, _fp(ns, comp, hbm=hbm),
                         float(2e-5 * (i + 1) * comp + 3e-6 * hbm
                               + rng.uniform(5, 40)))
    return table.fit()


@pytest.fixture(scope="module")
def frontends():
    jp = j_init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


@pytest.mark.parametrize("budget", [
    {}, {"mxu_available": False}, {"vmem_bytes": 2 * 2**20},
    {"vpu_ops_budget": 50_000_000}], ids=["ample", "no_mxu", "vmem_2MiB",
                                          "vpu_capped"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_frontend_plans_under_a_fitted_table_match(frontends, budget, fuse):
    jp, tp = frontends
    ladder = (16, 8)

    def specs(ns):
        if ns is J:
            return j_specs(jp, (2, 32, 32, 3), "float32", ladder=ladder)
        return t_specs(tp, (2, 32, 32, 3), torch.float32, ladder=ladder)

    jt, tt = both(_frontend_table)
    _same_table(jt, tt)
    stats0 = [dict(vars(ns.plan.planner_stats())) for ns in (J, T)]
    jplan, tplan = _plan_both(specs, budget, lambda ns: (jt, tt)[ns is T],
                              fuse=fuse)
    assert tplan.to_json() == jplan.to_json()
    assert tplan.calibrated_cycles(tt) == jplan.calibrated_cycles(jt)
    # the replan fast path under the same table, then a refitted table
    for frac in (0.6, 0.35):
        got = [ns.plan.replan(specs(ns), ns.res.ResourceBudget(
            **budget).scaled(frac), fuse=fuse, calibration=tbl)
            for ns, tbl in ((J, jt), (T, tt))]
        assert got[1].to_json() == got[0].to_json()
    jt.record("conv2d.ip1_vpu", _fp(J, 5e5, 1 << 20), 900.0)
    tt.record("conv2d.ip1_vpu", _fp(T, 5e5, 1 << 20), 900.0)
    jt.fit()
    tt.fit()
    _same_table(jt, tt)
    got = [ns.plan.replan(specs(ns), ns.res.ResourceBudget(**budget)
                          .scaled(0.6), fuse=fuse, calibration=tbl,
                          strict=True)
           for ns, tbl in ((J, jt), (T, tt))]
    assert got[1].to_json() == got[0].to_json()
    # the same hits, misses, fast and cold replans in both planners
    deltas = [{k: v - s0[k] for k, v in vars(ns.plan.planner_stats()).items()}
              for ns, s0 in zip((J, T), stats0)]
    assert deltas[1] == deltas[0]


# --------------------------------------------------------------------------
# Sample collection against real plans (no wall-clock assertions)
# --------------------------------------------------------------------------
def _sample_axes(table):
    return [(s.family, s.member, s.compute_cycles, s.hbm_bytes,
             s.comm_cycles) for s in table.samples]


def test_collect_plan_samples_covers_distinct_sites_once():
    jplan, tplan = _plan_both(lambda ns: _block_specs(ns, "coll"), {},
                              lambda ns: None)
    want = j_cal.collect_plan_samples([jplan, jplan, None], warmup=0,
                                      repeat=1)
    got = t_cal.collect_plan_samples([tplan, tplan, None], device="cpu",
                                     warmup=0, repeat=1)
    assert _sample_axes(got) == _sample_axes(want)
    assert got.sample_count() == len(tplan.sites)
    assert {s.member for s in got.samples} == {
        t_cal.member_key(s.ip.name, s.precision_bits, s.spec.native_bits)
        for s in tplan.sites}
    by_member = {s.member: s for s in got.samples}
    for s in tplan.sites:
        rec = by_member[t_cal.member_key(s.ip.name, s.precision_bits,
                                         s.spec.native_bits)]
        assert rec.compute_cycles == pytest.approx(s.footprint.compute_cycles)
        assert rec.hbm_bytes == s.footprint.hbm_bytes
        assert rec.measured_us > 0.0


def test_collect_plan_samples_covers_lowered_and_fused_rungs(frontends):
    """A squeezed ladder plan: the lowered rungs run their quantized
    wrappers and key as ``@int<bits>``, exactly the reference's keys."""
    jp, tp = frontends
    plans = {}
    for ns, p, dt in ((J, jp, "float32"), (T, tp, torch.float32)):
        fn = j_specs if ns is J else t_specs
        out = []
        for fuse, budget in (
                (True, dict(vpu_ops_budget=300_000, vmem_bytes=65536)),
                (False, dict(vpu_ops_budget=1_000_000, vmem_bytes=65536)),
                (False, dict(vpu_ops_budget=200_000))):
            ns.plan.clear_plan_cache()
            out.append(ns.plan.plan_network(
                fn(p, (1, 20, 20, 3), dt, activation="tanh",
                   ladder=(16, 8)),
                ns.res.ResourceBudget(**budget), fuse=fuse))
        plans[ns is T] = out
    assert [p.to_json() for p in plans[True]] == \
        [p.to_json() for p in plans[False]]
    assert any(s.lowered for p in plans[True] for s in p.sites)
    want = j_cal.collect_plan_samples(plans[False], warmup=0, repeat=1)
    got = t_cal.collect_plan_samples(plans[True], device="cpu", warmup=0,
                                     repeat=1)
    assert _sample_axes(got) == _sample_axes(want)
    members = {s.member for s in got.samples}
    for m in ("cnn_fused.fused_mxu@int8", "conv2d.ip1_vpu@int16",
              "pool2d.pool_vpu@int8", "activation.act_lut@int8",
              "conv2d.ip2_mxu@int8"):
        assert m in members, (m, members)
    assert all(s.measured_us > 0.0 for s in got.samples)


@pytest.mark.parametrize("dtype", ["float32", "int8", "int16", "int32",
                                   "bfloat16"])
def test_synthetic_operands_equal_the_reference(dtype):
    shape = (2, 5, 7, 3)
    got = t_cal._synthetic(shape, dtype, np.random.default_rng(3), "cpu")
    want = np.asarray(j_cal._synthetic(shape, dtype,
                                       np.random.default_rng(3)))
    assert str(got.dtype) == f"torch.{dtype}" and tuple(got.shape) == shape
    if dtype == "bfloat16":
        # the port draws in f32 and casts: within one bf16 rounding
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32), rtol=2 ** -8)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
        if dtype != "float32":
            assert got.min() >= -128 and got.max() <= 127


def test_site_runner_dispatches_every_family_on_the_cpu():
    """Dual convs and matmul sites (full and lowered) run their wrappers;
    an unknown family is refused by name, as in the reference."""
    from repro_torch.core.ip import SiteSpec
    specs = [SiteSpec.make("d", "conv2d", ((2, 9, 9, 4), (3, 3, 4, 8)),
                           "int8", dual=True),
             SiteSpec.make("m", "matmul", ((16, 32), (32, 24)), "float32",
                           dual=False),
             SiteSpec.make("q", "matmul", ((16, 32), (32, 24)), "float32",
                           ladder=(8,), dual=False)]
    for spec, budget in zip(specs, ({"precision_bits": 8}, {},
                                    {"precision_bits": 8})):
        site = t_plan.plan_single(spec, t_res.ResourceBudget(**budget))
        y = t_cal._site_runner(site, device="cpu")()
        ys = y if isinstance(y, tuple) else (y,)
        assert all(torch.isfinite(v.float()).all() for v in ys)
        assert t_cal.measure_planned_site(site, device="cpu", warmup=0,
                                          repeat=1) > 0.0
    bad = t_plan.plan_single(specs[1], t_res.ResourceBudget())
    bad = type(bad)(**{**vars(bad), "spec": SiteSpec.make(
        "x", "ssm_scan", ((1, 8, 16),), "float32")})
    with pytest.raises(ValueError, match="no calibration runner for family "
                                         "'ssm_scan'"):
        t_cal._site_runner(bad, device="cpu")


def test_measurement_needs_the_card_unless_told_cpu(monkeypatch):
    """``device=None`` means the card: no quiet fall back to the CPU."""
    jplan, tplan = _plan_both(lambda ns: _block_specs(ns, "dev"), {},
                              lambda ns: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError, match='device="cpu"'):
        t_cal.collect_plan_samples([tplan])
    with pytest.raises(CudaUnavailableError):
        t_cal.measure_planned_site(tplan.sites[0])


# --------------------------------------------------------------------------
# Drift (the reference's tests/test_obs.py drift cases)
# --------------------------------------------------------------------------
def _drift_fp(ns, compute=1000.0, hbm=4096):
    return ns.res.Footprint(vmem_bytes=1024, hbm_bytes=hbm, mxu_passes=0,
                            vpu_ops=100,
                            est_cycles=compute + ns.res.hbm_cycles(hbm))


def _drift_table(ns, a=0.002, b=1e-6, c=5.0):
    table = ns.cal.CalibrationTable()
    for comp, hbm in ((1000.0, 4096), (2000.0, 8192), (4000.0, 2048),
                      (8000.0, 16384)):
        table.record("m", _drift_fp(ns, comp, int(hbm)),
                     a * comp + b * hbm + c)
    return table.fit(min_samples=3)


def _observe_truth(ns, mon):
    out = []
    for comp in (1500.0, 2500.0, 3500.0, 4500.0):
        fp = _drift_fp(ns, comp)
        truth = 0.002 * comp + 1e-6 * fp.hbm_bytes + 5.0
        rep = mon.observe("m", fp, truth)
        out.append(None if rep is None else rep.to_dict())
    return out


def test_drift_monitor_quiet_on_honest_table():
    def run(ns):
        mon = ns.drift.DriftMonitor(_drift_table(ns), threshold=0.5,
                                    min_observations=3)
        return _observe_truth(ns, mon), mon.snapshot()

    (jr, jsnap), (tr, tsnap) = both(run)
    assert tr == jr == [None] * 4
    assert tsnap == jsnap
    assert not tsnap["drifted"] and tsnap["mean_rel_error"] < 0.05


def test_drift_monitor_flags_mis_scaled_table_once():
    def run(ns):
        bad = ns.drift.mis_scaled_table(_drift_table(ns), 8.0)
        hits = []
        mon = ns.drift.DriftMonitor(bad, threshold=0.5, min_observations=3,
                                    on_drift=hits.append)
        reps = _observe_truth(ns, mon)
        return reps, len(hits), len(mon.reports), bad.key(), mon.snapshot()

    jr, tr = both(run)
    assert tr == jr
    reps, hits, n_reports, _, snap = tr
    assert snap["drifted"] and [r for r in reps if r] == [reps[2]]
    assert reps[2]["mean_rel_error"] > 0.5
    assert hits == n_reports == 1
    assert t_trace.EVENTS.recent(kind="calibration.drift")
    assert t_drift.DRIFT_THRESHOLD == j_drift.DRIFT_THRESHOLD
    assert t_drift.DRIFT_WINDOW == j_drift.DRIFT_WINDOW
    assert t_drift.MIN_OBSERVATIONS == j_drift.MIN_OBSERVATIONS
    assert t_drift._BUFFER_MAX == j_drift._BUFFER_MAX


def test_drift_monitor_recalibrate_rearms_and_quiets():
    def run(ns):
        bad = ns.drift.mis_scaled_table(_drift_table(ns), 8.0)
        mon = ns.drift.DriftMonitor(bad, threshold=0.5, min_observations=3)
        _observe_truth(ns, mon)
        assert mon.drifted
        before = bad.fingerprint()
        after = mon.recalibrate()
        assert after != before and not mon.drifted
        again = _observe_truth(ns, mon)
        return before, after, again, mon.drifted, bad.to_json()

    jr, tr = both(run)
    assert tr == jr
    assert tr[2] == [None] * 4 and not tr[3]
    assert t_trace.EVENTS.recent(kind="calibration.refit")


def test_drift_monitor_no_verdict_without_fit():
    def run(ns):
        mon = ns.drift.DriftMonitor(ns.cal.CalibrationTable(),
                                    threshold=0.5, min_observations=1)
        rep = mon.observe("m", _drift_fp(ns), 10.0)
        return rep, mon.predictions, mon.observations

    jr, tr = both(run)
    assert tr == jr == (None, 0, 1)
    with pytest.raises(ValueError, match="threshold must be positive"):
        t_drift.DriftMonitor(t_cal.CalibrationTable(), threshold=0.0)
