"""The port's watchdog and straggler monitor
(``repro_torch.runtime.fault_tolerance``): the single-device cases of
the reference's ``tests/test_fault_tolerance.py`` (watchdog firing,
stopping, re-arming; straggler threshold/EWMA flagging, rearm gating,
event emission), re-run against the port, and its elastic re-mesh
cases: ``choose_mesh_shape`` equal to the reference's for every pool of
survivors, ``elastic_remesh``'s serving form (a tuple of devices and
its axis over a slice of the pool) and its 2-D ("data", "model")
training grid (shapes equal to the reference's ``elastic_remesh`` in a
16-device subprocess; a state saved under (4, 2) restored under the
(3, 2) survivors' mesh bitwise, from the port's checkpoint and from one
the reference wrote of its 4x2-sharded state).  Then parity: one
step-time trace flags the same steps, EWMAs and hook fires in both
packages.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import torch

from repro.runtime.fault_tolerance import StragglerMonitor as JMonitor
from repro.runtime.fault_tolerance import choose_mesh_shape as j_choose
from repro_torch import configs as t_configs
from repro_torch.checkpoint import store
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.shard import degree_ladder
from repro_torch.distributed import shard_train
from repro_torch.distributed.sharding import (ShardedTensor, ShardingPolicy,
                                              device_put, state_pspecs,
                                              to_shardings)
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import api as t_api
from repro_torch.models.frontends import make_inputs
from repro_torch.obs import EVENTS
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.runtime.fault_tolerance import (StragglerMonitor, Watchdog,
                                                 choose_mesh_shape,
                                                 elastic_remesh)


def test_watchdog_fires_on_missed_beats():
    fired = []
    wd = Watchdog(timeout_s=0.05, on_timeout=lambda: fired.append(1)).start()
    deadline = time.monotonic() + 2.0
    while not fired and time.monotonic() < deadline:
        time.sleep(0.01)
    wd.stop()
    assert fired
    assert wd.fired


def test_watchdog_beats_keep_it_quiet():
    fired = []
    wd = Watchdog(timeout_s=0.2, on_timeout=lambda: fired.append(1)).start()
    for _ in range(6):
        wd.beat()
        time.sleep(0.03)
    wd.stop()
    assert not fired


def test_stopped_watchdog_never_fires_afterwards():
    """Regression: stop() must join the monitor thread, and a stopped
    watchdog must not invoke on_timeout later even though its last beat
    is long past the timeout."""
    fired = []
    wd = Watchdog(timeout_s=0.05, on_timeout=lambda: fired.append(1)).start()
    wd.beat()
    wd.stop()                      # before any timeout elapsed
    assert not wd._thread.is_alive()   # stop() joined the monitor
    time.sleep(0.2)                # well past timeout_s
    assert not fired
    assert not wd.fired


def test_watchdog_stop_from_on_timeout_callback():
    """Regression: the fire-once pattern — on_timeout calling stop() —
    must not self-join the monitor thread."""
    fired = []
    holder = {}

    def fire_once():
        fired.append(1)
        holder["wd"].stop()

    holder["wd"] = Watchdog(timeout_s=0.05, on_timeout=fire_once).start()
    deadline = time.monotonic() + 2.0
    while not fired and time.monotonic() < deadline:
        time.sleep(0.01)
    assert fired == [1]
    holder["wd"]._thread.join(timeout=1.0)     # loop exits cleanly
    assert not holder["wd"]._thread.is_alive()
    time.sleep(0.15)
    assert fired == [1]                        # and never fires again


def test_watchdog_stop_is_idempotent_and_safe_before_start():
    wd = Watchdog(timeout_s=0.05, on_timeout=lambda: None)
    wd.stop()                      # never started: no crash
    wd2 = Watchdog(timeout_s=0.05, on_timeout=lambda: None).start()
    wd2.stop()
    wd2.stop()                     # double stop: no crash


def test_straggler_monitor_flags_outliers():
    events = []
    mon = StragglerMonitor(threshold=2.0, warmup=2,
                           on_straggler=events.append)
    for step in range(5):
        mon.record(step, 1.0)
    ev = mon.record(5, 5.0)
    assert ev is not None and ev.ratio > 2.0
    assert events == [ev]
    # the outlier must not poison the EWMA
    assert mon.ewma < 1.5


def test_straggler_quiet_during_warmup_and_below_threshold():
    mon = StragglerMonitor(threshold=2.0, warmup=3)
    assert mon.record(0, 10.0) is None       # first sample seeds the EWMA
    assert mon.record(1, 19.0) is None       # warmup: never flagged
    for step in range(2, 8):
        assert mon.record(step, 1.9) is None  # 1.9x < threshold 2.0x
    assert mon.events == []
    assert mon.hook_fires == 0


def test_straggler_ewma_tracks_drift_not_spikes():
    """A slow *trend* raises the EWMA baseline so later equal steps stop
    flagging; a one-off spike is flagged but excluded from the fold."""
    mon = StragglerMonitor(threshold=2.0, alpha=0.5, warmup=2)
    for step in range(4):
        mon.record(step, 1.0)
    spike = mon.record(4, 3.0)
    assert spike is not None and spike.ratio == pytest.approx(3.0)
    assert mon.ewma == pytest.approx(1.0)    # spike did not poison it
    for step in range(5, 10):
        mon.record(step, 1.8)                # sustained drift folds in
    assert mon.ewma > 1.6
    assert mon.record(10, 1.8) is None       # new normal, not a straggler


def test_straggler_rearm_gates_hook_but_records_every_flag():
    hook = []
    mon = StragglerMonitor(threshold=2.0, warmup=2, rearm=2,
                           on_straggler=hook.append)
    for step in range(4):
        mon.record(step, 1.0)
    mon.record(4, 5.0)                       # fires + arms suppression
    mon.record(5, 5.0)                       # flagged, hook suppressed
    assert len(mon.events) == 2 and len(hook) == 1
    assert mon.hook_fires == 1
    mon.record(6, 1.0)                       # 2 normal steps re-arm...
    mon.record(7, 1.0)
    mon.record(8, 5.0)                       # ...so this fires again
    assert len(hook) == 2 and mon.hook_fires == 2
    assert len(mon.events) == 3              # every flag recorded


def test_straggler_flags_are_logged_as_events():
    EVENTS.clear()
    mon = StragglerMonitor(threshold=2.0, warmup=2, rearm=1)
    for step in range(4):
        mon.record(step, 1.0)
    mon.record(4, 5.0)
    mon.record(5, 5.0)                       # suppressed flag still logs
    evs = EVENTS.recent(kind="straggler.flagged")
    assert len(evs) == 2
    assert evs[0]["suppressed"] is False
    assert evs[1]["suppressed"] is True
    assert evs[0]["ratio"] == pytest.approx(5.0)


def test_straggler_rearm_validation():
    with pytest.raises(ValueError):
        StragglerMonitor(rearm=-1)


def test_watchdog_rearm_clears_the_latch_and_fires_again():
    """Regression: ``fired`` latches after the first timeout, so without
    ``rearm()`` a recovered deployment could never tell a SECOND hang
    from the stale flag."""
    fired = []
    wd = Watchdog(timeout_s=0.05, on_timeout=lambda: fired.append(1)).start()
    deadline = time.monotonic() + 2.0
    while not fired and time.monotonic() < deadline:
        time.sleep(0.01)
    assert fired and wd.fired
    wd.rearm()
    assert not wd.fired                  # latch cleared...
    assert wd._thread.is_alive()         # ...without touching the thread
    n = len(fired)
    deadline = time.monotonic() + 2.0
    while len(fired) <= n and time.monotonic() < deadline:
        time.sleep(0.01)
    wd.stop()
    assert len(fired) > n and wd.fired   # a second silence fires again


def test_watchdog_rearm_restarts_the_beat_window():
    """rearm() must also reset the beat clock: re-arming an idle
    watchdog whose last beat is ancient must not fire instantly."""
    fired = []
    wd = Watchdog(timeout_s=0.2, on_timeout=lambda: fired.append(1))
    wd._last_beat = time.monotonic() - 10.0   # stale beat from a past life
    wd.rearm()
    wd.start()
    time.sleep(0.05)                     # well inside the fresh window
    wd.stop()
    assert not fired


@pytest.mark.parametrize("rearm", [0, 2])
@pytest.mark.parametrize("seed", [0, 3])
def test_straggler_monitor_equals_the_reference(seed, rearm):
    rng = np.random.default_rng(seed)
    times = rng.lognormal(mean=0.0, sigma=0.6, size=120).tolist()
    fires = {"t": 0, "j": 0}
    t = StragglerMonitor(threshold=1.8, alpha=0.2, warmup=4, rearm=rearm,
                         on_straggler=lambda e: fires.__setitem__(
                             "t", fires["t"] + 1))
    j = JMonitor(threshold=1.8, alpha=0.2, warmup=4, rearm=rearm,
                 on_straggler=lambda e: fires.__setitem__(
                     "j", fires["j"] + 1))
    for step, dt in enumerate(times):
        a, b = t.record(step, dt), j.record(step, dt)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.step, a.step_time, a.ewma, a.ratio) == \
                (b.step, b.step_time, b.ewma, b.ratio)
        assert t.ewma == j.ewma
    assert t.events and len(t.events) == len(j.events)
    assert t.hook_fires == j.hook_fires and fires["t"] == fires["j"]


def test_choose_mesh_shape_prefers_model_divisors():
    assert choose_mesh_shape(16, prefer_model=16) == (1, 16)
    assert choose_mesh_shape(12, prefer_model=16) == (3, 4)
    assert choose_mesh_shape(3, prefer_model=16) == (3, 1)


def test_choose_mesh_shape_walks_the_degree_ladder():
    for n_dev in range(1, 20):
        data, model = choose_mesh_shape(n_dev, prefer_model=16)
        assert model in degree_ladder(16)
        assert data * model <= n_dev


def test_choose_mesh_shape_equals_the_reference():
    for prefer in (1, 2, 3, 4, 6, 8, 12, 16):
        for n_dev in range(1, 33):
            for min_model in (1, 2, 4):
                assert choose_mesh_shape(n_dev, prefer_model=prefer,
                                         min_model=min_model) == \
                    j_choose(n_dev, prefer_model=prefer, min_model=min_model)


def test_elastic_remesh_axis_mode_builds_a_1d_serving_mesh():
    pool = ["cpu", "cpu", "cpu"]
    devs, axis = elastic_remesh(1, axis="batch", offset=0, pool=pool)
    assert axis == "batch" and devs == (torch.device("cpu"),)
    devs, _ = elastic_remesh(2, axis="shard", offset=1, pool=pool)
    assert devs == (torch.device("cpu"),) * 2


def test_elastic_remesh_axis_mode_refuses_short_pools():
    with pytest.raises(ValueError, match="mesh wants devices"):
        elastic_remesh(64, axis="batch", pool=["cpu"] * 4)
    with pytest.raises(ValueError, match=r"\[3, 5\)"):
        elastic_remesh(2, axis="batch", offset=3, pool=["cpu"] * 4)
    mesh = elastic_remesh(4, pool=["cpu"] * 4)
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == j_choose(4)


# ---------------------------------------------------------------------------
# The 2-D training grid and the elastic restore
# ---------------------------------------------------------------------------
REPO = Path(__file__).resolve().parent.parent
PREFER = (1, 2, 4, 16)

_REFERENCE_SHAPES = """
import json
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
from repro.runtime.fault_tolerance import elastic_remesh
print("SHAPES" + json.dumps({f"{n}|{p}": list(elastic_remesh(
    n, prefer_model=p).devices.shape) for n in range(1, 17)
    for p in %r}))
""" % (PREFER,)

_REFERENCE_SAVE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.checkpoint import store
from repro.configs import get_config
from repro.distributed.sharding import (ShardingPolicy, state_pspecs,
                                        to_shardings)
from repro.models import api
from repro.optim.adamw import AdamWConfig
cfg = get_config("olmo-1b", smoke=True)
state = api.init_train_state(cfg, AdamWConfig(), jax.random.PRNGKey(0))
mesh = jax.make_mesh((4, 2), ("data", "model"))
st = jax.device_put(state, to_shardings(
    mesh, state_pspecs(cfg, mesh, state, ShardingPolicy())))
assert len(st.params["embed"].sharding.device_set) == 8
store.save(sys.argv[1], 3, st, extra={"next_step": 4})
"""


def _reference(code, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", code, *args],
                         capture_output=True, text=True, timeout=420, env=env)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    return run.stdout


@pytest.fixture(scope="module")
def reference_shapes():
    out = _reference(_REFERENCE_SHAPES)
    line = [ln for ln in out.splitlines() if ln.startswith("SHAPES")][-1]
    return json.loads(line[len("SHAPES"):])


@pytest.mark.parametrize("prefer", PREFER)
def test_elastic_remesh_grid_equals_the_references(reference_shapes, prefer):
    pool = [f"cuda:{i}" for i in range(16)]   # named, never touched
    for n in range(1, 17):
        mesh = elastic_remesh(n, prefer_model=prefer, pool=pool)
        assert isinstance(mesh, Mesh) and mesh.axis_names == ("data",
                                                              "model")
        assert list(mesh.devices.shape) == reference_shapes[f"{n}|{prefer}"]
        size = mesh.devices.size
        assert [str(d) for d in mesh.devices.flat] == pool[:size]


def test_elastic_remesh_grid_refuses_short_pools():
    with pytest.raises(ValueError, match="only 2 exist"):
        elastic_remesh(4, pool=["cpu"] * 2)


def _olmo():
    cfg = t_configs.get_config("olmo-1b", smoke=True)
    return cfg, AdamWConfig()


def _place(cfg, mesh, state):
    return device_put(state, to_shardings(
        mesh, state_pspecs(cfg, mesh, state, ShardingPolicy())))


def _restore_on_survivors(cfg, opt, ckpt):
    mesh = elastic_remesh(6, prefer_model=2, pool=["cpu"] * 8)
    assert mesh.devices.shape == (3, 2) and mesh.devices.size == 6
    target = t_api.init_train_state_abstract(cfg, opt)
    got, extra = store.restore(ckpt, target, shardings=to_shardings(
        mesh, state_pspecs(cfg, mesh, target, ShardingPolicy())))
    for leaf in tree_leaves(got):
        assert isinstance(leaf, ShardedTensor)
        assert leaf.sharding.mesh is mesh
    return mesh, got, extra


def test_elastic_restore_reshards_4x2_onto_3x2(tmp_path):
    """Save under a 4x2 mesh, restore under the 3x2 mesh of 6 survivors:
    every leaf bitwise, ``next_step`` kept; the restored state steps."""
    cfg, opt = _olmo()
    state = t_api.init_train_state(cfg, opt, 0, device="cpu")
    st1 = _place(cfg, make_host_mesh(4, 2, devices=["cpu"] * 8), state)
    store.save(str(tmp_path), 3, st1, extra={"next_step": 4})
    mesh, got, extra = _restore_on_survivors(cfg, opt, str(tmp_path))
    assert extra["next_step"] == 4
    for a, b in zip(tree_leaves(st1), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a.full(), b.full())
    batch = make_inputs(cfg, ShapeConfig("t", 16, 6, "train"),
                        abstract=False, device="cpu")
    _, metrics = shard_train.train_step(
        cfg, AdamWConfig(warmup_steps=2, total_steps=4), got, batch)
    assert torch.isfinite(metrics["loss"])
    assert int(got.opt.step.full()) == 1


def test_a_reference_sharded_checkpoint_restores_into_port_shardings(
        tmp_path):
    """The reference saves its 4x2-sharded state; the port restores it
    into the (3, 2) survivors' shardings, bitwise."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models import api as j_api
    from repro.optim.adamw import AdamWConfig as JAdamW
    _reference(_REFERENCE_SAVE, str(tmp_path))
    cfg, opt = _olmo()
    _, got, extra = _restore_on_survivors(cfg, opt, str(tmp_path))
    assert extra == {"next_step": 4}
    want = j_api.init_train_state(j_get_config("olmo-1b", smoke=True),
                                  JAdamW(), jax.random.PRNGKey(0))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want))
    got = tree_leaves(got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.dtype == getattr(torch, str(w.dtype))
        np.testing.assert_array_equal(g.full().numpy(), w)
