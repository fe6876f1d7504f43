"""The port's trainer (``python -m repro_torch.launch.train``)
on the CPU: the reference's three ``test_integration`` training cases
re-run against it (``--device cpu``), and a checkpoint of a reference
``TrainState`` restored by the port's ``checkpoint.store``."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as j_store
from repro.configs import get_config as j_get_config
from repro.models import api as j_api
from repro.optim.adamw import AdamWConfig as JAdamW
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.launch import train as t_train
from repro_torch.models import api, transformer
from repro_torch.models.frontends import CudaUnavailableError
from repro_torch.optim.adamw import AdamWConfig, tree_leaves

REPO = Path(__file__).resolve().parent.parent


def _run(args, timeout=600, check=True):
    env = dict(os.environ,
               PYTHONPATH=str(REPO / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--device", "cpu"] + args, capture_output=True,
                         text=True, timeout=timeout, env=env)
    if check:
        assert out.returncode == 0, \
            f"rc={out.returncode}\nSTDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return out


def _losses(stdout):
    return [float(line.split("loss")[1].split()[0])
            for line in stdout.splitlines() if line.startswith("[train] step")]


def test_train_loss_decreases(tmp_path):
    out = _run(["--arch", "llama3.2-1b", "--smoke", "--steps", "30",
                "--batch", "8", "--seq", "64", "--lr", "1e-2",
                "--ckpt-dir", str(tmp_path / "ck")])
    losses = _losses(out.stdout)
    assert losses[-1] < losses[0] - 0.5, out.stdout


def test_failure_restart_resumes_exactly(tmp_path):
    """Crash at step 25, relaunch: the resumed run continues from the
    checkpoint of step 20 and finishes."""
    ck = str(tmp_path / "ck")
    common = ["--arch", "olmo-1b", "--smoke", "--steps", "40", "--batch",
              "4", "--seq", "32", "--ckpt-every", "10", "--ckpt-dir", ck]
    out1 = _run(common + ["--simulate-failure", "25"], check=False)
    assert out1.returncode == 17, out1.stdout + out1.stderr
    assert "FAILURE" in out1.stdout
    out2 = _run(common)
    assert "restored step" in out2.stdout
    assert "resuming at 21" in out2.stdout, out2.stdout
    assert "done" in out2.stdout


def test_uninterrupted_equals_restarted(tmp_path):
    """Gold run and crash + resume reach the same final loss: within
    the reference test's 2e-2, and here bitwise (the step and the data
    are deterministic on the CPU)."""
    base = ["--arch", "llama3.2-1b", "--smoke", "--steps", "24", "--batch",
            "4", "--seq", "32", "--ckpt-every", "8"]
    gold = _run(base + ["--ckpt-dir", str(tmp_path / "a")])
    crash = _run(base + ["--ckpt-dir", str(tmp_path / "b"),
                         "--simulate-failure", "18"], check=False)
    assert crash.returncode == 17
    resumed = _run(base + ["--ckpt-dir", str(tmp_path / "b")])
    assert "resuming at 17" in resumed.stdout
    g, r = _losses(gold.stdout)[-1], _losses(resumed.stdout)[-1]
    assert abs(g - r) < 2e-2, (gold.stdout, resumed.stdout)
    assert g == r


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    jc = j_get_config("jamba-1.5-large-398b", smoke=True)
    tc = get_config("jamba-1.5-large-398b", smoke=True)
    opt = JAdamW(warmup_steps=2, total_steps=10)
    state = j_api.init_train_state(jc, opt, jax.random.PRNGKey(3))
    state = state._replace(opt=state.opt._replace(step=jax.numpy.int32(5)))
    j_store.save(str(tmp_path), 5, state, extra={"next_step": 6})
    target = api.init_train_state_abstract(
        tc, AdamWConfig(warmup_steps=2, total_steps=10))
    got, extra = store.restore(str(tmp_path), target, device="cpu")
    assert extra == {"next_step": 6}
    assert isinstance(got, api.TrainState)
    want = transformer.train_state_from_numpy(
        jax.tree.map(np.asarray, state), "cpu")
    for w, g in zip(tree_leaves(want), tree_leaves(got)):
        assert g.dtype == w.dtype and g.device.type == "cpu"
        assert torch.equal(g, w)
    assert int(got.opt.step) == 5


def test_the_port_trains_on_from_a_reference_checkpoint(tmp_path):
    """A reference-written state in the trainer's checkpoint directory is
    resumed at its ``next_step``."""
    jc = j_get_config("llama3.2-1b", smoke=True)
    opt = JAdamW(warmup_steps=2, total_steps=6)
    state = j_api.init_train_state(jc, opt, jax.random.PRNGKey(0))
    ck = tmp_path / "ck"
    j_store.save(str(ck), 3, state, extra={"next_step": 4})
    out = _run(["--arch", "llama3.2-1b", "--smoke", "--steps", "6",
                "--batch", "2", "--seq", "16", "--ckpt-dir", str(ck),
                "--log-every", "1"])
    assert "restored step 3 -> resuming at 4" in out.stdout
    assert len(_losses(out.stdout)) == 2


def test_the_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError, match='device="cpu"'):
        t_train.train(["--arch", "llama3.2-1b", "--smoke", "--ckpt-dir",
                       str(tmp_path)])


def test_a_finished_run_relaunched_trains_nothing(tmp_path):
    args = ["--arch", "llama3.2-1b", "--smoke", "--steps", "3", "--batch",
            "2", "--seq", "16", "--log-every", "1", "--ckpt-dir",
            str(tmp_path / "ck")]
    assert len(_losses(_run(args).stdout)) == 3
    again = _run(args)
    assert "restored step 2 -> resuming at 3" in again.stdout
    assert "nothing to train: resumed at step 3 of 3" in again.stdout
    assert _losses(again.stdout) == []
    assert store.latest_step(str(tmp_path / "ck")) == 2


def test_without_a_ckpt_dir_each_run_starts_afresh(monkeypatch, tmp_path):
    """No ``--ckpt-dir``: each run checkpoints into a new temporary
    directory and so never resumes another's state."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = ["--arch", "llama3.2-1b", "--smoke", "--steps", "2", "--batch",
            "2", "--seq", "16", "--device", "cpu"]
    first, second = t_train.train(args), t_train.train(args)
    assert len(first) == len(second) == 2 and first == second
    dirs = sorted(tmp_path.glob("repro_ckpt_*"))
    assert len(dirs) == 2
    assert [store.latest_step(str(d)) for d in dirs] == [1, 1]
