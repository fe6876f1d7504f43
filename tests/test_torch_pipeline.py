"""GPipe (``repro_torch.distributed.pipeline.gpipe_forward``) against the
reference's two cases of ``tests/test_distributed.py``, run in a
4-device reference subprocess on the same numpy-seeded inputs: values
within ``rtol=1e-5, atol=1e-6`` for ``n_micro`` 1, 5 and 6, with a
stage whose ``f(0) != 0`` (a stale fill or drain tick would inject
ones).  The port is also bitwise equal to its stages applied in
sequence, microbatch by microbatch, and computes no stale tick.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed.pipeline import gpipe_forward
from repro_torch.launch.mesh import Mesh

REPO = Path(__file__).resolve().parent.parent
N_STAGES = 4
N_MICROS = (1, 5, 6)

_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from repro.distributed.pipeline import gpipe_forward
mesh = jax.make_mesh((4,), ("pipe",))
data = np.load({path!r})
out = {{}}
scale = jax.jit(gpipe_forward(lambda w, x: x @ w, mesh, axis="pipe"))
out["scale"] = np.asarray(scale(data["eye_params"], data["x_scale"]))
affine = jax.jit(gpipe_forward(lambda w, x: x @ w + 1.0, mesh, axis="pipe"))
for m in {micros}:
    out[f"affine_{{m}}"] = np.asarray(affine(data["params"],
                                             data[f"x_{{m}}"]))
np.savez({out!r}, **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    eye = np.eye(4, dtype=np.float32)
    data = {"eye_params": np.stack([eye * (s + 1) for s in range(N_STAGES)]),
            "x_scale": np.arange(6 * 2 * 4, dtype=np.float32).reshape(
                6, 2, 4),
            "params": rng.normal(0, 0.5, (N_STAGES, 4, 4)).astype(
                np.float32)}
    for m in N_MICROS:
        data[f"x_{m}"] = rng.normal(size=(m, 2, 4)).astype(np.float32)
    return data


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpipe")
    data = _inputs()
    np.savez(d / "in.npz", **data)
    code = textwrap.dedent(_REFERENCE).format(
        path=str(d / "in.npz"), out=str(d / "out.npz"), micros=N_MICROS)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=420, env=env)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    return data, dict(np.load(d / "out.npz"))


def _pipe(n=N_STAGES):
    return Mesh(["cpu"] * n, ("pipe",))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_gpipe_pipeline_forward(reference):
    """4 stages of x @ ((s + 1) I): 24 x, as the reference."""
    data, want = reference
    fn = gpipe_forward(lambda w, x: x @ w, _pipe(), axis="pipe")
    out = fn(_t(data["eye_params"]), _t(data["x_scale"]))
    np.testing.assert_allclose(out.numpy(), data["x_scale"] * 24, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), want["scale"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n_micro", N_MICROS)
def test_gpipe_fill_drain_vs_sequential(reference, n_micro):
    data, want = reference
    calls = []

    def stage(w, x):
        calls.append(x.shape)
        return x @ w + 1.0                   # f(0) = 1 != 0

    params, x = _t(data["params"]), _t(data[f"x_{n_micro}"])
    out = gpipe_forward(stage, _pipe(), axis="pipe")(params, x)
    ref = data[f"x_{n_micro}"]
    for s in range(N_STAGES):
        ref = np.einsum("mbi,ij->mbj", ref, data["params"][s]) + 1.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), want[f"affine_{n_micro}"],
                               rtol=1e-5, atol=1e-6)
    # only the fill+drain window's real work: no stale tick computed
    assert len(calls) == n_micro * N_STAGES
    seq = torch.stack([_sequential(stage, params, x[m])
                       for m in range(n_micro)])
    assert torch.equal(out, seq)


def _sequential(stage, params, x):
    for s in range(params.shape[0]):
        x = stage(params[s], x)
    return x


@pytest.mark.parametrize("n_stages,n_micro", [(1, 3), (2, 1), (3, 7),
                                              (4, 4)])
def test_gpipe_is_bitwise_the_stages_in_sequence(n_stages, n_micro):
    """A tree of stage params (a dict), outputs in order and on the
    input's device, bitwise the sequential stages."""
    rng = np.random.default_rng(n_stages * 10 + n_micro)
    params = {"w": _t(rng.normal(size=(n_stages, 8, 8)).astype(np.float32)),
              "b": _t(rng.normal(size=(n_stages, 8)).astype(np.float32))}
    x = _t(rng.normal(size=(n_micro, 3, 8)).astype(np.float32))

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    out = gpipe_forward(stage, _pipe(n_stages))(params, x)
    assert out.shape == x.shape and out.device == x.device
    for m in range(n_micro):
        h = x[m]
        for s in range(n_stages):
            h = stage({"w": params["w"][s], "b": params["b"][s]}, h)
        assert torch.equal(out[m], h)


def test_gpipe_takes_the_pipe_axis_of_a_larger_mesh():
    mesh = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 4),
                ("data", "pipe"))
    params = torch.stack([torch.eye(2) * (s + 2) for s in range(4)])
    x = torch.ones(3, 1, 2)
    out = gpipe_forward(lambda w, h: h @ w, mesh)(params, x)
    assert torch.equal(out, x * 120)
