"""The CNN-side examples of the port (``examples_torch/``) run on the CPU
(``--device cpu``: the kernels' plain versions) and pass their own
checks; ``budget_sweep``'s plan table is the reference example's, byte
for byte."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "quickstart": "all budgets produced IDENTICAL outputs",
    "cnn_pipeline": "ladder made the block fit",
    "budget_sweep": "budgets' conv members gave IDENTICAL outputs ✓",
    "calibration_demo": "the same outputs under both cost models (max "
                        "|diff| 0.0e+00",
    "observability_demo": "refit without replanning by hand",
}


def run_example(path: Path, *args, jax: bool = False) -> str:
    # one thread a process: the timed demos measure single calls, and
    # test workers share the host's cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, str(path), *args], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    return out.stdout


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    out = run_example(ROOT / "examples_torch" / f"{name}.py",
                      "--device", "cpu")
    assert EXAMPLES[name] in out


def _plan_table(text: str) -> str:
    """From the arch line through the closing note."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("arch for LM sites"))
    end = next(i for i, ln in enumerate(lines) if ln.startswith("Note:"))
    return "\n".join(lines[start:end + 1])


def test_budget_sweep_table_equals_the_reference_example():
    got = run_example(ROOT / "examples_torch" / "budget_sweep.py",
                      "--device", "cpu")
    want = run_example(ROOT / "examples" / "budget_sweep.py", jax=True)
    assert _plan_table(got) == _plan_table(want)
    assert _plan_table(got).count("\n") >= 10
