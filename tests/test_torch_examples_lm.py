"""The serving, mesh, recovery and LM examples of the port
(``examples_torch/``) run on the CPU (``--device cpu``) and pass their
own checks."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "serving_demo": "wall seconds judge the SLO. ✓",
    "mesh_demo": "round-trips the sharding fields bit-exactly",
    "elastic_restart": "plan-preserving restart ✓ (zero cold plans)",
    "serve_lm": "10 requests served, 12 tokens each ✓",
    "train_lm": "over 60 steps ✓",
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / f"{name}.py"),
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    assert EXAMPLES[name] in out.stdout


def test_examples_default_to_the_card(monkeypatch):
    """Without ``--device`` an example asks for CUDA, and without a card
    it raises the port's named error instead of running on the CPU."""
    import torch
    from repro_torch.models.frontends import CudaUnavailableError
    sys.path.insert(0, str(ROOT / "examples_torch"))
    try:
        import quickstart
    finally:
        sys.path.remove(str(ROOT / "examples_torch"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError):
        quickstart.main([])
