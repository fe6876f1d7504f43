"""The import guard compares whole top-level names."""
from __future__ import annotations

import subprocess
import sys

from conftest import ROOT

from perfbench.harness.guard import forbidden_modules


def test_names_compared_whole():
    assert forbidden_modules(["repro_torch", "repro_torch.core.plan",
                              "reprox", "jaxtyping"]) == []
    assert forbidden_modules(["repro", "repro.core", "jax.numpy", "flax",
                              "jaxlib.xla_client"]) == [
        "flax", "jax.numpy", "jaxlib.xla_client", "repro", "repro.core"]


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_the_port_passes():
    res = _run("import sys; sys.path[:0] = ['.', 'src'];"
               "import repro_torch.runtime.server, repro_torch.quant.ops;"
               "import perfbench.harness.cell;"
               "from perfbench.harness.guard import forbidden_modules;"
               "print(forbidden_modules())")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_a_stub_repro_fails_a_run(bench_copy):
    """A run whose process holds a module named ``repro`` once the window
    has closed exits with the names and prints no result."""
    code = ("import sys, time, types; sys.path[:0] = ['.', 'src'];"
            "sys.modules['repro'] = types.ModuleType('repro');"
            "from perfbench.harness import cell;"
            "out = cell.run('.', 'ladder_fused_b64_tiny.bulk_tiny', 5, 0.3,"
            " False, 'cpu', time.perf_counter(), log=lambda m: None);"
            "print(out)")
    res = subprocess.run([sys.executable, "-c", code], cwd=bench_copy,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "repro" in res.stderr
    assert res.stdout.strip() == ""
