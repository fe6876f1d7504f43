"""Fixtures of the benchmark's own tests: a copy of the benchmark with tiny
cells added as files, run on the CPU by the same harness.

Run them with ``python -m pytest perfbench/tests``; the tests marked
``card`` run on a CUDA device and skip elsewhere.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# Budgets at which the 24x24 tenants keep their character: the light
# tenant lowered to int8 fused (fused) or to 16-bit convs, int8 pools and
# the LUT (chain).
TINY = {"ladder_fused_b64": {"vmem_bytes": 699050, "vpu_ops_budget": 8000000},
        "ladder_chain_b64": {"vmem_bytes": 786432,
                             "vpu_ops_budget": 8000000}}
TINY_LIMITS = {"heavy_err": 1e-5, "heavy_err_median": 1e-5,
               "light_err": 1e-3, "light_err_median": 1e-3, "missing": 0,
               "rungs": 0}
# The rungs the port's planner gives the tiny tenants at their batch
# sizes (heavy 8, light 4) under their demand grants.
TINY_RUNGS = {
    "ladder_fused_b64": {"heavy": {"8": ["fused@32", "fused@32"]},
                         "light": {"4": ["fused@8", "fused@32"]}},
    "ladder_chain_b64": {
        "heavy": {"8": ["conv@32 pool@32 act@32"] * 2},
        "light": {"4": ["conv@16 pool@8 lut@8"] * 2}}}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """Skips the test where PyTorch sees no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def add_tiny_cells(root: Path, system: str = None) -> list:
    """Adds ``<config>_tiny`` configurations (24x24 images, batch 8) and
    their bulk cells to the copy at ``root``, as files and entries only.
    Returns the new cells' names."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    names = []
    for cname, budget in TINY.items():
        c = json.loads((root / "perfbench" / "configs"
                        / f"{cname}.json").read_text())
        tiny = f"{cname}_tiny"
        c.update(name=tiny, image=[24, 24, 3], max_batch=8,
                 limits=TINY_LIMITS, rungs=TINY_RUNGS[cname], **budget)
        if system:
            c["system"] = system
        (root / "perfbench" / "configs" / f"{tiny}.json").write_text(
            json.dumps(c))
        bench["configs"].append({"name": tiny, "source": "tiny",
                                 "file": f"perfbench/configs/{tiny}.json",
                                 "reduced": [], "why": "tiny"})
        names.append(f"{tiny}.bulk_tiny")
        bench["workloads"].append(
            {"name": names[-1], "config": tiny, "traffic": "bulk_tiny",
             "chips": 1, "why": "tiny"})
    tdir = root / "perfbench" / "traffic"
    bulk = json.loads((tdir / "bulk.json").read_text())
    bulk.update(wave={"heavy": 16, "light": 4}, pool_per_tenant=8,
                warmup_rounds=2)
    (tdir / "bulk_tiny.json").write_text(json.dumps(bulk))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return names


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of ``BENCHMARK.json`` and ``perfbench/`` beside the port's
    sources, with the tiny cells added."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    add_tiny_cells(tmp_path)
    return tmp_path


def run_cell(root, workload, *, seconds=0.6, trace=False, seed=2**31 + 7,
             **kw):
    """One run of a cell on the CPU, in this process."""
    import time
    from perfbench.harness import cell
    return cell.run(root, workload, seed, seconds, trace, "cpu",
                    time.perf_counter(), log=lambda m: None, **kw)
