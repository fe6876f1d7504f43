"""The harness on the CPU at tiny sizes: sound runs are correct, each
fault planted in the timed path makes ``correct`` false, and a cell, a
configuration, a mix and a metric are taken as added files alone."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest
from conftest import ROOT, TINY_LIMITS, run_cell

CELLS = ["ladder_fused_b64_tiny.bulk_tiny", "ladder_chain_b64_tiny.bulk_tiny"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(bench_copy, workload):
    out = run_cell(bench_copy, workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(TINY_LIMITS)
    assert "setup_s" in out["metrics"]


def test_same_seed_same_sample(bench_copy):
    """One seed draws the same weights, pools, waves and sample of rounds
    (a window's length in rounds depends on the host's speed, so this is
    checked on the pieces, round by round)."""
    import torch

    from perfbench.harness import traffic
    from perfbench.harness.spec import Cell
    from perfbench.harness.window import Sampler
    cell = Cell(bench_copy, CELLS[0])

    def draw(seed):
        system = cell.system_module().System(cell.config, seed, "cpu")
        pools = system.pools(cell.traffic["pool_per_tenant"], seed)
        gen = traffic.waves(cell.traffic, traffic.rng_for(seed, 0))
        sampler = Sampler(3, traffic.rng_for(seed, 2))
        for k in range(12):
            sampler.offer(k)
        tensors = [p["w"] for t in system.params.values()
                   for p in t["blocks"]] + list(pools.values())
        return tensors, [next(gen) for _ in range(3)], sampler.kept

    a, b, c = draw(12345), draw(12345), draw(12346)
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert a[1:] == b[1:]
    assert a[1] != c[1]


# Faults planted under the timed path: the program's own answers, as the
# server returns them, altered on their way out of step().
FAULTS = {
    # one answer of every round altered where it is produced
    "altered": """
        b = batches[0]
        b.results[0] = b.results[0] + 1.0
    """,
    # half of every batch left out
    "half": """
        batches = [type(b)(b.tenant, b.rids[:len(b.rids) // 2 or 1],
                           b.results[:len(b.rids) // 2 or 1],
                           b.ok[:len(b.rids) // 2 or 1]) for b in batches]
    """,
    # a round that returns the state it had: the previous round's answers
    "stale": """
        prev = getattr(self, "_prev", None)
        self._prev = [list(b.results) for b in batches]
        if prev is not None:
            for b, old in zip(batches, prev):
                for i in range(min(len(b.results), len(old))):
                    b.results[i] = old[i]
    """,
}


def _faulty_system(root, kind):
    body = textwrap.indent(textwrap.dedent(FAULTS[kind]).strip(), " " * 8)
    (root / "perfbench" / "systems" / f"faulty_{kind}.py").write_text(
        "from pathlib import Path\n"
        "from perfbench.harness.spec import load_module\n"
        "base = load_module(Path(__file__).with_name("
        "'adaptive_cnn_server.py'), 'faulty_base')\n\n\n"
        "class System(base.System):\n"
        "    def step(self):\n"
        "        batches = super().step()\n"
        "        if not batches:\n"
        "            return batches\n"
        f"{body}\n"
        "        return batches\n")
    for name in ("ladder_fused_b64_tiny", "ladder_chain_b64_tiny"):
        p = root / "perfbench" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["system"] = f"faulty_{kind}"
        p.write_text(json.dumps(c))


@pytest.mark.parametrize("kind", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_fails_the_check(bench_copy, kind, workload):
    _faulty_system(bench_copy, kind)
    out = run_cell(bench_copy, workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_plan_below_the_pinned_rungs_fails(bench_copy, workload):
    """A planner that lowers the light tenant below the configuration's
    pin fails ``rungs``, and the reference, which follows the pin, reads
    the lowered answers as wrong."""
    cname = workload.split(".")[0]
    p = bench_copy / "perfbench" / "configs" / f"{cname}.json"
    c = json.loads(p.read_text())
    light = c["rungs"]["light"]
    for size, blocks in light.items():
        light[size] = [" ".join(w.split("@")[0].replace("lut", "act") + "@32"
                                for w in b.split()) for b in blocks]
    p.write_text(json.dumps(c))
    out = run_cell(bench_copy, workload)
    assert not out["correct"]
    assert out["checks"]["rungs"]["value"] > 0
    assert out["checks"]["light_err"]["value"] > TINY_LIMITS["light_err"]


def test_rung_words_round_trip():
    from perfbench.harness.check import pinned_plan, rung_words
    plan = [{"conv": {"member": "ip1_vpu", "bits": 8},
             "pool": {"member": "pool_vpu", "bits": 8},
             "act": {"member": "act_lut", "bits": 8}},
            {"fused": {"member": "fused_mxu", "bits": 32}}]
    words = rung_words(plan)
    assert words == ["conv@8 pool@8 lut@8", "fused@32"]
    assert rung_words(pinned_plan(words)) == words


def test_control_is_judged_and_fails(bench_copy):
    """The control's numbers go through the same judge, with the same
    limits, and come out not correct where the program's are."""
    out = run_cell(bench_copy, CELLS[1], control=True)
    assert out["correct"], out["checks"]
    assert out["control_correct"] is False, out["control"]
    assert set(out["control"]) == set(out["checks"])


def test_added_files_make_a_new_cell(bench_copy):
    """A configuration, a mix, a cell and a metric, each a new file or a
    new entry: the harness runs the cell and reports the metric, and no
    file of the benchmark is edited."""
    before = {p: p.read_bytes() for p in (bench_copy / "perfbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    cdir = bench_copy / "perfbench" / "configs"
    c = json.loads((cdir / "ladder_fused_b64_tiny.json").read_text())
    c.update(name="solo_tiny", image=[20, 20, 3],
             tenants=[dict(c["tenants"][0], name="solo")],
             limits={"solo_err": 1e-5, "solo_err_median": 1e-5,
                     "missing": 0, "rungs": 0},
             rungs={"solo": {"6": ["fused@32", "fused@32"]}})
    (cdir / "solo_tiny.json").write_text(json.dumps(c))
    tdir = bench_copy / "perfbench" / "traffic"
    (tdir / "solo_waves.json").write_text(json.dumps(
        {"loop": "closed", "wave": {"solo": 6}, "pool_per_tenant": 4,
         "warmup_rounds": 1, "sample_rounds": 3}))
    (bench_copy / "perfbench" / "metrics" / "rounds_per_s.py").write_text(
        "def read(run):\n    return len(run.window.steps) / run.seconds\n")
    bench["configs"].append({"name": "solo_tiny", "source": "tiny",
                             "file": "perfbench/configs/solo_tiny.json",
                             "reduced": [], "why": "one tenant"})
    bench["workloads"].append({"name": "solo_tiny.waves",
                               "config": "solo_tiny",
                               "traffic": "solo_waves", "chips": 1,
                               "why": "one tenant in waves"})
    bench["per_layer"].append({"name": "rounds_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving front", "moves": "setup_s",
                               "workloads": ["solo_tiny.waves"]})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, time, json; sys.path[:0] = ['.', 'src'];"
            "from perfbench.harness import cell;"
            "print(json.dumps(cell.run('.', 'solo_tiny.waves', 99, 0.5, "
            "True, 'cpu', time.perf_counter(), log=lambda m: None)))")
    res = subprocess.run([sys.executable, "-c", code], cwd=bench_copy,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["metrics"]["rounds_per_s"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_run_py_refuses_without_a_card(tmp_path):
    """No CUDA device: a non-zero exit and no result on standard output."""
    res = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "ladder_fused_b64.bulk", "--seed", str(2**31 + 3), "--seconds",
         "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_read_slice_leaves_out_what_follows_the_close():
    """Device time and idle gaps come from the events before the slice's
    close mark; the profiler runs on past it until the window is over."""
    from types import SimpleNamespace as NS

    import torch

    from perfbench.harness.profile import read_slice
    from perfbench.harness.window import SLICE_END
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, a, b, kind):
        return NS(name=name, device_type=kind,
                  time_range=NS(start=a, end=b))
    events = [ev("bench.step", 0, 400, cpu), ev("k", 100, 200, cuda),
              ev("k", 300, 350, cuda), ev(SLICE_END, 500, 500, cpu),
              ev("k", 600, 900, cuda), ev("bench.step", 550, 950, cpu)]
    out = read_slice(NS(events=lambda: events), 5e-4)
    assert out["busy_s"] == pytest.approx(150e-6)
    assert out["kernels"] == [("k", pytest.approx(1e-4)),
                              ("k", pytest.approx(5e-5))]
    assert out["idle_gaps"] == [["bench.step: python",
                                 pytest.approx(1e-4)]]
