"""One run of one cell: set up, warm up, measure, check, report."""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from perfbench.harness import check, traffic
from perfbench.harness.guard import forbidden_modules
from perfbench.harness.spec import Cell
from perfbench.harness.window import (NO_ANNOTATION, Clock, Sampler, Slice,
                                      Window, closed_loop, warm_closed)
from perfbench.roofline import frontend_flops, peaks_for

# The profiled slice of a traced run: the window's last second (a third
# of a shorter window), a short stretch of the steady state.
SLICE_S = 1.0


@dataclass
class Run:
    """What a run measured, for the metrics' readers."""

    cell: Cell
    system: object
    window: Window
    clock: Clock
    setup_s: float
    done_s: List[float]
    before: dict
    after: dict
    device_name: str
    spans: List[dict] = field(default_factory=list)
    trace: Optional[dict] = None
    slice_plans: List[tuple] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)
    _plans: Dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.window.seconds

    def plan(self, tenant: str, size: int, grant: float):
        key = (tenant, size, grant)
        if key not in self._plans:
            self._plans[key] = self.system.plan(tenant, size, grant)
        return self._plans[key]

    def images_done_in_window(self) -> float:
        """Answers of the rounds done by the window's end, and of the
        round that straddles it the share of its device time (since the
        round before it was done) that falls inside the window."""
        n, prev = 0.0, 0.0
        for s, t in zip(self.window.steps, self.done_s):
            if t <= self.seconds:
                n += s.answered
            else:
                if t > prev:
                    n += s.answered * max(0.0, self.seconds - prev) \
                        / (t - prev)
                break
            prev = t
        return n

    def flops_per_image(self, tenant: str) -> int:
        t = {x["name"]: x for x in self.cell.config["tenants"]}[tenant]
        return frontend_flops(self.cell.config["image"], t["channels"],
                              t["k"], t["pool_window"], t["d_model"])

    def peaks(self) -> dict:
        return peaks_for(self.device_name)


def run(root, workload: str, seed: int, seconds: float, trace: bool,
        device, proc_t0: float, log=print, control: bool = False) -> dict:
    """Runs the cell and returns the result line's object.  ``control``
    also judges the control's numbers on the same sample
    (``control.py``; the benchmark's runs never do)."""
    cell = Cell(root, workload)
    device = torch.device(device)
    clock = Clock(device)
    mod = cell.system_module()
    system = mod.System(cell.config, seed, device)
    params = cell.traffic
    traffic.check_loop(params)
    pools = system.pools(params["pool_per_tenant"], seed)
    ann = torch.profiler.record_function if trace else NO_ANNOTATION
    warm_closed(system, pools, params, seed, params["warmup_rounds"])
    tracer = system.tracer()
    if trace:
        from perfbench.harness.profile import make_profiler
        with make_profiler():      # the profiler's own start-up, once
            for tenant in params["wave"]:
                system.submit(tenant, pools[tenant][0])
            system.step()
            clock.sync()
        tracer.enable()
    win = Window(float(seconds))
    if trace:
        win.slice = Slice(seconds - min(SLICE_S, seconds / 3), clock,
                          make_profiler)
    sampler = Sampler(params["sample_rounds"], traffic.rng_for(seed, 2))
    clock.sync()
    before = system.counters()
    tracer.clear()
    gen = traffic.waves(params, traffic.rng_for(seed, 0))
    clock.start()
    setup_s = time.perf_counter() - proc_t0
    closed_loop(system, pools, gen, win, clock, sampler, ann)
    clock.sync()
    after = system.counters()
    if win.slice is not None:
        win.slice.stop()
    spans = tracer.events() if trace else []
    tracer.disable()
    done_s = win.step_done_s(clock)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    r = Run(cell, system, win, clock, setup_s, done_s, before, after, name,
            spans=spans)
    result_device = {"platform": "gpu" if device.type == "cuda" else "cpu",
                     "kind": name, "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if trace and win.slice is not None and win.slice.prof is not None:
        from perfbench.harness.profile import read_slice
        sl = win.slice
        r.trace = read_slice(sl.prof, sl.t_stop - sl.t_start)
        for rnd in win.steps[sl.first_step:sl.end_step]:
            for tenant, size, _ in rnd.batches:
                r.slice_plans.append(
                    (tenant, size, r.plan(tenant, size, rnd.grants[tenant])))
        result_device["busy_s"] = r.trace["busy_s"]
        result_device["window_s"] = r.trace["window_s"]
        breakdown = {"device_ops": r.trace["device_ops"],
                     "idle_gaps": r.trace["idle_gaps"]}
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    _log_window(r, log)
    for note in r.notes:
        log(note)
    # the check: the program's state freed first, its answers kept
    plans = {}
    for step in sampler.kept:
        for b in step.batches:
            key = (b.tenant, len(b.rids), step.grants[b.tenant])
            plans[key] = r.plan(*key)
    _log_plans(plans, log)
    system.close()
    del r
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare(system, cell.reference_module(), sampler.kept,
                            pools, cell.config, plans)
    numbers["missing"] = float(win.missing)
    correct, rows = check.judge(numbers, cell.config["limits"])
    control_rows = None
    if control:
        ctl = check.compare(system, cell.reference_module(), sampler.kept,
                            pools, cell.config, plans, control=True)
        ctl["missing"] = float(win.missing)
        control_correct, control_rows = check.judge(
            ctl, cell.config["limits"])
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    out = {"correct": correct, "attempted": win.submitted,
           "failed": win.missing, "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control_rows is not None:
        out["control"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in control_rows}
        out["control_correct"] = control_correct
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    for n, v, lim in rows:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    return out


def _log_window(r: Run, log) -> None:
    win = r.window
    per_image = (1e6 * win.submit_s_out_of_slice / win.submitted_out_of_slice
                 if win.submitted_out_of_slice else float("nan"))
    log(f"window {win.seconds} s: {len(win.steps)} rounds, "
        f"{win.submitted} requests sent, {win.missing} missing, "
        f"{r.images_done_in_window():.1f} answered in the window, "
        f"submit {per_image:.2f} us an image, "
        f"set-up {r.setup_s:.3f} s, device {r.device_name}")


def _log_plans(plans: Dict, log) -> None:
    """Each plan the sampled batches ran: tenant, grant, batch sizes."""
    seen: Dict[tuple, list] = {}
    for (tenant, size, grant), plan in sorted(plans.items()):
        rungs = " ".join(f"{s['member']}@{s['bits']}" for block in plan
                         for s in block.values())
        seen.setdefault((tenant, round(grant, 4), rungs), []).append(size)
    for (tenant, grant, rungs), sizes in sorted(seen.items()):
        log(f"plan {tenant} grant {grant} sizes {sizes}: {rungs}")

