"""Reads the profiled slice of a traced run: device intervals, kernel
times by name, the device's busy time, and what the host was doing while
the device sat idle."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from perfbench.harness.window import SLICE_END

# Harness annotations around the calls into the program, so that an idle
# gap can be named by the host's phase.
PHASES = ("bench.submit", "bench.step")


def make_profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False,
                   profile_memory=False)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _gap_labels(times: List[float], cpu: List[tuple]) -> List[str]:
    """For each time (ascending), the harness phase and the innermost host
    operation open at that time: one sweep over the host events."""
    labels, active, j = [], [], 0
    for t in times:
        while j < len(cpu) and cpu[j][0] <= t:
            active.append(cpu[j])
            j += 1
        active = [e for e in active if e[1] >= t]
        phase, inner, inner_len = "host", None, float("inf")
        for a, b, name in active:
            if name in PHASES:
                phase = name
            elif b - a < inner_len:
                inner, inner_len = name, b - a
        labels.append(f"{phase}: {inner or 'python'}")
    return labels


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most 160 letters."""
    return name.split("(", 1)[0][:160]


def read_slice(prof, window_s: float) -> dict:
    """Kernel events ``(name, seconds)`` in issue order, busy seconds,
    the ten device operations that took most time and the ten host
    activities under which the device sat idle longest; events that
    start after the slice's close are left out."""
    events = prof.events()
    end = min((e.time_range.start for e in events if e.name == SLICE_END),
              default=float("inf"))
    device, cpu = [], []
    for e in events:
        if e.time_range.start >= end:
            continue
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name not in PHASES + (SLICE_END,):    # annotations
                device.append((a, b, e.name))
        else:
            cpu.append((a, b, e.name))
    device.sort()
    cpu.sort()
    busy = _union([(a, b) for a, b, _ in device])
    busy_s = sum(b - a for a, b in busy)
    by_op: Dict[str, float] = defaultdict(float)
    for a, b, name in device:
        by_op[short_name(name)] += b - a
    idle: Dict[str, float] = defaultdict(float)
    gaps = [(end, start) for (_, end), (start, _) in zip(busy, busy[1:])]
    labels = _gap_labels([(a + b) / 2 for a, b in gaps], cpu)
    for (end, start), label in zip(gaps, labels):
        idle[label] += start - end
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"kernels": [(name, b - a) for a, b, name in device],
            "busy_s": busy_s, "window_s": window_s,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in longest]}
