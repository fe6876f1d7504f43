"""The measured window: the clients' loop around the system, its clock,
the sample of answers kept for the check, and the profiled slice.

Completion is stamped by a CUDA event recorded after each round of the
server; the benchmark adds no synchronize inside the window except at
the start of the profiled slice of a traced run.  A round's completions
are done when its event is.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.harness import traffic


# Marks the profiled slice's close in the trace; later events are left out.
SLICE_END = "bench.slice_end"


def NO_ANNOTATION(name: str):
    return contextlib.nullcontext()


class Clock:
    """Host clock for the loop, CUDA events for completion (the host's
    own clock on a CPU device, where a round is done when it returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.t0 = 0.0
        self._ev0 = None

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self.sync()
        self.t0 = time.perf_counter()
        if self.cuda:
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return self.now()

    def seconds(self, mark) -> float:
        """When the work before ``mark`` was done, since the start."""
        if self.cuda:
            return self._ev0.elapsed_time(mark) / 1e3
        return mark


@dataclass
class Step:
    """One round of the server: its batches, the pool image of each
    request and the grants it ran under (kept whole only for the sample)."""

    batches: list
    images: Dict[int, tuple]
    grants: Dict[str, float]


@dataclass
class Round:
    """What the window keeps of every round: its completion mark, the
    grants, and each batch's tenant, size and answers."""

    mark: object
    grants: Dict[str, float]
    batches: List[tuple]          # (tenant, size, answered)

    @property
    def answered(self) -> int:
        return sum(b[2] for b in self.batches)


class Sampler:
    """A uniform sample of ``k`` rounds, drawn from the seed (reservoir):
    the answers the check compares once the window has closed."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.kept, self.seen = k, rng, [], 0

    def offer(self, step: Step) -> None:
        if self.k == 0:
            return
        if self.seen < self.k:
            self.kept.append(step)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = step
        self.seen += 1


class Slice:
    """The profiled slice of a traced run: the window's last stretch,
    from the first round boundary past ``start_s`` to the window's close.
    Both edges sit behind a synchronize, so that the slice holds exactly
    the rounds issued inside it; the close is marked in the trace
    (``SLICE_END``) and the profiler is stopped only after the window,
    so that its stop, which takes most of a second, stalls no client."""

    def __init__(self, start_s: float, clock: Clock, profiler_factory):
        self.start_s = start_s
        self.clock, self.factory = clock, profiler_factory
        self.prof = None
        self.t_start = self.t_stop = None
        self.first_step = self.end_step = None

    def at_boundary(self, n_steps: int) -> None:
        if self.prof is None and self.clock.now() >= self.start_s:
            self.clock.sync()
            self.prof = self.factory()
            self.prof.start()
            self.t_start = self.clock.now()
            self.first_step = n_steps

    def finish(self, n_steps: int) -> None:
        """Closes the slice at the window's close."""
        if self.prof is None or self.t_stop is not None:
            return
        self.clock.sync()
        self.t_stop = self.clock.now()
        self.end_step = n_steps
        with torch.profiler.record_function(SLICE_END):
            pass

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.stop()


@dataclass
class Window:
    """What a window recorded."""

    seconds: float
    steps: List[Round] = field(default_factory=list)
    submitted: int = 0
    submit_s_out_of_slice: float = 0.0
    submitted_out_of_slice: int = 0
    missing: int = 0
    slice: Optional[Slice] = None

    def step_done_s(self, clock: Clock) -> List[float]:
        return [clock.seconds(s.mark) for s in self.steps]


def _account(win: Window, step: Step, clock: Clock, sampler: Sampler,
             submit_s: float, n_sub: int) -> Round:
    rnd = Round(clock.mark(), step.grants,
                [(b.tenant, len(b.rids), sum(b.ok)) for b in step.batches])
    win.submitted += n_sub
    sl = win.slice
    if sl is None or sl.prof is None:
        win.submit_s_out_of_slice += submit_s
        win.submitted_out_of_slice += n_sub
    win.steps.append(rnd)
    if step.batches:
        sampler.offer(step)
    return rnd


def closed_loop(system, pools, gen, win: Window, clock: Clock,
                sampler: Sampler, ann=NO_ANNOTATION) -> None:
    """Send a wave, run one round, repeat until the window closes."""
    while clock.now() < win.seconds:
        if win.slice is not None:
            win.slice.at_boundary(len(win.steps))
        wave = next(gen)
        images = {}
        t = time.perf_counter()
        with ann("bench.submit"):
            for tenant, idx in wave:
                rid = system.submit(tenant, pools[tenant][idx])
                images[rid] = (tenant, idx)
        t_sub = time.perf_counter() - t
        with ann("bench.step"):
            batches = system.step()
        rnd = _account(win, Step(batches, images, system.grants()), clock,
                       sampler, t_sub, len(wave))
        win.missing += len(wave) - rnd.answered
    if win.slice is not None:
        win.slice.finish(len(win.steps))


def warm_closed(system, pools, params, seed: int, rounds: int) -> None:
    gen = traffic.waves(params, traffic.rng_for(seed, 1))
    for _ in range(rounds):
        for tenant, idx in next(gen):
            system.submit(tenant, pools[tenant][idx])
        system.step()
