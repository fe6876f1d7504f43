"""Production dry-run: one step of every (arch x shape x mesh) cell of the
port, measured on ``meta`` tensors (``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
        --no-calibrate [--arch olmo-1b] [--shape train_4k]

What measures a cell.  The reference lowers and compiles each cell with
XLA on 512 placeholder host devices and reads ``cost_analysis()``,
``memory_analysis()`` and the HLO.  The port has no lowering step: one
step of the cell, as the port runs it, is traced on ``meta`` tensors on
the CPU of whatever machine runs this (no card is needed and nothing is
allocated).  The production mesh is ``make_production_mesh(devices=
["meta"] * n)`` — n logical devices that share one device, as logical
devices of one card do.

Which step.  Train cells trace ``distributed/shard_train.py``'s
``train_step`` on the state placed under ``state_pspecs``.  Prefill and
decode cells trace ``api.prefill_step`` / ``api.decode_step`` the way
``shard_train.loss_and_grads`` runs a data rank: the rank's rows by
``row_split`` and ``batch_pspecs`` over its model ranks
(``tensor_parallel.rank_params``: each split sublayer, the MoE
experts among them, on every model rank's block, the rest whole on the
first; a layer-stack leaf that FSDP splits gathered a layer group at a
time), decode on its rows of the caches under ``cache_pspecs`` (a
``Split`` of the model ranks' blocks where a split sublayer's cache
splits over "model" by kv head or channel, a ``SeqSplit`` of its
sequence blocks, each where it lies, where an attention cache splits
by sequence over "model", and over "data" too, split attention or not;
else the rows whole), and rows that do not divide running whole once
(each rank's MoE groups are those of its own tokens).  Every model rank
of a data rank runs its share; the first also runs the residual
stream; the first data rank's positions hold and sum the gradients,
but a layer-stack leaf that FSDP splits gets its gradient on its FSDP
blocks' own positions.

Per-device figures are the busiest device's: the device whose own
FLOPs, bytes and collective bytes give the longest bound time at the
H100's rates; the record names it (``busiest_device``).  Work of the
same shape and role is traced once (``meta`` only;
``collectives.rank_work``): data ranks whose rows have the same shapes
get the first rank's pass (its gathers, forward and backward over its
model ranks) — its counts, its collective events re-recorded on their
own ranks, and outputs of the same shapes — and blocks of the same
shape get the first one's AdamW update counts.  Within a pass, a
model rank of a split sublayer before its last gets the section of the
first rank whose inputs have its layouts (``StepCounter.sections``):
its forward and backward counts, its outputs' shapes and gradients of
its inputs' shapes; the first rank of each layout is traced (RWKV's
heads on 16 ranks are 2 and 3 a rank: two traced sections).  The last
rank is traced, because under remat its recompute stops before its
final product where the others recompute whole; so every rank's counts
are those of tracing it (held by ``tests/test_torch_dryrun.py`` and
``tests/test_torch_rwkv_parallel.py``), though a replayed rank's memory
is not traced.  The first ranks come first, so the busiest device's
work and memory are traced; the collective bytes are kept per rank
(``collective_bytes_by_rank``) and every gradient move runs.

What each field is in the port:

* ``flops``: FlopCounterMode's formulas (``torch.utils.flop_counter``'s
  registry: the products, convolutions and attention ops) over every
  op dispatched in the step, plus what a kernel wrapper reports through
  ``kernels.cuda.kernel_work`` (the selective scan's FP32 operations).
* ``bytes_accessed``: the input and result bytes of every aten op
  dispatched in the step (a ``TorchDispatchMode``), views and
  allocations excluded (an in-place op reads and writes its target;
  ``copy_``, ``fill_``, ``zero_`` and ``out=`` only write theirs); plus
  a kernel's reported bytes.  Each eager op crosses device memory,
  so this is the port's traffic, not an estimate.
* ``memory``: ``argument_size_in_bytes`` the static bytes a device,
  ``output_size_in_bytes`` the busiest device's outputs allocated by the
  step, ``temp_size_in_bytes`` the peak of its live bytes allocated in
  the step (outputs included while alive; the ZeRO-3 gathers of the
  layer group that runs count here), tracked per storage;
  ``peak_all_devices_bytes`` the same over every device (what one card
  holding every logical device would see).
* ``collectives``: the bytes the single controller moves between
  logical ranks, by kind (``distributed/collectives.py`` gives each
  move's kind), under the reference's operand convention
  (``analysis.collective_bytes``).

Renamed keys (the rest are the reference's): ``lower_s``/``compile_s``
-> ``trace_s``; ``scan_graph`` -> ``step``; ``hlo_ops`` -> ``aten_ops``
(``analysis.op_histogram``); ``hlo_chars`` -> ``aten_op_count``.
``calibrate=True`` traces the 1- and 2-group configs too and checks
that ``_extrapolate`` gives the full-depth count (eager tracing counts
every layer, so it is a check here, not a correction).  The default
``--out`` is ``experiments/dryrun_torch``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ARCH_NAMES, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.distributed import collectives
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              ShardedTensor, ShardingPolicy,
                                              cache_pspecs, device_put,
                                              params_pspecs, state_pspecs,
                                              to_shardings,
                                              tree_map_with_path)
from repro_torch.distributed.shard_train import (forward_devices,
                                                 forward_ranks, pass_ranks,
                                                 row_split, train_step)
from repro_torch.kernels import cuda
from repro_torch.launch.analysis import (H100_HBM_BW,
                                         H100_NVLINK_BW_PER_LINK,
                                         H100_NVLINK_LINKS,
                                         H100_PEAK_BF16_FLOPS, Roofline,
                                         collective_bytes, histogram_name,
                                         ideal_traffic, model_flops,
                                         op_histogram)
from repro_torch.launch.mesh import make_production_mesh, mesh_axis_sizes
from repro_torch.models import api
from repro_torch.models.frontends import input_specs
from repro_torch.optim.adamw import AdamWConfig, tree_leaves

aten = torch.ops.aten
# metadata queries: no work (FlopCounterMode skips the same); and
# lift_fresh, which ``torch.tensor`` dispatches on some devices only
_QUERIES = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
            aten.is_contiguous.memory_format,
            aten.is_strides_like_format.default,
            aten.is_non_overlapping_and_dense.default, aten.size.default,
            aten.sym_size.default, aten.stride.default,
            aten.sym_stride.default, aten.storage_offset.default,
            aten.sym_storage_offset.default, aten.numel.default,
            aten.sym_numel.default, aten.dim.default,
            torch.ops.prim.layout.default, torch.ops.prim.device.default,
            aten.lift_fresh.default}
# ops that move no bytes: allocations and aliases
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "_unsafe_view", "_reshape_alias",
             "lift_fresh", "alias", "set_"}
# ops that write their first argument without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_"}


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _RankCounts:
    """One rank's counts; ``by_op``: FLOPs and bytes by aten op name
    (a kernel's under its counter's name), to say where two counts
    differ."""
    __slots__ = ("flops", "bytes", "ops", "buckets", "kernels", "by_op")

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.buckets: collections.Counter = collections.Counter()
        self.kernels: collections.Counter = collections.Counter()
        self.by_op: collections.Counter = collections.Counter()

    def copy(self) -> "_RankCounts":
        c = _RankCounts()
        c.add(self)
        return c

    def add(self, other: "_RankCounts", sign: int = 1) -> None:
        self.flops += sign * other.flops
        self.bytes += sign * other.bytes
        self.ops += sign * other.ops
        for k, v in other.buckets.items():
            self.buckets[k] += sign * v
        for k, v in other.kernels.items():
            self.kernels[k] += sign * v
        for k, v in other.by_op.items():
            self.by_op[k] += sign * v


class StepCounter(TorchDispatchMode, collectives.CollectiveCounter,
                  cuda.WorkSink):
    """Counts one step by logical rank (``collectives.current_rank()``):
    FLOPs, bytes, the aten ops and the kernels' reported work; the live
    bytes the step allocates, per storage; the collectives.  Use
    ``count_step``.  ``reuse_passes``: answer a data rank's pass of a
    shape already traced from that trace (``meta`` tensors only)."""

    def __init__(self, reuse_passes: bool = False):
        TorchDispatchMode.__init__(self)
        collectives.CollectiveCounter.__init__(self)
        self.reuse_passes = reuse_passes
        self.replayed: set = set()
        self.ranks: Dict[Optional[int], _RankCounts] = \
            collections.defaultdict(_RankCounts)
        self._live: Dict[int, tuple] = {}
        self.live: Dict[Optional[int], int] = collections.Counter()
        self.peak: Dict[Optional[int], int] = collections.Counter()
        self.live_all = 0
        self.peak_all = 0
        self._depth = 0
        self.reported: collections.Counter = collections.Counter()
        self._passes: Dict[Any, tuple] = {}
        self.reused_ranks: set = set()
        self.traced_ranks: set = set()

    # -- memory ---------------------------------------------------------
    def _free(self, key: int) -> None:
        nbytes, rank = self._live.pop(key)
        self.live[rank] -= nbytes
        self.live_all -= nbytes

    def _track(self, outs, ins, rank) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or any(
                    i.untyped_storage()._cdata == key for i in ins):
                continue
            nbytes = st.nbytes()
            self._live[key] = (nbytes, rank)
            self.live[rank] += nbytes
            self.peak[rank] = max(self.peak[rank], self.live[rank])
            self.live_all += nbytes
            self.peak_all = max(self.peak_all, self.live_all)
            weakref.finalize(st, self._free, key).atexit = False

    def allocated(self, t: torch.Tensor):
        """(bytes, rank) of ``t``'s storage if the step allocated it and
        it is alive, else None."""
        return self._live.get(t.untyped_storage()._cdata)

    # -- ops ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _QUERIES:
            return out
        rank = collectives.current_rank()
        ins = _tensors(args, [])
        for k, v in kwargs.items():
            if k != "out":
                _tensors(v, ins)
        outs = _tensors(out, [])
        if not func.is_view:
            self._track(outs, ins + _tensors(kwargs.get("out"), []), rank)
        if self._depth:
            return out
        c = self.ranks[rank]
        c.ops += 1
        name = func._schema.name.split("::")[-1]
        bucket = histogram_name(name, bool(
            name == "_to_copy" and ins and outs
            and ins[0].dtype != outs[0].dtype))
        if bucket:
            c.buckets[bucket] += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
            c.flops += flops
            c.by_op[name] += flops
        if func.is_view or name in _NO_BYTES:
            return out
        if name in _WRITE_ONLY:
            ins = ins[1:]
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        c.bytes += nbytes
        c.by_op[name] += nbytes
        return out

    # -- kernels (cuda.WorkSink) ----------------------------------------
    def kernel_begin(self, counter, flops, nbytes, device) -> None:
        if self._depth == 0:
            c = self.ranks[collectives.current_rank()]
            c.flops += flops
            c.bytes += nbytes
            c.kernels[counter] += 1
            c.by_op[counter] += flops + nbytes
            if device.type == "cuda":
                self.reported[counter] += 1
        self._depth += 1

    def kernel_end(self, counter) -> None:
        self._depth -= 1

    # -- replayed model ranks (collectives.CollectiveCounter) ------------
    @contextlib.contextmanager
    def _quiet(self):
        """Ops inside are not counted (their allocations are tracked)."""
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    def sections(self, ranks: List[int], section, inputs) -> list:
        """A split sublayer's model ranks: with ``reuse_passes`` on
        ``meta``, the last rank's section traced, and each rank before
        it traced if it is the first of its inputs' layouts (a rank's
        heads or experts may differ in number: RWKV's 2 and 3 heads a
        rank at 40 heads on 16) or else replayed from that first one's
        (``_Replay``): its forward counts and outputs' layouts, its
        backward counts, and gradients of its inputs' layouts."""
        tensors = [x for xs in inputs for x in xs
                   if isinstance(x, torch.Tensor)]
        if not self.reuse_passes or len(ranks) < 3 or \
                not all(x.is_meta for x in tensors):
            return super().sections(ranks, section, inputs)
        probes: Dict[tuple, _SectionProbe] = {}
        outs = []
        for m in range(len(ranks) - 1):
            key = tuple((_layout(x), x.requires_grad)
                        if isinstance(x, torch.Tensor) else type(x)
                        for x in inputs[m])
            probe = probes.get(key)
            if probe is None:
                probes[key] = _SectionProbe(self, ranks[m])
                outs.append(probes[key].trace(section, m, inputs[m]))
                continue
            self.replayed.add(ranks[m])
            outs.append(_Replay.apply(probe, ranks[m], *[
                x for x in inputs[m] if _differentiable(x)]))
        outs.append(section(len(ranks) - 1, inputs[-1]))
        return outs

    # -- reused work (collectives.CollectiveCounter) ---------------------
    def rank_work(self, key, ranks: List[int], fn):
        if not self.reuse_passes:
            return fn()
        if key in self._passes:
            spec, deltas, events = self._passes[key]
            if len(deltas) != len(ranks):
                raise RuntimeError("reused work on another number of ranks")
            for rank, delta in zip(ranks, deltas):
                self.ranks[rank].add(delta)
            self.events.extend(e._replace(rank=ranks[i]) for i, e in events)
            self.reused_ranks.update(ranks)
            self._depth += 1
            try:
                return _materialize(spec)
            finally:
                self._depth -= 1
        before = [self.ranks[r].copy() for r in ranks]
        n_events = len(self.events)
        out = fn()
        deltas = []
        for r, b in zip(ranks, before):
            delta = self.ranks[r].copy()
            delta.add(b, -1)
            deltas.append(delta)
        events = self.events[n_events:]
        if any(e.rank not in ranks for e in events):
            raise RuntimeError("reused work moved data for another rank")
        self._passes[key] = (_spec_of(out), deltas,
                             [(ranks.index(e.rank), e) for e in events])
        self.traced_ranks.update(r for r in ranks if r not in self.replayed)
        return out


def _differentiable(t) -> bool:
    """A section's input that takes a gradient (as ``collectives.enter``
    takes its inputs)."""
    return isinstance(t, torch.Tensor) and t.requires_grad


def _layout(t: Optional[torch.Tensor]):
    return None if t is None else (tuple(t.shape), t.stride(), t.dtype)


class _SectionProbe:
    """The section of the first model rank of its inputs' layouts,
    measured to replay on the later ranks of those layouts but the last
    (``StepCounter.sections``): its
    forward counts and outputs' layouts, and its backward counts (from
    its outputs' gradients to its inputs'), added to each replayed rank
    that took part in the forward (``ranks``)."""

    def __init__(self, counter: StepCounter, rank: int):
        self.counter, self.rank, self.ranks = counter, rank, []

    def counts(self) -> _RankCounts:
        return self.counter.ranks[self.rank].copy()

    def quiet_empty(self, layouts, rank: int) -> tuple:
        with self.counter._quiet(), collectives.on_rank(rank):
            return tuple(None if s is None else torch.empty_strided(
                s[0], s[1], dtype=s[2], device="meta") for s in layouts)

    def trace(self, section, m: int, xs) -> tuple:
        idx = [i for i, x in enumerate(xs) if _differentiable(x)]
        xs = list(xs)
        with self.counter._quiet():
            for i, x in zip(idx, _ProbeIn.apply(self, *[xs[i] for i in idx])):
                xs[i] = x
        before = self.counts()
        outs = section(m, xs)
        self.fwd = self.counts()
        self.fwd.add(before, -1)
        self.layouts = [_layout(o) for o in outs]
        live = [o for o in outs if o is not None]
        with self.counter._quiet():
            got = iter(_ProbeOut.apply(self, *live))
        return tuple(None if o is None else next(got) for o in outs)

    def begin(self) -> None:
        self.before = self.counts()

    def end(self) -> None:
        delta = self.counts()
        delta.add(self.before, -1)
        for r in self.ranks:
            self.counter.ranks[r].add(delta)


class _ProbeIn(torch.autograd.Function):
    """The first rank's section's inputs; backward its section's end."""

    @staticmethod
    def forward(ctx, probe, *xs):
        ctx.probe = probe
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.probe.end()
        return (None,) + grads


class _ProbeOut(torch.autograd.Function):
    """The first rank's section's outputs; backward its section's
    start."""

    @staticmethod
    def forward(ctx, probe, *xs):
        ctx.probe = probe
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.probe.begin()
        return (None,) + grads


class _Replay(torch.autograd.Function):
    """A model rank's section replayed from the first one's: its
    outputs' layouts and its forward counts; backward, gradients of its
    inputs' layouts (its counts come with the first rank's section's
    backward, ``_SectionProbe.end``).  It saves an input, so a remat's
    recompute runs it again as it runs a section between the first and
    the last."""

    @staticmethod
    def forward(ctx, probe, rank, *xs):
        ctx.probe, ctx.rank = probe, rank
        ctx.set_materialize_grads(False)
        ctx.layouts = [_layout(x) for x in xs]
        probe.ranks.append(rank)
        probe.counter.ranks[rank].add(probe.fwd)
        if xs:
            ctx.save_for_backward(xs[0])
        return probe.quiet_empty(probe.layouts, rank)

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors
        return (None, None) + ctx.probe.quiet_empty(ctx.layouts, ctx.rank)


def _spec_of(tree):
    """The tree's structure with its tensors as (shape, dtype, device),
    which must be ``meta`` (a reused pass's outputs carry no values)."""
    if isinstance(tree, torch.Tensor):
        if not tree.is_meta:
            raise ValueError("a data rank's pass is reused only on meta "
                             f"tensors, got one on {tree.device}")
        return ("tensor", tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return {k: _spec_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_spec_of(v) for v in tree)
    return tree


def _materialize(spec):
    if isinstance(spec, tuple) and len(spec) == 3 and spec[0] == "tensor":
        return torch.empty(spec[1], dtype=spec[2], device="meta")
    if isinstance(spec, dict):
        return {k: _materialize(v) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return type(spec)(_materialize(v) for v in spec)
    return spec


@dataclasses.dataclass
class StepCounts:
    """One counted step: per-rank counts and the counter itself."""
    counter: StepCounter
    outputs: Any
    home: int

    def rank_bound_s(self, rank) -> float:
        c = self.counter.ranks[rank]
        coll = collective_bytes(
            e for e in self.counter.events if e.rank == rank)["total"]
        return max(c.flops / H100_PEAK_BF16_FLOPS, c.bytes / H100_HBM_BW,
                   coll / (H100_NVLINK_BW_PER_LINK * H100_NVLINK_LINKS))

    def busiest(self) -> int:
        ranks = {r for r in self.counter.ranks if r is not None}
        ranks |= {e.rank for e in self.counter.events if e.rank is not None}
        if not ranks:
            return self.home
        best = max(sorted(ranks), key=self.rank_bound_s)
        c = self.counter
        if c.reuse_passes and best not in c.traced_ranks:
            raise RuntimeError(f"the busiest device, rank {best}, ran only "
                               f"reused work: its memory was not traced")
        return best

    def summary(self, rank: int) -> dict:
        """The reference's per-device metrics of ``rank``."""
        c = self.counter.ranks[rank]
        coll = collective_bytes(
            e for e in self.counter.events if e.rank == rank)
        return {"flops": float(c.flops), "bytes_accessed": float(c.bytes),
                "collectives": coll, "aten_ops": op_histogram(c.buckets),
                "aten_op_count": int(c.ops),
                "kernels": dict(sorted(c.kernels.items()))}

    def output_bytes(self, rank: int) -> int:
        total, seen = 0, set()
        for t in _flat_tensors(self.outputs):
            got = self.counter.allocated(t)
            key = t.untyped_storage()._cdata
            if got is not None and got[1] == rank and key not in seen:
                seen.add(key)
                total += got[0]
        return total

    def collective_bytes_by_rank(self) -> Dict[str, float]:
        per: Dict[int, list] = collections.defaultdict(list)
        for e in self.counter.events:
            per[e.rank].append(e)
        return {str(r): collective_bytes(evs)["total"]
                for r, evs in sorted(per.items(),
                                     key=lambda kv: (kv[0] is None, kv[0]))}


def _unshard(tree):
    if isinstance(tree, ShardedTensor):
        return list(tree.shards)
    if isinstance(tree, dict):
        return {k: _unshard(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unshard(v) for v in tree]
    return tree


def _flat_tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat_tensors(v)]
    return []


def count_step(fn, *args, home: int = 0, reuse_passes: bool = False
               ) -> StepCounts:
    """Run ``fn(*args)`` under a ``StepCounter`` (work outside any
    ``collectives.on_rank`` goes to ``home``).  A CUDA kernel launched
    in the step without reporting its work is an error."""
    if reuse_passes and any(t.device.type not in ("meta", "cpu")
                            for t in _flat_tensors(_unshard(args))):
        raise ValueError("work is reused only on meta tensors (a CPU step "
                         "counter aside)")
    counter = StepCounter(reuse_passes=reuse_passes)
    launched = cuda.launch_counts()
    with contextlib.ExitStack() as stack:
        stack.enter_context(collectives.counting(counter))
        stack.enter_context(cuda.work_sink(counter))
        stack.enter_context(collectives.on_rank(home))
        stack.enter_context(counter)
        out = fn(*args)
    after = cuda.launch_counts()
    for name in set(after) | set(launched):
        n = after.get(name, 0) - launched.get(name, 0)
        if n != counter.reported[name]:
            raise RuntimeError(
                f"{name}: {n} launches in the step, {counter.reported[name]} "
                f"reported through kernels.cuda.kernel_work: a wrapper on "
                f"the traced path has no count hook")
    return StepCounts(counter, out, home)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------
def _sharded_bytes(tree, spec_tree, mesh) -> float:
    """Analytic bytes/device for a (possibly ``meta``) tree + specs."""
    sizes = mesh_axis_sizes(mesh)

    def leaf_bytes(leaf, spec):
        shard = 1
        for entry in spec:
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            for a in axes:
                shard *= sizes[a]
        n = 1
        for d in leaf.shape:
            n *= d
        return n * leaf.dtype.itemsize / shard

    total = 0.0
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(spec_tree)):
        total += leaf_bytes(leaf, spec)
    return total


def _rows(st: ShardedTensor, dim: int, r: int, n: int, device, rank: int):
    """Rows ``r`` of ``n`` along ``dim`` of a sharded leaf, whole on
    ``device``: its blocks in that row range gathered (an all-gather on
    ``rank`` where they are more than one)."""
    size = st.shape[dim] // n
    lo, hi = r * size, (r + 1) * size
    blocks = {}
    for sl, t in zip(st.index, st.shards):
        s = sl[dim]
        if s.start < hi and s.stop > lo:
            blocks.setdefault(tuple((x.start, x.stop) for x in sl), t)
    shape = list(st.shape)
    shape[dim] = size
    if len(blocks) > 1:
        collectives.record("all-gather", int(np.prod(shape))
                           * st.dtype.itemsize, len(blocks), rank)
    out = torch.empty(shape, dtype=st.dtype, device=device)
    for key, t in blocks.items():
        dst, src = [], []
        for d, (a, b) in enumerate(key):
            if d == dim:
                a2, b2 = max(a, lo), min(b, hi)
                dst.append(slice(a2 - lo, b2 - lo))
                src.append(slice(a2 - a, b2 - a))
            else:
                dst.append(slice(a, b))
                src.append(slice(0, b - a))
        out[tuple(dst)].copy_(t[tuple(src)].to(device))
    return out


def serve_step(cfg, mesh, kind: str, params, batch, caches=None, pos=0):
    """A prefill or decode step on ``mesh`` as ``shard_train`` runs a data
    rank's pass: each rank's rows of the batch (and of the caches) on
    its model ranks, each split sublayer on every model rank's block
    (``tensor_parallel.rank_params``).  Returns one output per data
    rank that ran."""
    devs, ranks = forward_devices(mesh), forward_ranks(mesh)
    n, groups = row_split(cfg, mesh, batch)
    plans = tp.plan_leaves(cfg, mesh, params)
    outs = []
    for r in range(n):
        dev = devs[r]
        with collectives.on_rank(ranks[r]):
            rows = {k: v.narrow(0, r * (v.shape[0] // n),
                                v.shape[0] // n).to(dev)
                    for k, v in batch.items()}
        key = (kind, tuple((k, tuple(v.shape)) for k, v in rows.items()))
        outs.append(collectives.rank_work(
            key, ranks[r], lambda: _serve_rank(cfg, kind, params, plans,
                                               caches, rows, pos, r, n,
                                               mesh, groups),
            ranks=pass_ranks(mesh, r, n == 1 and len(devs) > 1)))
    return outs


def _serve_rank(cfg, kind, params, plans, caches, rows, pos, r, n, mesh,
                groups):
    """Data rank ``r``'s step on its rows, with its share of the whole
    batch's MoE capacity groups (``row_split``)."""
    local, _ = tp.rank_params(cfg, params, mesh, r, plans)
    if kind == "prefill":
        return api.prefill_step(cfg, local, rows, moe_groups=groups)[:2]
    local_c = _rank_caches(cfg, caches, mesh, r, n)
    x = rows["embeds"] if "embeds" in rows else rows["tokens"]
    return api.decode_step(cfg, local, local_c, x, pos, moe_groups=groups)


# the attention caches: self-attention's k/v, cross-attention's frozen
# xk/xv (``cache_pspecs`` lays both out alike)
KV_CACHES = ("k", "v", "xk", "xv")


def _rank_caches(cfg, caches, mesh, r: int, n: int):
    """Data rank ``r``'s rows of the decode caches: a ``Split`` of the
    model ranks' blocks where ``cache_pspecs`` splits a split
    sublayer's cache over "model" (attention k/v and cross-attention
    xk/xv by kv head, Mamba's channels); a ``SeqSplit`` of the sequence
    blocks where it splits an attention's k/v or xk/xv by sequence over
    "model", whether or not the attention splits, each block left on
    the rank that holds it: the data rank's model ranks, or, where the
    sequence is sharded over the data axes too (a batch that does not
    divide them), every (data, model) rank (``_seq_blocks``; each
    holder attends over its block, ``attention._seq_split_decode_attn``,
    ``encdec._seq_split_cross_attn``); else the rows whole on the data
    rank's device (RWKV's state, replicated over "model", is read by
    each head owner from its own replica)."""
    group = tp.model_group(mesh, r)
    columns = [set(row[m] for row in tp.model_positions(mesh))
               for m in range(group.tp)]

    def one(path, st):
        name = path.rsplit("/", 1)[-1]
        spec = tuple(st.sharding.spec)
        seq = spec[2] if name in KV_CACHES else None
        if group.tp > 1 and "model" in (seq if isinstance(seq, tuple)
                                         else (seq,)):
            return _seq_blocks(st, mesh, group, r, n)
        if not (group.tp > 1 and (
                (name in KV_CACHES and spec[3] == "model")
                or (name in ("conv", "ssm") and "model" in spec))):
            return _rows(st, 1, r, n, group.devices[0], group.ranks[0])
        size = st.shape[1] // n
        parts = []
        for m, blk in enumerate(tp.model_blocks(tuple(st.shape), spec,
                                                group.tp)):
            region = list(blk)
            region[1] = slice(r * size, (r + 1) * size)
            with collectives.on_rank(group.ranks[m]):
                parts.append(tp.take_region(st, tuple(region),
                                            group.devices[m],
                                            group.ranks[m], columns[m]))
        return tp.Split(group, parts)

    return tree_map_with_path(one, caches)


def _seq_blocks(st: ShardedTensor, mesh, group, r: int, n: int):
    """Data rank ``r``'s rows of a k/v cache sharded by sequence, as a
    ``SeqSplit`` of its sequence blocks in order, each on the rank that
    holds it (one of ``group``'s where one does): nothing moves."""
    size = st.shape[1] // n
    rows = slice(r * size, (r + 1) * size)
    mine = set(group.ranks)
    by_seq: Dict[tuple, int] = {}
    for i, sl in enumerate(st.index):
        if sl[1].start < rows.stop and rows.start < sl[1].stop:
            k = (sl[2].start, sl[2].stop)
            if k not in by_seq or (i in mine and by_seq[k] not in mine):
                by_seq[k] = i
    holders = [by_seq[k] for k in sorted(by_seq)]
    owners = tp.ModelGroup(tuple(holders),
                           tuple(mesh.devices.flat[i] for i in holders))
    parts = []
    for i, dev in zip(owners.ranks, owners.devices):
        region = list(st.index[i])
        region[1] = rows
        with collectives.on_rank(i):
            parts.append(tp.take_region(st, tuple(region), dev, i, {i}))
    return tp.SeqSplit(owners, parts)


def build_cell(cfg, shape_name: str, mesh, policy=ShardingPolicy()):
    """Returns (fn, abstract args, shardings, static bytes/device):
    ``fn(*place(args, shardings))`` runs the cell's step on ``mesh``;
    a ``None`` sharding leaves that argument whole."""
    shape = SHAPES[shape_name]
    specs = input_specs(cfg, shape)
    opt_cfg = AdamWConfig(moment_dtype=cfg.moment_dtype)

    if shape.kind == "train":
        state = api.init_train_state_abstract(cfg, opt_cfg)
        sspec = state_pspecs(cfg, mesh, state, policy)
        fn = lambda s, b: train_step(cfg, opt_cfg, s, b)  # noqa: E731
        args = (state, specs)
        shardings = (to_shardings(mesh, sspec), None)
        static = _sharded_bytes(state, sspec, mesh)
    elif shape.kind == "prefill":
        params = api.init_params_abstract(cfg)
        pspec = params_pspecs(cfg, mesh, params, policy)
        fn = lambda p, b: serve_step(cfg, mesh, "prefill", p, b)  # noqa
        args = (params, specs)
        shardings = (to_shardings(mesh, pspec), None)
        static = _sharded_bytes(params, pspec, mesh)
    else:  # decode
        params = api.init_params_abstract(cfg)
        pspec = params_pspecs(cfg, mesh, params, policy)
        caches = api.init_decode_caches(cfg, shape.global_batch,
                                        shape.seq_len, device="meta")
        cspec = cache_pspecs(cfg, mesh, caches, policy)
        pos = shape.seq_len - 1
        fn = lambda p, c, b: serve_step(  # noqa: E731
            cfg, mesh, "decode", p, b, caches=c, pos=pos)
        args = (params, caches, specs)
        shardings = (to_shardings(mesh, pspec), to_shardings(mesh, cspec),
                     None)
        static = (_sharded_bytes(params, pspec, mesh)
                  + _sharded_bytes(caches, cspec, mesh))
    return fn, args, shardings, static


def place(args, shardings, mesh):
    """The cell's arguments on ``mesh``: each tree under its shardings
    (``device_put``), whole where its sharding is None.  A train state's
    step counter stays a CPU int32 (the step reads its value; ``meta``
    has none), replicated over the mesh."""
    out = []
    for a, s in zip(args, shardings):
        if s is None:
            out.append(a)
            continue
        if isinstance(a, api.TrainState):
            step = a.opt.step
            placed = device_put(a, s)
            blocks = ShardedTensor((), torch.int32,
                                   NamedSharding(mesh, P()),
                                   [step.clone()] * mesh.size)
            out.append(api.TrainState(placed.params,
                                      placed.opt._replace(step=blocks)))
        else:
            out.append(device_put(a, s))
    return out


def summarize(counts: StepCounts, mesh, static: float,
              trace_s: float) -> dict:
    """The busiest device's metrics of a counted step on ``mesh``."""
    rank = counts.busiest()
    m = counts.summary(rank)
    coords = np.unravel_index(rank, mesh.devices.shape)
    c = counts.counter
    m.update(
        trace_s=round(trace_s, 2),
        static_bytes_per_device=static,
        memory={"argument_size_in_bytes": static,
                "output_size_in_bytes": counts.output_bytes(rank),
                "temp_size_in_bytes": int(c.peak[rank]),
                "peak_all_devices_bytes": int(c.peak_all)},
        busiest_device={"index": int(rank), "coords": {
            a: int(x) for a, x in zip(mesh.axis_names, coords)}},
        reused_ranks=len((c.reused_ranks | c.replayed) - c.traced_ranks),
        collective_bytes_by_rank=counts.collective_bytes_by_rank())
    return m


def _measure(cfg, shape_name: str, mesh, policy) -> dict:
    """Trace one step of the cell on ``meta``; the busiest device's
    metrics."""
    t0 = time.time()
    fn, args, shardings, static = build_cell(cfg, shape_name, mesh, policy)
    placed = place(args, shardings, mesh)
    counts = count_step(fn, *placed, home=forward_ranks(mesh)[0],
                        reuse_passes=True)
    return summarize(counts, mesh, static, time.time() - t0)


def _calibration_cfgs(cfg):
    """1-group and 2-group configs at full width (the reference's):
        total = m2 + (n_groups - 2) * (m2 - m1)."""
    from repro_torch.models.transformer import block_period
    P_ = block_period(cfg)
    n_groups = cfg.n_layers // P_
    rep = {"scan_layers": False, "remat": cfg.remat}
    c1 = dataclasses.replace(cfg, n_layers=P_, **rep)
    c2 = dataclasses.replace(cfg, n_layers=2 * P_, **rep)
    if cfg.enc_layers:
        c1 = dataclasses.replace(c1, enc_layers=1)
        c2 = dataclasses.replace(c2, enc_layers=2)
    return c1, c2, n_groups


def _extrapolate(m1: dict, m2: dict, n_groups: int) -> dict:
    """total = m2 + (G-2) * (m2 - m1), per scalar metric."""
    out = {}
    for key in ("flops", "bytes_accessed"):
        out[key] = m2[key] + (n_groups - 2) * (m2[key] - m1[key])
    coll = {}
    for k, v2 in m2["collectives"].items():
        if k == "counts":
            continue
        v1 = m1["collectives"][k]
        coll[k] = v2 + (n_groups - 2) * (v2 - v1)
    out["collectives"] = coll
    return out


def calibration_check(full: dict, tot: dict) -> Optional[str]:
    """Why the extrapolated ``tot`` differs from the ``full`` count in
    FLOPs or collective bytes, or None.  Bytes are not checked: with one
    group a row block of a stacked leaf (``wo``, ``w_down`` split over
    "model") is contiguous, so AdamW's flat view of its gradient slice
    copies nothing, while from two groups on it copies, and AdamW and
    the global norm add one f32 scalar a 2^26-element block
    (``optim/adamw.py::BLOCK``); the record keeps the difference."""
    if tot["flops"] != full["flops"]:
        return f"flops {tot['flops']!r} != {full['flops']!r}"
    for k, v in tot["collectives"].items():
        if v != full["collectives"][k]:
            return f"collectives[{k!r}] {v!r} != {full['collectives'][k]!r}"
    return None


# ---------------------------------------------------------------------------
# §Perf variants (the reference's, unchanged)
# ---------------------------------------------------------------------------
VARIANTS = {
    # attention score chunks materialized bf16 (stats stay f32)
    "bf16scores": lambda cfg: dataclasses.replace(
        cfg, attn_score_dtype="bfloat16"),
    # MoE dispatch via scatter/gather instead of one-hot einsums
    "scattermoe": lambda cfg: dataclasses.replace(
        cfg, moe_dispatch="scatter") if cfg.moe else cfg,
    # remat policy: save matmul outputs instead of recomputing everything
    "dotsremat": lambda cfg: dataclasses.replace(cfg, remat="block_dots"),
    # skip fully-masked causal kv chunks (exact)
    "causalskip": lambda cfg: dataclasses.replace(cfg, causal_skip=True),
    # pad attention heads up to the TP degree so they shard 16-way
    "padheads": lambda cfg: dataclasses.replace(
        cfg, n_heads=-(-cfg.n_heads // 16) * 16,
        n_kv_heads=16 if cfg.n_kv_heads % 16 else cfg.n_kv_heads)
    if (cfg.n_heads % 16 or cfg.n_kv_heads % 16) else cfg,
    # capacity factor 1.25 -> 1.0
    "cap1": lambda cfg: dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    if cfg.moe else cfg,
    # the combined configuration (dotsremat on train cells only)
    "opt": lambda cfg: VARIANTS["padheads"](VARIANTS["causalskip"](
        VARIANTS["cap1"](VARIANTS["dotsremat"](VARIANTS["scattermoe"](cfg))))),
}
# ModelConfig fields the port's model does not read: a variant that sets
# one would measure the baseline under another tag (the port reads
# scan_layers: attention's chunk sizes follow it, as the reference's do)
IGNORED_FIELDS = ("ip_budget",)


class VariantIgnoredError(ValueError):
    """A variant changes a config field the port's model ignores."""


def apply_variant(cfg, variant: str):
    new = VARIANTS[variant](cfg)
    for f in IGNORED_FIELDS:
        if getattr(new, f) != getattr(cfg, f):
            raise VariantIgnoredError(
                f"variant {variant!r} sets {f}={getattr(new, f)!r}, which "
                f"the port's model ignores: it would measure the baseline")
    return new


def ok_record(record: dict, cfg, shape, mesh, policy, main: dict,
              tot: dict, cal: dict) -> dict:
    """``record`` completed with a measured step (``summarize``'s
    ``main``, totals ``tot`` a device) and its roofline at the H100's
    rates."""
    chips = mesh.size
    mf = model_flops(cfg, shape)
    sizes = mesh_axis_sizes(mesh)
    tp = sizes.get("model", 1)
    dp = chips // tp
    min_hbm, min_coll = ideal_traffic(cfg, shape, dp, tp, chips,
                                      fsdp=policy.fsdp)
    roof = Roofline(flops=tot["flops"] * chips,
                    hbm_bytes=tot["bytes_accessed"] * chips,
                    coll_bytes=tot["collectives"]["total"] * chips,
                    chips=chips, model_flops=mf,
                    min_hbm_bytes=min_hbm, min_coll_bytes=min_coll)
    record.update(
        status="ok", chips=chips, trace_s=main["trace_s"],
        static_bytes_per_device=main["static_bytes_per_device"],
        memory=main["memory"],
        busiest_device=main["busiest_device"],
        step={"flops": main["flops"],
              "bytes_accessed": main["bytes_accessed"],
              "collectives": tot["collectives"],
              "collective_counts": main["collectives"]["counts"],
              "aten_ops": main["aten_ops"],
              "aten_op_count": main["aten_op_count"],
              "kernels": main["kernels"],
              "reused_ranks": main["reused_ranks"]},
        collective_bytes_by_rank=main["collective_bytes_by_rank"],
        calibration=cal,
        totals_per_device=tot,
        roofline=roof.as_dict(),
    )
    return record


def totals(main: dict) -> dict:
    """A measured step's per-device totals (the reference's
    ``totals_per_device``)."""
    return {"flops": main["flops"], "bytes_accessed": main["bytes_accessed"],
            "collectives": {k: v for k, v in main["collectives"].items()
                            if k != "counts"}}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             force: bool = False, policy=ShardingPolicy(),
             tag: str = "", calibrate: bool = True,
             variant: str = "") -> dict:
    mesh_name = "multi" if multi_pod else "single"
    if variant and not tag:
        tag = variant
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    out_path = out_dir / f"{cell_id}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    record = {"cell": cell_id, "arch": arch, "shape": shape_name,
              "mesh": mesh_name, "tag": tag or "baseline"}
    try:
        if variant:
            cfg = apply_variant(cfg, variant)
            if variant == "opt" and shape.kind != "train" \
                    and cfg.remat == "block_dots":
                # saving dot outputs is pure overhead without a backward
                cfg = dataclasses.replace(cfg, remat="block")
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            record.update(status="skipped", reason=why)
            out_path.write_text(json.dumps(record, indent=2))
            return record

        mesh = make_production_mesh(
            multi_pod=multi_pod, devices=["meta"] * (512 if multi_pod
                                                     else 256))
        if cfg.fsdp and not policy.fsdp:
            policy = dataclasses.replace(policy, fsdp=True)
        main = _measure(cfg, shape_name, mesh, policy)
        tot = totals(main)
        if calibrate:
            c1, c2, n_groups = _calibration_cfgs(cfg)
            m1 = _measure(c1, shape_name, mesh, policy)
            m2 = _measure(c2, shape_name, mesh, policy)
            if m1["busiest_device"] != main["busiest_device"] or \
                    m2["busiest_device"] != main["busiest_device"]:
                raise RuntimeError("the 1- and 2-group configs' busiest "
                                   "device differs from the full config's")
            ext = _extrapolate(m1, m2, n_groups)
            why = calibration_check(tot, ext)
            if why:
                raise RuntimeError(f"extrapolated totals differ from the "
                                   f"full-depth count: {why}")
            cal = {"n_groups": n_groups, "cal1_trace_s": m1["trace_s"],
                   "cal2_trace_s": m2["trace_s"], "extrapolated": ext,
                   "bytes_extrapolated_minus_full":
                       ext["bytes_accessed"] - tot["bytes_accessed"]}
        else:
            cal = {"n_groups": None}

        ok_record(record, cfg, shape, mesh, policy, main, tot, cal)
    except Exception as e:  # the sweep records a failed cell and goes on
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    out_path.write_text(json.dumps(record, indent=2))
    return record


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="multi-pod dry-run (meta)")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--variant", default="", choices=[""] + list(VARIANTS))
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = ARCH_NAMES if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    policy = ShardingPolicy(fsdp=args.fsdp)

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                t0 = time.time()
                rec = run_cell(arch, shape, multi, out_dir,
                               force=args.force, policy=policy, tag=args.tag,
                               calibrate=not args.no_calibrate,
                               variant=args.variant)
                dt = time.time() - t0
                status = rec["status"]
                n_ok += status == "ok"
                n_skip += status == "skipped"
                n_err += status == "error"
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    mem = rec["memory"]
                    extra = (f"dom={r['dominant']:<10s} "
                             f"frac={r['roofline_fraction']:.3f} "
                             f"mem/dev={rec['static_bytes_per_device']/2**30:.2f}GiB "
                             f"temp={mem['temp_size_in_bytes']/2**30:.2f}GiB "
                             f"trace={rec['trace_s']:.1f}s")
                elif status == "error":
                    extra = rec["error"][:120]
                print(f"[{status:>7s}] {rec['cell']:<55s} {dt:6.1f}s {extra}",
                      flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors", flush=True)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
