"""Collectives of the single controller: one Python process owns every
device of a mesh, as the reference's ``shard_map`` does.

Replaces ``repro/distributed/collectives.py`` and the ``lax`` collectives
its sharded executor calls inside ``shard_map``.  Under the single
controller a sharded value is a list of per-device tensors, one per rank
in mesh order, each on its rank's device; every collective here takes
such a list and returns one tensor per rank on that rank's device.  The
copies between ranks are ``Tensor.to(device)``: peer copies between
cards, and no copy at all where two logical devices share one card.  No
collective moves a CUDA tensor to the CPU to compute.

* ``all_gather(blocks, dim)`` — the tiled all-gather: every rank gets
  the blocks concatenated along ``dim`` in rank order;
  ``all_to_all(parts, dim, ranks)`` — rank m gets block m of every
  rank's part (or of every part of other ranks, ``devices=``).
* ``psum(parts)`` — the all-reduce, summed in rank order
  ((p0 + p1) + p2 ...) once and copied to every rank, so every rank
  holds bitwise the same sum.
* ``ring_all_reduce(parts)`` — the reference's ring schedule, hop for
  hop: the flat tensor padded to ``n`` chunks, ``n - 1`` reduce-scatter
  hops in which rank ``j`` sends chunk ``(j - i) % n`` to rank
  ``j + 1``, which adds it into its own copy, then ``n - 1`` all-gather
  hops that circulate the reduced chunks.  Each chunk's f32 additions
  come in the reference's order.
* ``bucketed_psum(trees, n_buckets=4)`` — a pytree (dicts, lists,
  tuples of tensors) all-reduced leaf by leaf in buckets of the
  reference's greedy balance (largest leaves first, each into the
  lightest bucket).

Counting (``launch/dryrun.py``).  Under ``counting(counter)`` every move
the single controller makes between logical ranks is recorded as a
``CollectiveEvent`` on the rank that receives it, by logical rank and
not by ``torch.device`` (logical devices of one card, or ``meta``
devices, share one device and copy nothing).  The kinds, in the
reference's names:

* ``tensor_parallel.take_region`` of a region held in g > 1 distinct
  blocks: an all-gather (result the region, group g); a region that no
  position of the rank's model coordinate holds: a collective-permute;
  a block the rank holds moves nothing;
* ``all_gather`` here: an all-gather (result the concatenation, group
  the ranks); ``all_to_all``: an all-to-all (result the stacked
  blocks); ``psum``, ``ring_all_reduce`` and ``bucketed_psum``'s
  leaves: an all-reduce of each rank's part (operand = result; the
  ring's hops are its schedule, not separate events);
* ``tensor_parallel.ZeroPass.land``: a layer group's gradient cut onto
  the FSDP blocks it was gathered from, a reduce-scatter recorded on the
  gathering rank (result its own block's part, group the blocks);
* ``tensor_parallel.spread`` (q and new rows to the holders of a
  sequence-split cache) and ``attention.merge_partials``' partials to
  the stream's rank: collective-permutes;
* ``distributed/shard_train.py``: each gradient piece to its block's
  holder, each block's square sum to the first rank, each piece of a
  landed gradient's ``adamw.BLOCK`` run to the norm's holder, and each
  updated block's slice of its summed gradient to the block, point to
  point: collective-permutes.

``on_rank(i)`` names the logical rank the work inside it runs on, so a
counter can attribute ops to devices; ``rank_work`` runs one share of a
step (a data rank's pass over its model ranks, a block's update) and
``sections`` one split sublayer's model ranks through the counter,
which may answer work of a shape it has seen with that work's counts
and outputs (the dry-run on ``meta`` tensors does, and says so).
Without an active counter these cost a check.

The model group (Megatron tensor parallelism, ``tensor_parallel.py``).
The model ranks of one data rank share a replicated residual stream,
kept on the first model rank's device; a split sublayer runs its part
on each model rank.  Three ``autograd.Function``s join them, each
recording all-reduces of group = the model degree on every rank:

* ``model_sum(parts, ranks)`` — the row-parallel output: the ranks'
  parts summed in rank order onto the first one's device (forward
  all-reduce); its backward hands each rank the gradient (the sum is
  replicated: nothing moves).
* ``replicate(x, ranks, devices)`` — the column-parallel input: ``x``
  on every rank's device (replicated: nothing moves); its backward sums
  the ranks' gradients in rank order (backward all-reduce).
* ``model_max(parts, ranks)`` — the elementwise max of the ranks'
  parts (the vocabulary-parallel softmax's shift), no gradient.

``enter(rank, ...)`` / ``leave(rank, ...)`` bracket one rank's section
of a split sublayer.  Forward they are the identity; backward, ``leave``
names the rank the section's backward runs on and ``enter`` ends it, so
the backward's ops are counted on the rank whose forward made them.
This holds where one thread runs the backward in creation order,
latest first (the CPU, ``meta`` and one card's logical devices): a
section's nodes are created after its ``enter`` and before its
``leave``, and a section takes every differentiable input through
``enter``, so its backward runs whole between the two.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch


class CollectiveEvent(NamedTuple):
    """One move: ``kind`` (the reference's collective names),
    ``result_bytes`` (the receiving rank's result), ``group`` (ranks
    taking part) and ``rank`` (the logical rank that receives; None
    outside ``on_rank``)."""
    kind: str
    result_bytes: int
    group: int
    rank: Optional[int]


class CollectiveCounter:
    """Records the moves between logical ranks while ``counting``.
    ``rank_work`` runs a rank's share of the step and ``sections`` a
    split sublayer's model ranks as given; a subclass may answer work
    from earlier work of the same shape."""

    def __init__(self):
        self.events: List[CollectiveEvent] = []

    def record(self, event: CollectiveEvent) -> None:
        self.events.append(event)

    def rank_work(self, key, ranks: List[int], fn: Callable[[], Any]):
        return fn()

    def sections(self, ranks: List[int], section: Callable, inputs: list
                 ) -> list:
        return [section(m, xs) for m, xs in enumerate(inputs)]


_COUNTER: List[CollectiveCounter] = []
_RANKS: List[int] = []


@contextlib.contextmanager
def counting(counter: CollectiveCounter):
    """Record the moves made inside into ``counter`` (one counter at a
    time)."""
    if _COUNTER:
        raise RuntimeError("a collective counter is already active")
    _COUNTER.append(counter)
    try:
        yield counter
    finally:
        _COUNTER.pop()


class _Backward(int):
    """A rank ``leave`` names for a section's backward (``enter`` takes
    it off)."""


@contextlib.contextmanager
def on_rank(rank: int):
    """The work inside runs on logical rank ``rank`` (a mesh position
    in ``mesh.devices.flat`` order)."""
    depth = len(_RANKS)
    _RANKS.append(int(rank))
    try:
        yield
    finally:
        del _RANKS[depth:]


def current_rank() -> Optional[int]:
    return int(_RANKS[-1]) if _RANKS else None


def record(kind: str, result_bytes: int, group: int,
           rank: Optional[int] = None) -> None:
    """Record one move on ``rank`` (default: the current rank) if a
    counter is active."""
    if _COUNTER:
        _COUNTER[0].record(CollectiveEvent(
            kind, int(result_bytes), int(group),
            current_rank() if rank is None else int(rank)))


def rank_work(key, rank: int, fn: Callable[[], Any],
              ranks: Optional[Sequence[int]] = None):
    """``fn()``, one share of a step, on logical rank ``rank`` (and
    ``ranks``, every rank it runs on, ``rank`` among them; default
    ``[rank]``); an active counter may answer a ``key`` it has seen
    with that work's outputs, its ranks mapped position by position."""
    ranks = [int(rank)] if ranks is None else [int(r) for r in ranks]
    with on_rank(rank):
        if _COUNTER:
            return _COUNTER[0].rank_work(key, ranks, fn)
        return fn()


def sections(ranks: Sequence[int], section: Callable, inputs: list) -> list:
    """``section(m, inputs[m])`` for each model rank ``m`` of a split
    sublayer, in rank order: one output tuple a rank.  An active counter
    may answer a rank's section from another rank's of the same shapes
    (the dry-run on ``meta`` does, and says so)."""
    if _COUNTER:
        return _COUNTER[0].sections([int(r) for r in ranks], section,
                                    inputs)
    return [section(m, xs) for m, xs in enumerate(inputs)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _check(parts: Sequence[torch.Tensor], what: str) -> None:
    if not parts:
        raise ValueError(f"{what} needs one tensor per rank, got none")
    shape = parts[0].shape
    for r, p in enumerate(parts):
        if p.shape != shape or p.dtype != parts[0].dtype:
            raise ValueError(
                f"{what}: rank {r} holds {tuple(p.shape)} {p.dtype}, rank 0 "
                f"{tuple(shape)} {parts[0].dtype}")


def all_gather(blocks: Sequence[torch.Tensor], dim: int,
               ranks: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """The blocks concatenated along ``dim`` in rank order, on every
    rank's device (``lax.all_gather(..., tiled=True)``); ``ranks`` the
    blocks' logical ranks (default their positions), each result made
    on its rank."""
    if not blocks:
        raise ValueError("all_gather needs one block per rank, got none")
    ranks = range(len(blocks)) if ranks is None else ranks
    out = []
    for rank, mine in zip(ranks, blocks):
        with on_rank(rank):
            o = torch.cat([b.to(mine.device) for b in blocks], dim=dim)
        record("all-gather", _nbytes(o), len(blocks), rank)
        out.append(o)
    return out


def all_to_all(parts: Sequence[torch.Tensor], dim: int,
               ranks: Sequence[int], devices: Optional[Sequence] = None
               ) -> List[torch.Tensor]:
    """Each part cut into one block a receiving rank along ``dim``:
    receiver m gets block m of every part, stacked in the parts' order
    along a new first dim, on its device.  The receivers are ``ranks``
    on ``devices``; without ``devices`` they are the parts' own ranks
    (``ranks``, one a part) and devices."""
    if devices is None:
        devices = [p.device for p in parts]
    out = []
    for m, (rank, dev) in enumerate(zip(ranks, devices)):
        with on_rank(rank):
            o = torch.stack([p.chunk(len(ranks), dim=dim)[m].to(dev)
                             for p in parts])
        record("all-to-all", _nbytes(o), len(parts), rank)
        out.append(o)
    return out


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the ranks' tensors in rank order, bitwise the same on
    every rank's device."""
    _check(parts, "psum")
    for r, p in enumerate(parts):
        record("all-reduce", _nbytes(p), len(parts), r)
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    if len(parts) == 1:
        total = total.clone()
    return [total if r == 0 else total.to(p.device, copy=True)
            for r, p in enumerate(parts)]


# ---------------------------------------------------------------------------
# The model group (tensor parallelism)
# ---------------------------------------------------------------------------
def _record_group(kind: str, parts: Sequence[torch.Tensor],
                  ranks: Sequence[int]) -> None:
    for p, r in zip(parts, ranks):
        record(kind, _nbytes(p), len(ranks), r)


def _rank_order_sum(parts: Sequence[torch.Tensor], rank: int):
    with on_rank(rank):
        dev = parts[0].device
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(dev)
        return total.clone() if len(parts) == 1 else total


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ranks, *parts):
        _check(parts, "model_sum")
        ctx.devices = [p.device for p in parts]
        _record_group("all-reduce", parts, ranks)
        return _rank_order_sum(parts, ranks[0])

    @staticmethod
    def backward(ctx, grad):
        return (None,) + tuple(grad.to(d) for d in ctx.devices)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ranks, devices, x):
        ctx.ranks = ranks
        return tuple(x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        _record_group("all-reduce", grads, ctx.ranks)
        return None, None, _rank_order_sum(grads, ctx.ranks[0])


class _ModelMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ranks, *parts):
        _check(parts, "model_max")
        _record_group("all-reduce", parts, ranks)
        with on_rank(ranks[0]):
            dev = parts[0].device
            out = parts[0].clone()
            for p in parts[1:]:
                out = torch.maximum(out, p.to(dev))
        ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError("model_max has no gradient")


def model_sum(parts: Sequence[torch.Tensor],
              ranks: Sequence[int]) -> torch.Tensor:
    """The model ranks' parts summed in rank order on the first part's
    device (the all-reduce after a row-parallel product; its value is
    every rank's)."""
    return _ModelSum.apply(tuple(int(r) for r in ranks), *parts)


def replicate(x: torch.Tensor, ranks: Sequence[int],
              devices: Sequence) -> List[torch.Tensor]:
    """``x``, replicated over the model ranks, on each rank's device
    (the column-parallel input); the backward sums the ranks' gradients
    in rank order (an all-reduce)."""
    return list(_Replicate.apply(tuple(int(r) for r in ranks),
                                 tuple(torch.device(d) for d in devices),
                                 x))


def model_max(parts: Sequence[torch.Tensor],
              ranks: Sequence[int]) -> torch.Tensor:
    """The elementwise max of the model ranks' parts, in rank order, on
    the first part's device (an all-reduce; no gradient)."""
    return _ModelMax.apply(tuple(int(r) for r in ranks),
                           *[p.detach() for p in parts])


def _differentiable(t) -> bool:
    return isinstance(t, torch.Tensor) and (t.is_floating_point()
                                            or t.is_complex())


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rank, *xs):
        ctx.rank = rank
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if _RANKS and isinstance(_RANKS[-1], _Backward) and \
                int(_RANKS[-1]) == ctx.rank:
            _RANKS.pop()
        return (None,) + grads


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rank, *xs):
        ctx.rank = rank
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        _RANKS.append(_Backward(ctx.rank))
        return (None,) + grads


def _through(fn, rank: int, xs: Sequence) -> list:
    xs = list(xs)
    idx = [i for i, x in enumerate(xs) if _differentiable(x)
           and x.requires_grad]
    if idx:
        out = fn.apply(int(rank), *[xs[i] for i in idx])
        for i, o in zip(idx, out):
            xs[i] = o
    return xs


def enter(rank: int, *xs) -> list:
    """The start of rank ``rank``'s section of a split sublayer: ``xs``
    as they are (those that require a gradient as views), their backward
    the section's end.  A tensor that needs none stays out: an
    ``autograd.Function``'s outputs all require a gradient when one
    input does, and a backward would then run for it."""
    return _through(_Enter, rank, xs)


def leave(rank: int, *xs) -> list:
    """The end of rank ``rank``'s section: ``xs`` as they are; their
    backward runs on ``rank`` until the section's ``enter``."""
    return _through(_Leave, rank, xs)


def ring_all_reduce(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The all-reduce as the reference's ring schedules it (reduce-scatter
    then all-gather, one chunk a hop to the next rank): equal to
    ``psum`` up to the order of each chunk's additions, which is the
    reference's."""
    _check(parts, "ring_all_reduce")
    n = len(parts)
    for r, p in enumerate(parts):
        record("all-reduce", _nbytes(p), n, r)
    if n == 1:
        return [parts[0].clone()]
    shape = parts[0].shape
    size = parts[0].numel()
    pad = (-size) % n
    flat = [torch.nn.functional.pad(p.reshape(-1), (0, pad)).reshape(n, -1)
            for p in parts]
    # reduce-scatter: after n - 1 hops rank j holds chunk (j + 1) % n summed
    for i in range(n - 1):
        sent = [flat[j][(j - i) % n].clone() for j in range(n)]
        for r in range(n):
            tgt = (r - i - 1) % n
            flat[r][tgt] = flat[r][tgt] + sent[(r - 1) % n].to(
                flat[r].device)
    # all-gather: each rank's reduced chunk circulates n - 1 times
    for i in range(n - 1):
        sent = [flat[j][(j + 1 - i) % n].clone() for j in range(n)]
        for r in range(n):
            flat[r][(r - i) % n] = sent[(r - 1) % n].to(flat[r].device)
    out = []
    for f in flat:
        f = f.reshape(-1)
        if pad:
            f = f[:size]
        out.append(f.reshape(shape))
    return out


def _flatten(tree: Any, leaves: list):
    """The tree's structure with its tensors replaced by their index in
    ``leaves`` (appended in order)."""
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    leaves.append(tree)
    return len(leaves) - 1


def _unflatten(struct: Any, leaves: list):
    if isinstance(struct, dict):
        return {k: _unflatten(v, leaves) for k, v in struct.items()}
    if isinstance(struct, (list, tuple)):
        return type(struct)(_unflatten(v, leaves) for v in struct)
    return leaves[struct]


def bucketed_psum(trees: Sequence[Any], *, n_buckets: int = 4) -> List[Any]:
    """All-reduce one pytree per rank in ``n_buckets`` groups of leaves,
    the groups balanced greedily by size (the reference's order); every
    leaf is ``psum``'s sum in rank order."""
    if not trees:
        raise ValueError("bucketed_psum needs one tree per rank, got none")
    flat = []
    structs = []
    for tree in trees:
        leaves: list = []
        structs.append(_flatten(tree, leaves))
        flat.append(leaves)
    if any(s != structs[0] for s in structs):
        raise ValueError("bucketed_psum: the ranks' trees differ in "
                         "structure")
    leaves0 = flat[0]
    order = sorted(range(len(leaves0)), key=lambda i: -leaves0[i].numel())
    buckets = [[] for _ in range(n_buckets)]
    sizes = [0] * n_buckets
    for i in order:  # greedy balance
        b = sizes.index(min(sizes))
        buckets[b].append(i)
        sizes[b] += leaves0[i].numel()
    out = [[None] * len(leaves0) for _ in trees]
    for idxs in buckets:
        for i in idxs:
            for r, reduced in enumerate(psum([f[i] for f in flat])):
                out[r][i] = reduced
    return [_unflatten(s, leaves) for s, leaves in zip(structs, out)]
