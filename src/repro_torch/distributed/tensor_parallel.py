"""Megatron tensor parallelism on the single controller: what GSPMD
derives from ``param_spec`` in the reference (``repro/distributed/
sharding.py:1-19``: heads and FFN hidden over "model", column-parallel
in, row-parallel out), as the port's model ranks compute it.

A data rank of a ("data", "model") mesh has ``tp`` model ranks, its
``ModelGroup``: their mesh positions and devices, in model-coordinate
order.  The residual stream is replicated over them and kept on the
first one's device (the data rank's device); each sublayer that
``param_spec`` splits over "model" runs on every model rank on that
rank's block only, and its output is the rank-order sum of the ranks'
outputs (``collectives.model_sum``).  The split sublayers:

* attention (``attn``, the encoder-decoder's ``self_attn`` and
  ``cross_attn``) when the query heads divide ``tp``: each rank its
  heads' columns of ``wq``, ``wk``, ``wv`` and rows of ``wo``.  Where
  the kv heads do not divide ``tp`` (``wk``/``wv`` replicated) a rank
  takes the kv heads its query heads use (``kv_heads``);
* the dense FFN (``ffn``) when ``d_ff`` divides: ``w_gate``/``w_up``/
  ``w_in`` columns, ``w_down`` rows;
* Mamba (``mamba``) when ``d_inner`` divides: a rank's ``d_inner``
  channels of every leaf.  ``in_proj`` (D, 2 di) is stored in
  contiguous column blocks (with tp = 2 rank 0 holds all of x1 and none
  of z), so a rank's x1 and z columns [r di/tp, (r+1) di/tp) are moved
  to it (collective-permutes);
* the MoE experts (``moe/experts``): by expert where the experts
  divide ``tp`` (expert parallelism: a rank's ``E / tp`` experts of
  every leaf), else by each expert's hidden columns where ``d_ff``
  divides (``w_gate``/``w_up``/``w_in`` columns, ``w_down`` rows).  The
  router is replicated and the routing runs once, on the stream's
  device (``moe.apply_moe``);
* RWKV's time-mix (``rwkv_tm``) when ``D`` divides ``tp`` (``param_spec``
  splits ``w_r``/``w_k``/``w_v``/``w_g`` by columns and ``w_o`` by
  rows): each rank runs whole heads, rank m the heads [m H / tp,
  (m + 1) H / tp) (``rwkv_heads``; floors), their columns of every
  product, of ``w_lora_b`` and ``w0``, their rows of ``u`` and ``w_o``.
  Where the heads divide ``tp`` these are the rank's stored blocks;
  elsewhere (rwkv6-3b's 40 heads on 16: 2 and 3 a rank) a rank's heads
  straddle at most two stored blocks, and it takes one region a block,
  so only the columns it lacks move (collective-permutes), and a rank
  that owns no head (``tp`` > H) computes nothing of it.  The token
  shift's mixes and ``w_lora_a`` stay whole on the first rank (the
  stream's);
* RWKV's channel-mix (``rwkv_cm``) when ``d_ff`` divides: ``w_k``
  columns, ``w_v`` rows (its mixes and the replicated ``w_r`` gate are
  the stream's);
* the vocabulary: ``embed`` split by rows (each rank looks up its range
  and writes zeros elsewhere), ``lm_head`` (or the tied ``embed``) by
  columns, and the loss vocabulary-parallel (``blocks.softmax_xent``).

Everything else — norms, the router — runs whole on the first model
rank, its leaves gathered there as the unsplit step gathers them.  A
decode cache that ``cache_pspecs`` splits by sequence over "model" (the
kv heads do not divide ``tp``; the frozen cross-attention cache too) is
a ``SeqSplit`` over the ranks that hold its blocks — the data rank's
model ranks, or every (data, model) rank where the sequence is also
sharded over the data axes (a batch of 1) — and stays where it lies,
whether or not the attention splits: each holder attends over its
block (``attention._seq_split_decode_attn``, ``encdec.
_seq_split_cross_attn``); ``collectives.all_gather`` and ``spread``
move q and the new rows to the holders, and the softmax partials come
back to the heads' ranks (an all-to-all), merged in block order.
RWKV's state, replicated over "model", is read by each head owner from
its own replica, and the new state's heads are gathered.

``rank_params(cfg, params, mesh, d)`` gives data rank ``d``'s compute
tree: the params' tree with a ``Split`` (one subtree a model rank, on
that rank's device) at each split sublayer and the vocabulary leaves,
and whole leaves elsewhere.  It gathers over "data" only what FSDP
split (an all-gather on the receiving rank) and moves a block another
model coordinate holds (a collective-permute).  A layer-stack leaf
that FSDP splits is not gathered there: the tree holds a ``Deferred``
gather of it, which ``gather_group`` runs for one layer group inside
the group's (rematerialized) body, and whose backward lands the
group's gradient on the FSDP blocks (``ZeroPass``, ``ShardGrads``: a
reduce-scatter).  ``block_grads`` takes the pass's other gradients back
to each leaf's *model blocks* — the leaf's blocks along "model", whole
along the data axes — on the block's holder, the first data rank's
position at that model coordinate.  With ``tp`` = 1 a leaf is one
block on the first data rank's position: the unsplit step's gradients,
bitwise.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (ShardedTensor, ShardingPolicy,
                                              _key, param_spec)
from repro_torch.launch.mesh import dp_axes, mesh_axis_sizes

# sublayer dicts that split over "model" when their spec splits
ATTN_KEYS = ("attn", "self_attn", "cross_attn")
# the layer stacks: leaves with a leading group (or layer) axis
STACKS = ("blocks", "enc_blocks", "dec_blocks")
# the RWKV leaves the stream's device holds whole (the token shift's
# mixes, the decay LoRA's first product, the channel-mix's gate)
RWKV_STREAM = {"rwkv_tm": ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g",
                           "w_lora_a"),
               "rwkv_cm": ("mix_k", "mix_r", "w_r")}


class ModelGroup(NamedTuple):
    """The model ranks of one data rank: mesh positions and devices in
    model-coordinate order; the first holds the residual stream."""
    ranks: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    @property
    def tp(self) -> int:
        return len(self.ranks)


class Split:
    """A value split over a ``ModelGroup``: ``parts[m]`` (a tensor or a
    dict of them) on ``group.devices[m]``."""
    __slots__ = ("group", "parts")

    def __init__(self, group: ModelGroup, parts: Sequence):
        if len(parts) != group.tp:
            raise ValueError(f"{len(parts)} parts for {group.tp} model "
                             f"ranks")
        self.group = group
        self.parts = list(parts)

    def like(self, parts: Sequence) -> "Split":
        """``parts`` split as this value is (its class and group)."""
        return type(self)(self.group, parts)

    def __getitem__(self, key) -> "Split":
        return self.like([p[key] for p in self.parts])

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(tp={self.group.tp}, "
                f"ranks={self.group.ranks})")


class SeqSplit(Split):
    """A decode cache (G, B, S, Hkv, Dh) split by sequence over the ranks
    that hold its blocks, in sequence order: ``parts[b]`` holds
    positions [b S/n, (b+1) S/n) of every kv head (``cache_pspecs``'
    layout where the kv heads do not divide the model degree).  Its
    ``group`` is a data rank's ``ModelGroup`` where the sequence is
    sharded over "model", or every (data, model) rank, data-major, where
    it is sharded over both."""
    __slots__ = ()


def smap(fn, x):
    """``fn`` over a ``Split``'s parts, each on its model rank
    (``collectives.on_rank``; a ``Split`` back), or ``fn(x)``."""
    if isinstance(x, Split):
        parts = []
        for rank, p in zip(x.group.ranks, x.parts):
            with collectives.on_rank(rank):
                parts.append(fn(p))
        return x.like(parts)
    return fn(x)


def group_of(tree) -> Optional[ModelGroup]:
    """The ``ModelGroup`` of the first ``Split`` in ``tree``, or None."""
    if isinstance(tree, Split):
        return tree.group
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            g = group_of(v)
            if g is not None:
                return g
    return None


# ---------------------------------------------------------------------------
# Running a split sublayer
# ---------------------------------------------------------------------------
def _flat(part) -> Tuple[list, Any]:
    if isinstance(part, dict):
        return list(part.values()), list(part)
    if part is None:
        return [], None
    return [part], ()


def _unflat(leaves: list, keys):
    if keys is None:
        return None
    if keys == ():
        return leaves[0]
    return dict(zip(keys, leaves))


def run(group: ModelGroup, parts, fn, *args) -> List[tuple]:
    """``fn(m, parts[m], *args_m)`` on each model rank ``m``, in rank
    order, under ``collectives.on_rank``, each rank's section closed by
    ``collectives.enter``/``leave`` (through ``collectives.sections``).
    An argument that is a tensor (on the stream's device) is replicated
    over the ranks (``collectives.replicate``: the column-parallel
    input), a list is one value a rank.  ``fn`` returns a tensor or a
    tuple of them (None allowed); one tuple a rank comes back."""
    parts = [None] * group.tp if parts is None else parts
    per = [collectives.replicate(a, group.ranks, group.devices)
           if isinstance(a, torch.Tensor) else list(a) for a in args]
    n = len(per)
    flat = [_flat(p) for p in parts]

    def section(m, xs):
        rank = group.ranks[m]
        with collectives.on_rank(rank):
            xs = collectives.enter(rank, *xs)
            out = fn(m, _unflat(xs[n:], flat[m][1]), *xs[:n])
            out = out if isinstance(out, tuple) else (out,)
            return tuple(collectives.leave(rank, *out))

    return collectives.sections(group.ranks, section, [
        [a[m] for a in per] + flat[m][0] for m in range(group.tp)])


def reduce(group: ModelGroup, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The row-parallel outputs summed in rank order onto the stream's
    device (``collectives.model_sum``)."""
    return collectives.model_sum(parts, group.ranks)


def spread(values: Sequence[torch.Tensor], src: Sequence[int],
           dst: ModelGroup) -> List[torch.Tensor]:
    """``values[j]`` (on rank ``src[j]``) on every rank of ``dst``: a rank
    of ``src`` keeps its own, any other rank b gets the value of
    ``src[b % len(src)]`` (its model coordinate where ``dst`` runs over
    (data, model) in that order), a collective-permute."""
    out = []
    for b, (rank, dev) in enumerate(zip(dst.ranks, dst.devices)):
        if rank in src:
            out.append(values[list(src).index(rank)])
            continue
        v = values[b % len(src)]
        with collectives.on_rank(rank):
            out.append(v.to(dev, copy=True))
        collectives.record("collective-permute",
                           v.numel() * v.element_size(), 2, rank)
    return out


@dataclasses.dataclass
class VocabShards:
    """Logits split over the vocabulary: ``parts[m]`` holds rank m's
    columns [m V/tp, (m+1) V/tp) on its device."""
    group: ModelGroup
    parts: List[torch.Tensor]


def gathered(logits):
    """Logits whole on the stream's device: ``VocabShards``' parts
    concatenated (an all-gather there), any other value as it is."""
    if not isinstance(logits, VocabShards):
        return logits
    g = logits.group
    with collectives.on_rank(g.ranks[0]):
        out = torch.cat([p.to(g.devices[0]) for p in logits.parts], dim=-1)
    collectives.record("all-gather", out.numel() * out.element_size(),
                       g.tp, g.ranks[0])
    return out


def q_heads(cfg: ModelConfig, tp: int, m: int) -> Tuple[int, int]:
    """Model rank ``m``'s query heads [lo, hi)."""
    n = cfg.n_heads // tp
    return m * n, (m + 1) * n


def kv_heads(cfg: ModelConfig, tp: int, m: int) -> Tuple[int, int]:
    """The kv heads [lo, hi) that model rank ``m``'s query heads use: its
    block of them where they divide ``tp``, else the heads its query
    heads map to (GQA group ``n_heads // n_kv_heads``).  Raises where
    the rank's query heads do not group evenly over them."""
    g = cfg.n_heads // cfg.n_kv_heads
    q0, q1 = q_heads(cfg, tp, m)
    k0, k1 = q0 // g, (q1 - 1) // g + 1
    if k1 - k0 > 1 and (q0 % g or (q1 - q0) % g):
        raise ValueError(
            f"{cfg.name}: model rank {m} of {tp} holds query heads "
            f"[{q0}, {q1}), which do not group evenly over kv heads "
            f"[{k0}, {k1}) (GQA group {g})")
    return k0, k1


def rwkv_heads(cfg: ModelConfig, tp: int, m: int) -> Tuple[int, int]:
    """Model rank ``m``'s RWKV heads [lo, hi) = [floor(m H / tp),
    floor((m + 1) H / tp)): whole heads, its stored block's where the
    heads divide ``tp``; none where ``tp`` exceeds them and the floors
    meet."""
    H = cfg.d_model // cfg.rwkv.head_size
    return m * H // tp, (m + 1) * H // tp


def head_owners(cfg: ModelConfig, tp: int) -> List[int]:
    """The model ranks that own at least one RWKV head."""
    return [m for m in range(tp) if rwkv_heads(cfg, tp, m)[1]
            > rwkv_heads(cfg, tp, m)[0]]


# ---------------------------------------------------------------------------
# The compute blocks of a data rank
# ---------------------------------------------------------------------------
def model_positions(mesh) -> List[List[int]]:
    """Mesh positions (``mesh.devices.flat`` order) by [data rank][model
    coordinate]: data ranks in dp-axes order (the first major), model
    coordinates in order (one where the mesh has no "model" axis)."""
    names = list(mesh.axis_names)
    flat = np.arange(mesh.size).reshape(mesh.devices.shape)
    dpx = dp_axes(mesh)
    order = [names.index(a) for a in dpx]
    order += [names.index("model")] if "model" in names else []
    rest = [i for i in range(len(names)) if i not in order]
    # axes outside dp and model sit at coordinate 0
    flat = flat[tuple(slice(None) if i in order else 0
                      for i in range(len(names)))]
    kept = [i for i in range(len(names)) if i not in rest]
    flat = np.transpose(flat, [kept.index(i) for i in order])
    tp = mesh_axis_sizes(mesh).get("model", 1)
    return [[int(v) for v in row] for row in flat.reshape(-1, tp)]


def model_group(mesh, d: int) -> ModelGroup:
    """Data rank ``d``'s model ranks."""
    pos = model_positions(mesh)[d]
    return ModelGroup(tuple(pos), tuple(mesh.devices.flat[i] for i in pos))


@dataclasses.dataclass
class LeafPlan:
    """How one leaf is computed on a data rank's model ranks:
    ``pieces[m]`` the regions of the whole leaf model rank m holds,
    concatenated along ``dim`` (None: the rank holds nothing of it);
    ``blocks`` the leaf's model blocks (one where it is not split over
    "model") and ``node`` the tree path its ``Split`` sits at (None:
    whole on the first model rank).  ``per_group``: a leaf of a layer
    stack that FSDP splits over the data axes, gathered a layer group
    at a time (``Deferred``) and its gradient landed on its blocks
    (``ShardGrads``)."""
    path: str
    shape: Tuple[int, ...]
    node: Optional[str]
    dim: int
    pieces: List[Optional[List[Tuple[slice, ...]]]]
    blocks: List[Tuple[slice, ...]]
    per_group: bool = False


def _whole(shape) -> Tuple[slice, ...]:
    return tuple(slice(0, s) for s in shape)


def _along(shape, dim: int, lo: int, hi: int) -> Tuple[slice, ...]:
    out = list(_whole(shape))
    out[dim] = slice(lo, hi)
    return tuple(out)


def _model_dim(spec) -> Optional[int]:
    for i, e in enumerate(spec):
        if e == "model":
            return i
    return None


def _split_node(cfg: ModelConfig, path: str, specs: Dict[str, Any]):
    """(tree path of the leaf's ``Split``, or None)."""
    parts = path.split("/")
    name = parts[-1]
    if len(parts) == 1:
        if name in ("embed", "lm_head"):
            want = 0 if name == "embed" else 1
            return path if _model_dim(specs[path]) == want else None
        return None
    parent = "/".join(parts[:-1])
    key = parts[-2]
    if key in ATTN_KEYS:
        return parent if _model_dim(specs[f"{parent}/wq"]) is not None \
            else None
    if key == "ffn":
        return parent if _model_dim(specs[f"{parent}/w_down"]) is not None \
            else None
    if key == "mamba":
        return parent if _model_dim(specs[f"{parent}/in_proj"]) is not None \
            else None
    if key == "experts" and len(parts) > 2 and parts[-3] == "moe":
        return parent if _model_dim(specs[f"{parent}/w_down"]) is not None \
            else None
    if key in RWKV_STREAM:
        lead = "w_r" if key == "rwkv_tm" else "w_k"
        return parent if _model_dim(specs[f"{parent}/{lead}"]) is not None \
            else None
    return None


def model_blocks(shape, spec, tp: int) -> List[Tuple[slice, ...]]:
    """A leaf's blocks along "model" under ``spec``, whole along every
    other axis (one block, the whole leaf, where it is not split over
    "model")."""
    md = _model_dim(spec)
    if md is None:
        return [_whole(shape)]
    n = shape[md] // tp
    return [_along(shape, md, j * n, (j + 1) * n) for j in range(tp)]


def plan_leaves(cfg: ModelConfig, mesh, params,
                policy: ShardingPolicy = ShardingPolicy()) -> List[LeafPlan]:
    """One ``LeafPlan`` a leaf of ``params`` in ``tree_leaves`` order:
    ``ShardedTensor``s under their own specs, other tensors (``meta``
    ones too) under ``param_spec``'s for ``policy``."""
    from repro_torch.distributed.sharding import tree_map_with_path
    from repro_torch.optim.adamw import tree_leaves
    tp = mesh_axis_sizes(mesh).get("model", 1)
    dpx = dp_axes(mesh)
    paths: List[Tuple[str, tuple]] = []
    specs: Dict[str, Any] = {}

    def visit(path, x):
        paths.append((path, tuple(x.shape)))
        specs[path] = (x.sharding.spec if isinstance(x, ShardedTensor)
                       else param_spec(cfg, mesh, path, tuple(x.shape),
                                       policy))

    tree_map_with_path(visit, params)
    out = []
    for path, shape in paths:
        spec = specs[path]
        md = _model_dim(spec)
        blocks = model_blocks(shape, spec, tp)
        node = _split_node(cfg, path, specs) if tp > 1 else None
        name = path.rsplit("/", 1)[-1]
        dim = md if md is not None else len(shape) - 1
        kind = node.rsplit("/", 1)[-1] if node else None
        if kind == "rwkv_tm" and name == "u":
            dim = len(shape) - 2
        if node is None or name in RWKV_STREAM.get(kind, ()):
            pieces = [[_whole(shape)]] + [None] * (tp - 1)
        elif kind == "rwkv_tm":
            pieces = _rwkv_pieces(cfg, shape, dim, name, blocks, tp)
        elif node.endswith("mamba") and name == "in_proj":
            di, n = cfg.d_inner, cfg.d_inner // tp
            pieces = [[_along(shape, dim, m * n, (m + 1) * n),
                       _along(shape, dim, di + m * n, di + (m + 1) * n)]
                      for m in range(tp)]
        elif md is None:        # wk / wv, replicated: the rank's kv heads
            dh = cfg.head_dim
            pieces = []
            for m in range(tp):
                k0, k1 = kv_heads(cfg, tp, m)
                pieces.append([_along(shape, dim, k0 * dh, k1 * dh)])
        else:
            pieces = [[b] for b in blocks]
        per_group = path.split("/", 1)[0] in STACKS and any(
            a in dpx for e in spec for a in (e if isinstance(e, tuple)
                                             else (e,)))
        out.append(LeafPlan(path, shape, node, dim, pieces, blocks,
                            per_group))
    if len(out) != len(tree_leaves(params)):
        raise RuntimeError("the plan's walk and tree_leaves disagree")
    return out


def _rwkv_pieces(cfg: ModelConfig, shape, dim: int, name: str, blocks,
                 tp: int):
    """A time-mix leaf's regions for each model rank: its heads' columns
    (rows of ``w_o``, rows of ``u``), one region a stored block they
    overlap, so that ``take_region`` moves only the columns a rank's
    heads lack (a collective-permute) and none where the heads divide
    ``tp``; None for a rank that owns no head."""
    unit = 1 if name == "u" else cfg.rwkv.head_size
    out = []
    for m in range(tp):
        a, b = rwkv_heads(cfg, tp, m)
        lo, hi = a * unit, b * unit
        if lo == hi:
            out.append(None)
            continue
        out.append([_along(shape, dim, max(lo, blk[dim].start),
                           min(hi, blk[dim].stop)) for blk in blocks
                    if blk[dim].start < hi and lo < blk[dim].stop])
    return out


def _overlap(a: Tuple[slice, ...], b: Tuple[slice, ...]):
    out = []
    for x, y in zip(a, b):
        lo, hi = max(x.start, y.start), min(x.stop, y.stop)
        if lo >= hi:
            return None
        out.append(slice(lo, hi))
    return tuple(out)


def _shift(region, origin) -> Tuple[slice, ...]:
    return tuple(slice(r.start - o.start, r.stop - o.start)
                 for r, o in zip(region, origin))


def _nbytes(region, dtype) -> int:
    n = 1
    for s in region:
        n *= s.stop - s.start
    return n * dtype.itemsize


def take_region(st: ShardedTensor, region, device, pos: int,
                column, near: Optional[Sequence[int]] = None
                ) -> torch.Tensor:
    """``region`` of the leaf on ``device`` for mesh position ``pos``:
    a view of the block there where it is that block, else assembled
    from the blocks (an all-gather where they are several; a
    collective-permute where no position of ``column``, the rank's model
    coordinate, holds them).  ``near``: the positions whose blocks may
    overlap it (default all)."""
    by_key: Dict[tuple, torch.Tensor] = {}
    held: Dict[tuple, List[int]] = {}
    for i in range(len(st.index)) if near is None else near:
        sl, t = st.index[i], st.shards[i]
        ov = _overlap(sl, region)
        if ov is None:
            continue
        k = _key(sl)
        held.setdefault(k, []).append(i)
        if k not in by_key or (t.device == torch.device(device)
                               and by_key[k].device != torch.device(device)):
            by_key[k] = t
    nbytes = _nbytes(region, st.dtype)
    if len(by_key) > 1:
        collectives.record("all-gather", nbytes, len(by_key), pos)
    if not any(i in column for ids in held.values() for i in ids):
        collectives.record("collective-permute", nbytes, 2, pos)
    if len(by_key) == 1:
        (k, t), = by_key.items()
        if tuple(slice(a, b) for a, b in k) == tuple(region) and \
                t.device == torch.device(device):
            return t.view_as(t)
    pieces = []
    for k, t in by_key.items():
        sl = tuple(slice(a, b) for a, b in k)
        ov = _overlap(sl, region)
        pieces.append((ov, t[_shift(ov, sl)].to(device)))
    dim = _tiling_dim(region, [ov for ov, _ in pieces])
    if dim is not None:     # one concatenation (FSDP's blocks along a dim)
        pieces.sort(key=lambda p: p[0][dim].start)
        return torch.cat([v for _, v in pieces], dim=dim)
    out = torch.empty([s.stop - s.start for s in region], dtype=st.dtype,
                      device=device)
    for ov, v in pieces:
        out[_shift(ov, region)].copy_(v)
    return out


def _tiling_dim(region, ovs) -> Optional[int]:
    """The dim along which the overlaps ``ovs`` tile ``region`` (each
    whole in every other dim, together covering it), or None."""
    for d in range(len(region)):
        if all(ov[:d] == region[:d] and ov[d + 1:] == region[d + 1:]
               for ov in ovs):
            spans = sorted((ov[d].start, ov[d].stop) for ov in ovs)
            at = region[d].start
            for a, b in spans:
                if a != at:
                    break
                at = b
            else:
                if at == region[d].stop:
                    return d
    return None


def _compute_leaf(st, plan: LeafPlan, m: int, device, pos: int, column):
    parts = [take_region(st, r, device, pos, column) for r in plan.pieces[m]]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=plan.dim)


def _at_group(region, g: int) -> Tuple[slice, ...]:
    return (slice(g, g + 1),) + tuple(region[1:])


class ZeroPass:
    """One data rank's pass under ZeRO-3: ``token``, a 0-d tensor that
    every deferred gather takes as its input, so that the backward
    reaches each gather, and the ``ShardGrads`` (by leaf index) that the
    gathers' backward adds each group's gradient into as it leaves the
    group (``land``): the model ranks' pieces of a block's group slice
    summed in rank order onto zeros, as ``block_grads`` sums them (a
    single piece that covers the slice itself), then added in."""

    def __init__(self, device, plans: List[LeafPlan],
                 shards: Dict[int, "ShardGrads"]):
        self.token = torch.empty((), device=device, requires_grad=True)
        self.plans, self.shards = plans, shards
        self.held: Dict[tuple, list] = {}
        self.expected: Dict[tuple, int] = {}

    def _expected(self, i: int, k: int) -> int:
        """The (model rank, region) pieces that block k of leaf i gets."""
        if (i, k) not in self.expected:
            sl = self.shards[i].index[k]
            self.expected[i, k] = sum(
                _overlap(r, sl) is not None
                for regions in self.plans[i].pieces if regions
                for r in regions)
        return self.expected[i, k]

    def land(self, d: "Deferred", regions, grad: torch.Tensor) -> None:
        """The gradient of ``d``'s gathered group (``regions``
        concatenated along ``d.dim``) cut into the pieces each block
        holds and added there on the holder's device: the reduce-scatter
        over the data axes, recorded once on the gathering rank (its
        result the part its own block holds)."""
        grad = grad.unsqueeze(0)
        sg = self.shards[d.leaf]
        own = d.st.index[d.rank]
        held, mine, off = set(), 0, 0
        for r in regions:
            for k in d.near_blocks:
                sl = sg.index[k]
                ov = _overlap(sl, r)
                if ov is None:
                    continue
                held.add(k)
                if sl == own:
                    mine += _nbytes(ov, d.st.dtype)
                src = list(_shift(ov, r))
                src[d.dim] = slice(src[d.dim].start + off,
                                   src[d.dim].stop + off)
                piece = grad[tuple(src)]
                target = _overlap(sl, _at_group(_whole(sg.shape), d.g))
                key = (d.leaf, k, d.g)
                with collectives.on_rank(sg.holders[k]):
                    if self._expected(d.leaf, k) == 1 and ov == target:
                        sg.add(k, d.g, piece.to(sg.devices[k]))
                        continue
                    self.held.setdefault(key, []).append(
                        [d.m, ov, piece.to(sg.devices[k], copy=True)])
                if len(self.held[key]) == self._expected(d.leaf, k):
                    self._combine(key)
            off += r[d.dim].stop - r[d.dim].start
        if len(held) > 1:
            collectives.record("reduce-scatter", mine, len(held), d.rank)

    def _combine(self, key) -> None:
        i, k, g = key
        sg = self.shards[i]
        target = _overlap(sg.index[k], _at_group(_whole(sg.shape), g))
        with collectives.on_rank(sg.holders[k]):
            c = torch.zeros([s.stop - s.start for s in target],
                            dtype=sg.dtype, device=sg.devices[k])
            for _, ov, piece in sorted(self.held.pop(key),
                                       key=lambda p: p[0]):
                c[_shift(ov, target)].add_(piece)
            sg.add(k, g, c)

    def flush(self) -> None:
        """Add what a model rank that left a group unused did not
        complete."""
        for key in sorted(self.held):
            self._combine(key)


class _GatherGroup(torch.autograd.Function):
    """A deferred leaf's group gathered; backward, its gradient landed on
    the blocks (``ZeroPass.land``), nothing for the token."""

    @staticmethod
    def forward(ctx, d, regions, token):
        ctx.d, ctx.regions = d, regions
        return d._assemble(regions)

    @staticmethod
    def backward(ctx, grad):
        d, regions = ctx.d, ctx.regions
        ctx.d = ctx.regions = None
        d.zero.land(d, regions, grad)
        return None, None, None


class Deferred:
    """Model rank ``m``'s tensor of a layer-stack leaf that FSDP splits
    over the data axes, not yet gathered: ``d[g]`` (or ``unbind``) names
    group g's slice, and ``gather_group`` assembles it on the rank's
    device from the blocks (``take_region``: an all-gather over the data
    axes, a collective-permute where the rank's model coordinate holds
    none of it) when the group runs.  Under a ``ZeroPass`` with grad
    enabled the gather is differentiable: its backward lands the group's
    gradient on the blocks (``ZeroPass.land``)."""
    __slots__ = ("st", "regions", "dim", "device", "rank", "column", "zero",
                 "leaf", "m", "g", "near", "near_blocks")

    def __init__(self, st: ShardedTensor, regions, dim: int, device,
                 rank: int, column, zero: Optional[ZeroPass], leaf: int,
                 m: int):
        self.st, self.regions, self.dim = st, regions, dim
        self.device, self.rank, self.column = device, rank, column
        self.zero, self.leaf, self.m, self.g = zero, leaf, m, None

        def near(index):
            return [i for i, sl in enumerate(index)
                    if any(_overlap(sl, r) is not None for r in regions)]
        # the positions, and the distinct blocks, that hold any of it
        self.near = near(st.index)
        self.near_blocks = near([sl for sl, _, _ in st.blocks()])

    def __getitem__(self, g: int) -> "Deferred":
        if self.g is not None:
            raise TypeError("a deferred group is indexed once")
        out = copy.copy(self)
        out.g = int(g)
        return out

    def unbind(self, dim: int = 0) -> List["Deferred"]:
        if dim != 0:
            raise ValueError("a deferred leaf unbinds its group axis only")
        return [self[g] for g in range(self.regions[0][0].stop)]

    def _assemble(self, regions) -> torch.Tensor:
        parts = [take_region(self.st, r, self.device, self.rank,
                             self.column, self.near) for r in regions]
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=self.dim)
        return out[0]

    def gather(self) -> torch.Tensor:
        if self.g is None:
            raise TypeError("gather a group of a deferred leaf (d[g])")
        regions = [_at_group(r, self.g) for r in self.regions]
        with collectives.on_rank(self.rank):
            if self.zero is not None and torch.is_grad_enabled():
                return _GatherGroup.apply(self, regions, self.zero.token)
            return self._assemble(regions)


def gather_group(tree):
    """A layer group's params with each ``Deferred`` leaf gathered (on
    its model rank): run inside the function ``transformer.remat_group``
    wraps, so that a rematerialized group drops its gathered blocks
    after the forward and gathers them again in the recompute."""
    if isinstance(tree, Deferred):
        return tree.gather()
    if isinstance(tree, dict):
        return {k: gather_group(v) for k, v in tree.items()}
    if isinstance(tree, Split):
        return tree.like([gather_group(p) for p in tree.parts])
    return tree


def rank_params(cfg: ModelConfig, params, mesh, d: int,
                plans: Optional[List[LeafPlan]] = None,
                policy: ShardingPolicy = ShardingPolicy(),
                zero: Optional[ZeroPass] = None):
    """Data rank ``d``'s compute tree of ``params`` (``ShardedTensor``
    leaves under ``params_pspecs``) and its leaves: ``(tree, leaves)``,
    ``leaves[i][m]`` the tensor model rank m computes with for leaf i
    (``tree_leaves`` order; None where the rank holds none of it), or,
    for a ``per_group`` leaf, its ``Deferred`` gather (its gradient
    lands through ``zero``, if given)."""
    from repro_torch.distributed.sharding import tree_map_with_path
    plans = plan_leaves(cfg, mesh, params, policy) if plans is None else \
        plans
    group = model_group(mesh, d)
    columns = [set(r[m] for r in model_positions(mesh))
               for m in range(group.tp)]
    leaves: List[List[Optional[torch.Tensor]]] = []
    by_path: Dict[str, List[Optional[torch.Tensor]]] = {}
    it = iter(plans)

    def leaf(path, st):
        plan = next(it)
        if plan.path != path:
            raise RuntimeError(f"plan {plan.path} met leaf {path}")
        per = []
        for m in range(group.tp):
            if plan.pieces[m] is None:
                per.append(None)
                continue
            if plan.per_group:
                per.append(Deferred(st, plan.pieces[m], plan.dim,
                                    group.devices[m], group.ranks[m],
                                    columns[m], zero, len(leaves), m))
                continue
            with collectives.on_rank(group.ranks[m]):
                per.append(_compute_leaf(st, plan, m, group.devices[m],
                                         group.ranks[m], columns[m]))
        leaves.append(per)
        by_path[path] = per
        return per

    tree_map_with_path(leaf, params)
    nodes = {p.node for p in plans if p.node is not None}

    def build(node, path):
        if path in nodes:
            return Split(group, [_pick(node, path, m) for m in
                                 range(group.tp)])
        if isinstance(node, dict):
            return {k: build(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        return by_path[path][0]

    def _pick(node, path, m):
        if isinstance(node, dict):
            return {k: _pick(v, f"{path}/{k}", m) for k, v in node.items()}
        return by_path[path][m]

    return build(params, ""), leaves


def block_grads(plans: List[LeafPlan], mesh, d: int,
                grads: List[List[Optional[torch.Tensor]]], acc: list,
                dtypes: Sequence[torch.dtype]) -> None:
    """Add data rank ``d``'s gradients (``grads[i][m]`` of
    ``rank_params``' ``leaves[i][m]``; None: zero) into ``acc[i][j]``,
    leaf i's model block j on its holder (the first data rank's position
    at coordinate j): ``acc[i][j] + g`` in data-rank order, ``g`` itself
    for the first.  A piece from another position is a
    collective-permute received by the holder.  A ``per_group`` leaf's
    gradient lands on its blocks instead (``ZeroPass``): its entry is
    left None here."""
    pos = model_positions(mesh)
    for i, plan in enumerate(plans):
        if d == 0:
            acc.append(None if plan.per_group else [None] * len(plan.blocks))
        if plan.per_group:
            continue
        for j, region in enumerate(plan.blocks):
            holder = pos[0][j] if len(plan.blocks) > 1 else pos[0][0]
            dev = mesh.devices.flat[holder]
            with collectives.on_rank(holder):
                g = _contribution(plan, region, grads[i], pos[d], holder,
                                  dev, dtypes[i])
                acc[i][j] = g if acc[i][j] is None else acc[i][j] + g


def _contribution(plan, region, grads, row, holder, dev, dtype):
    pieces = []
    for m, regions in enumerate(plan.pieces):
        if regions is None or grads[m] is None:
            continue
        off = 0
        for r in regions:
            ov = _overlap(r, region)
            if ov is not None:
                src = list(_shift(ov, r))
                src[plan.dim] = slice(src[plan.dim].start + off,
                                      src[plan.dim].stop + off)
                pieces.append((m, ov, grads[m][tuple(src)]))
            off += r[plan.dim].stop - r[plan.dim].start
    for m, ov, g in pieces:
        if row[m] != holder:
            collectives.record("collective-permute",
                               g.numel() * g.element_size(), 2, holder)
    if len(pieces) == 1 and pieces[0][1] == tuple(region):
        return pieces[0][2].to(dev)
    out = torch.zeros([s.stop - s.start for s in region], dtype=dtype,
                      device=dev)
    for m, ov, g in pieces:
        dst = _shift(ov, region)
        out[dst] = out[dst] + g.to(dev)
    return out


def _flat_boxes(shape, a: int, b: int) -> List[Tuple[int, Tuple[slice, ...]]]:
    """Boxes covering the flat range [a, b) of ``shape`` (row-major), each
    contiguous in that order: ``(offset from a, box)``."""
    if a >= b:
        return []
    if len(shape) == 1:
        return [(0, (slice(a, b),))]
    inner = int(np.prod(shape[1:]))
    full = tuple(slice(0, s) for s in shape[1:])
    (i0, r0), (i1, r1) = divmod(a, inner), divmod(b, inner)

    def row(i, lo, hi, at):
        return [(at + o, (slice(i, i + 1),) + box)
                for o, box in _flat_boxes(shape[1:], lo, hi)]

    if i0 == i1:
        return row(i0, r0, r1, 0)
    out, at = [], 0
    if r0:
        out, at, i0 = row(i0, r0, inner, 0), inner - r0, i0 + 1
    if i1 > i0:
        out.append((at, (slice(i0, i1),) + full))
        at += (i1 - i0) * inner
    return out + (row(i1, 0, r1, at) if r1 else [])


class ShardGrads:
    """A ``per_group`` leaf's gradient on its FSDP blocks:
    ``tensors[k]`` the gradient of the params' k-th block
    (``ShardedTensor.blocks()`` order: ``index[k]`` on mesh position
    ``holders[k]``), on that block's device: zeros that each data rank's
    pass adds its landed groups into, in data-rank order (``ZeroPass``;
    every pass does the same work, so a dry-run may replay one from
    another).  Against ``block_grads``' first-rank copy this can only
    turn a -0.0 into +0.0."""

    def __init__(self, st: ShardedTensor):
        blocks = st.blocks()
        self.shape, self.dtype = tuple(st.shape), st.dtype
        self.index = [sl for sl, _, _ in blocks]
        self.holders = [i for _, _, i in blocks]
        self.devices = [t.device for _, t, _ in blocks]
        self.tensors = []
        for sl, i, dev in zip(self.index, self.holders, self.devices):
            with collectives.on_rank(i):
                self.tensors.append(torch.zeros(
                    [s.stop - s.start for s in sl], dtype=self.dtype,
                    device=dev))

    def add(self, k: int, g: int, c: torch.Tensor) -> None:
        """Add ``c``, group g's slice of block k, in place."""
        at = g - self.index[k][0].start
        self.tensors[k][at:at + 1].add_(c)

    def finish(self, n: int) -> None:
        """The data ranks' mean (``n`` > 1), on each block's holder."""
        if n > 1:
            for k, t in enumerate(self.tensors):
                with collectives.on_rank(self.holders[k]):
                    t.div_(n)

    def square_sum(self, region, rank: int, device) -> torch.Tensor:
        """``optim.adamw._square_sum`` of the gradient's ``region`` (a
        model block), as the whole block gives it: each flat run of
        ``adamw.BLOCK`` elements assembled on ``device`` (rank
        ``rank``; a piece another position holds is a
        collective-permute) and square-summed, in order."""
        from repro_torch.optim.adamw import BLOCK, _square_sum
        shape = [s.stop - s.start for s in region]
        numel = int(np.prod(shape))
        near = [k for k, sl in enumerate(self.index)
                if _overlap(sl, region) is not None]
        total = None
        for a in range(0, numel, BLOCK):
            b = min(a + BLOCK, numel)
            chunk = torch.empty(b - a, dtype=self.dtype, device=device)
            for at, box in _flat_boxes(shape, a, b):
                box = tuple(slice(r.start + x.start, r.start + x.stop)
                            for r, x in zip(region, box))
                dims = [s.stop - s.start for s in box]
                out = chunk[at:at + int(np.prod(dims))].view(dims)
                for k in near:
                    sl = self.index[k]
                    ov = _overlap(sl, box)
                    if ov is None:
                        continue
                    if self.holders[k] != rank:
                        collectives.record("collective-permute",
                                           _nbytes(ov, self.dtype), 2, rank)
                    out[_shift(ov, box)].copy_(
                        self.tensors[k][_shift(ov, sl)].to(device))
            s = _square_sum(chunk)
            total = s if total is None else total + s
        return total if total is not None else _square_sum(
            torch.zeros(0, dtype=self.dtype, device=device))

    def whole(self, device) -> torch.Tensor:
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for sl, t in zip(self.index, self.tensors):
            out[sl] = t.to(device)
        return out


def local_split(cfg: ModelConfig, params, tp: int, device):
    """``params`` (whole tensors) split for ``tp`` model ranks that all
    run on ``device``: data rank 0's compute tree of a (1, tp) mesh of
    logical devices (``rank_params``)."""
    from repro_torch.distributed.sharding import (device_put, params_pspecs,
                                                  to_shardings)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, tp, devices=[device] * tp)
    placed = device_put(params, to_shardings(
        mesh, params_pspecs(cfg, mesh, params)), may_alias=True)
    return rank_params(cfg, placed, mesh, 0)


__all__ = ["Deferred", "LeafPlan", "ModelGroup", "SeqSplit", "ShardGrads",
           "Split", "VocabShards", "ZeroPass", "block_grads", "gather_group",
           "gathered", "group_of", "head_owners", "kv_heads",
           "local_split", "model_blocks", "model_group", "model_positions",
           "plan_leaves", "q_heads", "rank_params", "reduce", "run",
           "rwkv_heads", "smap", "spread", "take_region"]
