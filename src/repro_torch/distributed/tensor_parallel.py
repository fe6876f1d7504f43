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
a ``SeqSplit``: each rank attends over its block where it lies
(``attention._seq_split_decode_attn``, ``encdec.
_seq_split_cross_attn``), and ``collectives.all_gather`` /
``all_to_all`` move q, the new rows and the softmax partials between
the ranks.  RWKV's state, replicated over "model", is read by each head
owner from its own replica, and the new state's heads are gathered.

``rank_params(cfg, params, mesh, d)`` gives data rank ``d``'s compute
tree: the params' tree with a ``Split`` (one subtree a model rank, on
that rank's device) at each split sublayer and the vocabulary leaves,
and whole leaves elsewhere.  It gathers over "data" only what FSDP
split (an all-gather on the receiving rank) and moves a block another
model coordinate holds (a collective-permute).  ``block_grads`` takes
the pass's gradients back to each leaf's *model blocks* — the leaf's
blocks along "model", whole along the data axes — on the block's
holder, the first data rank's position at that model coordinate.  With
``tp`` = 1 a leaf is one block on the first data rank's position: the
unsplit step's gradients, bitwise.
"""
from __future__ import annotations

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
    """A decode cache (G, B, S, Hkv, Dh) split by sequence over a
    ``ModelGroup``: ``parts[m]`` holds positions [m S/tp, (m+1) S/tp)
    of every kv head (``cache_pspecs``' layout where the kv heads do not
    divide the model degree)."""
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
    whole on the first model rank)."""
    path: str
    shape: Tuple[int, ...]
    node: Optional[str]
    dim: int
    pieces: List[Optional[List[Tuple[slice, ...]]]]
    blocks: List[Tuple[slice, ...]]


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
        out.append(LeafPlan(path, shape, node, dim, pieces, blocks))
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
                column) -> torch.Tensor:
    """``region`` of the leaf on ``device`` for mesh position ``pos``:
    a view of the block there where it is that block, else assembled
    from the blocks (an all-gather where they are several; a
    collective-permute where no position of ``column``, the rank's model
    coordinate, holds them)."""
    by_key: Dict[tuple, torch.Tensor] = {}
    held: Dict[tuple, List[int]] = {}
    for i, (sl, t) in enumerate(zip(st.index, st.shards)):
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
    shape = [s.stop - s.start for s in region]
    out = torch.empty(shape, dtype=st.dtype, device=device)
    for k, t in by_key.items():
        sl = tuple(slice(a, b) for a, b in k)
        ov = _overlap(sl, region)
        out[_shift(ov, region)].copy_(t[_shift(ov, sl)].to(device))
    return out


def _compute_leaf(st, plan: LeafPlan, m: int, device, pos: int, column):
    parts = [take_region(st, r, device, pos, column) for r in plan.pieces[m]]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=plan.dim)


def rank_params(cfg: ModelConfig, params, mesh, d: int,
                plans: Optional[List[LeafPlan]] = None,
                policy: ShardingPolicy = ShardingPolicy()):
    """Data rank ``d``'s compute tree of ``params`` (``ShardedTensor``
    leaves under ``params_pspecs``) and its leaves: ``(tree, leaves)``,
    ``leaves[i][m]`` the tensor model rank m computes with for leaf i
    (``tree_leaves`` order; None where the rank holds none of it)."""
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
    collective-permute received by the holder."""
    pos = model_positions(mesh)
    for i, plan in enumerate(plans):
        if d == 0:
            acc.append([None] * len(plan.blocks))
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


__all__ = ["LeafPlan", "ModelGroup", "SeqSplit", "Split", "VocabShards",
           "block_grads", "gathered", "group_of", "head_owners", "kv_heads",
           "local_split", "model_blocks", "model_group", "model_positions",
           "plan_leaves", "q_heads", "rank_params", "reduce", "run",
           "rwkv_heads", "smap", "take_region"]
