"""Sharding rules: DP / TP / EP / SP over the production mesh
(``repro/distributed/sharding.py``), and the placement of tensors under
them.

Name-path-based rules produce a PartitionSpec tree for params (and,
structurally identical, the Adam moments), batches, and decode caches.

Policy highlights (the reference's, rule for rule):
  * TP (Megatron): attention heads + FFN hidden over 'model'
    (column-parallel in, row-parallel out).
  * GQA: KV projections replicated when kv_heads % tp != 0.
  * EP: MoE expert axis over 'model' when n_experts % tp == 0, else
    TP over the expert FFN hidden dim.
  * DP: batch over ('pod','data') / ('data',).
  * SP: decode caches shard the sequence axis when batch doesn't divide
    dp (long_500k, batch=1).
  * FSDP option: additionally shard the largest param axis over 'data'
    (ZeRO-3) — used by small-dense + rwkv archs when
    replicated-under-TP params would not fit.

The port's own types stand in for ``jax.sharding``'s:
``PartitionSpec`` (``P``) holds one entry a dimension — ``None``, an
axis name, or a tuple of names — and is a leaf of every tree walk, as
JAX's is; ``NamedSharding(mesh, spec)`` pairs it with a
``launch.mesh.Mesh``.  Path strings come from this module's own walk,
``/``-joined as the reference's ``_path_str`` joins them (dict keys,
sequence indices, named-tuple fields).

``device_put(tree, shardings)`` is the ``jax.device_put`` counterpart:
each leaf becomes a ``ShardedTensor``, one block a mesh device, each on
its device.  Devices that hold the same block of a leaf on the same
device (a replicated leaf on logical devices of one card) share one
storage.  ``ShardedTensor.full(device)`` gathers a leaf back whole,
``gather(tree)`` a tree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import dp_axes, mesh_axis_sizes


class PartitionSpec:
    """One entry a dimension: ``None`` (not split), an axis name, or a
    tuple of axis names (split over their product, the first major).
    Not a tuple, so tree walks take it as a leaf."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        for p in parts:
            ok = p is None or isinstance(p, str) or (
                isinstance(p, tuple) and all(isinstance(a, str) for a in p))
            if not ok:
                raise TypeError(f"a PartitionSpec entry is None, an axis "
                                f"name or a tuple of names, got {p!r}")
        self._parts = tuple(parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._parts == other._parts
        if isinstance(other, tuple):
            return self._parts == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._parts!r}"


P = PartitionSpec


class NamedSharding:
    """``spec`` laid over ``mesh``: which block of a leaf each mesh
    device holds."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def indices(self, shape) -> List[Tuple[slice, ...]]:
        """The block of a leaf of ``shape`` that each mesh device holds,
        devices in mesh order (``mesh.devices.flat``)."""
        sizes = mesh_axis_sizes(self.mesh)
        names = self.mesh.axis_names
        spec = list(self.spec)
        if len(spec) > len(shape):
            raise ValueError(f"{self.spec} has more entries than the leaf "
                             f"{tuple(shape)} has dims")
        spec += [None] * (len(shape) - len(spec))
        grid = self.mesh.devices.shape
        out = []
        for flat in range(self.mesh.size):
            coord = dict(zip(names, np.unravel_index(flat, grid)))
            sl = []
            for dim, entry in zip(shape, spec):
                axes = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                n, block = 1, 0
                for a in axes:
                    if a not in sizes:
                        raise ValueError(f"{self.spec} names axis {a!r}, "
                                         f"the mesh has {names}")
                    n, block = n * sizes[a], block * sizes[a] + int(coord[a])
                if dim % n:
                    raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                     f"split into {n} blocks ({self.spec})")
                size = dim // n
                sl.append(slice(block * size, (block + 1) * size))
            out.append(tuple(sl))
        return out


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    tp_axis: str = "model"
    fsdp: bool = False           # shard big param dims over 'data' too
    seq_shard_caches: bool = True


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


# ---------------------------------------------------------------------------
# Tree walks (dicts, lists, tuples and named tuples; None has no leaves)
# ---------------------------------------------------------------------------
def _rebuild(node, items: list):
    if isinstance(node, tuple):
        return type(node)(*items) if hasattr(node, "_fields") else \
            tuple(items)
    return items


def _keys(node):
    if isinstance(node, dict):
        return [(k, str(k)) for k in sorted(node)]
    fields = getattr(node, "_fields", None)
    return [(i, fields[i] if fields else str(i)) for i in range(len(node))]


def tree_map_with_path(fn, tree, *rest, path: Tuple[str, ...] = ()):
    """``fn("/"-joined path, leaf, *matching leaves of rest)`` over the
    leaves of ``tree``, its structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (name,))
                for k, name in _keys(tree)}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [
            tree_map_with_path(fn, tree[i], *(r[i] for r in rest),
                               path=path + (name,))
            for i, name in _keys(tree)])
    if tree is None:
        return None
    return fn("/".join(path), tree, *rest)


def tree_map(fn, tree, *rest):
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------
def param_spec(cfg: ModelConfig, mesh, path: str, shape,
               policy: ShardingPolicy = ShardingPolicy()) -> P:
    """PartitionSpec for one parameter leaf, by name path."""
    sizes = mesh_axis_sizes(mesh)
    tp = sizes.get(policy.tp_axis, 1)
    dpx = dp_axes(mesh)
    dp = 1
    for a in dpx:
        dp *= sizes[a]
    tpa = policy.tp_axis
    nd = len(shape)
    name = path.rsplit("/", 1)[-1]
    parent = path

    def _fill_fsdp(spec: P) -> P:
        """Shard the largest still-unsharded dim over the dp axes
        (ZeRO-3), on top of the TP spec when policy.fsdp — skips tiny
        leaves (<1 MiB) where the all-gather latency would outweigh the
        memory win."""
        if not policy.fsdp:
            return spec
        n_elems = 1
        for s in shape:
            n_elems *= s
        if n_elems < (1 << 20):
            return spec
        dims = list(spec) + [None] * (nd - len(spec))
        best, best_dim = 0, -1
        for i, (d, s) in enumerate(zip(dims, shape)):
            if d is None and _div(s, dp) and s > best:
                best, best_dim = s, i
        if best_dim >= 0:
            dims[best_dim] = dpx if len(dpx) > 1 else dpx[0]
        return P(*dims)

    def base() -> P:
        # ---- embeddings -------------------------------------------------
        if name == "embed":                       # (V, D)
            return P(tpa, None) if _div(shape[0], tp) else P(None, None)
        if name == "lm_head":                     # (D, V)
            return P(None, tpa) if _div(shape[1], tp) else P(None, None)

        # ---- attention --------------------------------------------------
        if "attn" in parent:
            lead = (None,) * (nd - 2)             # group/layer stack prefix
            if name == "wq":                      # (..., D, Hq*Dh)
                ok = _div(cfg.n_heads, tp)
                return P(*lead, None, tpa) if ok else P(*lead, None, None)
            if name in ("wk", "wv"):              # (..., D, Hkv*Dh)
                ok = _div(cfg.n_kv_heads, tp)
                return P(*lead, None, tpa) if ok else P(*lead, None, None)
            if name == "wo":                      # (..., Hq*Dh, D)
                ok = _div(cfg.n_heads, tp)
                return P(*lead, tpa, None) if ok else P(*lead, None, None)

        # ---- MoE ----------------------------------------------------------
        if "moe" in parent:
            E = cfg.moe.n_experts
            lead = (None,) * (nd - 3)
            if name == "router":                  # (..., D, E)
                return P(*((None,) * nd))
            ep = _div(E, tp)
            if name in ("w_gate", "w_up", "w_in"):    # (..., E, D, F)
                if ep:
                    return P(*lead, tpa, None, None)
                return (P(*lead, None, None, tpa) if _div(shape[-1], tp)
                        else P(*((None,) * nd)))
            if name == "w_down":                  # (..., E, F, D)
                if ep:
                    return P(*lead, tpa, None, None)
                return (P(*lead, None, tpa, None) if _div(shape[-2], tp)
                        else P(*((None,) * nd)))

        # ---- dense FFN (also rwkv channel-mix w_k/w_v) --------------------
        if name in ("w_gate", "w_up", "w_in") or (
                name == "w_k" and "rwkv_cm" in parent):
            lead = (None,) * (nd - 2)             # (..., D, F)
            return (P(*lead, None, tpa) if _div(shape[-1], tp)
                    else P(*((None,) * nd)))
        if name == "w_down" or (name == "w_v" and "rwkv_cm" in parent):
            lead = (None,) * (nd - 2)             # (..., F, D)
            return (P(*lead, tpa, None) if _div(shape[-2], tp)
                    else P(*((None,) * nd)))

        # ---- mamba ---------------------------------------------------------
        if "mamba" in parent:
            di = cfg.d_inner
            lead = (None,) * (nd - 2)
            if name == "in_proj":                 # (..., D, 2*di)
                return (P(*lead, None, tpa) if _div(di, tp)
                        else P(*((None,) * nd)))
            if name in ("x_proj", "out_proj", "A_log"):   # (..., di, *)
                return (P(*lead, tpa, None) if _div(di, tp)
                        else P(*((None,) * nd)))
            if name == "dt_proj":                 # (..., dtr, di)
                return (P(*lead, None, tpa) if _div(di, tp)
                        else P(*((None,) * nd)))
            if name in ("conv_w",):               # (..., d_conv, di)
                return (P(*lead, None, tpa) if _div(di, tp)
                        else P(*((None,) * nd)))
            if name in ("conv_b", "dt_bias", "D"):        # (..., di)
                lead1 = (None,) * (nd - 1)
                return (P(*lead1, tpa) if _div(di, tp)
                        else P(*((None,) * nd)))

        # ---- rwkv time-mix --------------------------------------------------
        if "rwkv_tm" in parent:
            lead = (None,) * (nd - 2)
            if name in ("w_r", "w_k", "w_v", "w_g"):      # (..., D, D)
                return (P(*lead, None, tpa) if _div(shape[-1], tp)
                        else P(*((None,) * nd)))
            if name == "w_o":                     # (..., D, D)
                return (P(*lead, tpa, None) if _div(shape[-2], tp)
                        else P(*((None,) * nd)))
            if name in ("w_lora_a", "w_lora_b"):
                return P(*((None,) * nd))

        # ---- everything else (norms, mixes, biases, u, ...): replicated --
        return P(*((None,) * nd))

    return _fill_fsdp(base())


def params_pspecs(cfg: ModelConfig, mesh, params_tree,
                  policy: ShardingPolicy = ShardingPolicy()):
    """PartitionSpec tree matching a (possibly ``meta``) params tree."""
    return tree_map_with_path(
        lambda path, leaf: param_spec(cfg, mesh, path, tuple(leaf.shape),
                                      policy),
        params_tree)


def state_pspecs(cfg: ModelConfig, mesh, state_tree,
                 policy: ShardingPolicy = ShardingPolicy()):
    """TrainState(params, OptState(mu, nu, step)) spec tree."""
    from repro_torch.models.api import TrainState
    from repro_torch.optim.adamw import OptState
    p = params_pspecs(cfg, mesh, state_tree.params, policy)
    mu = params_pspecs(cfg, mesh, state_tree.opt.mu, policy)
    nu = params_pspecs(cfg, mesh, state_tree.opt.nu, policy)
    return TrainState(p, OptState(mu, nu, P()))


def _dp(mesh) -> Tuple[tuple, int]:
    sizes = mesh_axis_sizes(mesh)
    dpx = dp_axes(mesh)
    dp = 1
    for a in dpx:
        dp *= sizes[a]
    return dpx, dp


def batch_pspecs(cfg: ModelConfig, mesh, batch_tree):
    """Shard the leading batch dim of every input over the dp axes."""
    dpx, dp = _dp(mesh)
    dspec = dpx if len(dpx) > 1 else dpx[0]

    def spec(leaf):
        nd = len(leaf.shape)
        if leaf.shape[0] % dp == 0:
            return P(dspec, *((None,) * (nd - 1)))
        return P(*((None,) * nd))

    return tree_map(spec, batch_tree)


def cache_pspecs(cfg: ModelConfig, mesh, cache_tree,
                 policy: ShardingPolicy = ShardingPolicy()):
    """Decode caches: batch over dp; SP over sequence when batch==1.

    Attn k/v: (G, B, S, Hkv, Dh)  |  encdec: (L, B, S, Hkv, Dh)
    mamba:    conv (G, B, dc, di), ssm (G, B, di, ds)
    rwkv:     tm_x/cm_x (G, B, D), state (G, B, H, hs, hs)
    """
    sizes = mesh_axis_sizes(mesh)
    tp = sizes.get(policy.tp_axis, 1)
    dpx, dp = _dp(mesh)
    dspec = dpx if len(dpx) > 1 else dpx[0]
    tpa = policy.tp_axis

    def spec_with_path(path, leaf):
        name = path.rsplit("/", 1)[-1]
        nd = len(leaf.shape)
        B = leaf.shape[1]
        batch_ok = B % dp == 0
        bspec = dspec if batch_ok else None
        if name in ("k", "v", "xk", "xv"):
            S = leaf.shape[2]
            seq_axes = []
            if not batch_ok and policy.seq_shard_caches and S % dp == 0:
                seq_axes.extend(dpx)    # SP over data (batch=1 long ctx)
            hspec = tpa if _div(cfg.n_kv_heads, tp) else None
            if (hspec is None and policy.seq_shard_caches
                    and S % (tp * max(dp if seq_axes else 1, 1)) == 0):
                # kv heads don't divide tp: shard the SEQUENCE over the
                # model axis instead (flash-decode's partial softmaxes
                # merge with a sum); without this the cache replicates
                # across tp
                seq_axes.append(tpa)
            sspec = (tuple(seq_axes) if len(seq_axes) > 1
                     else (seq_axes[0] if seq_axes else None))
            return P(None, bspec, sspec, hspec, None)
        if name == "conv":
            return P(None, bspec, None,
                     tpa if _div(cfg.d_inner, tp) else None)
        if name == "ssm":
            return P(None, bspec,
                     tpa if _div(cfg.d_inner, tp) else None, None)
        if name in ("tm_x", "cm_x"):
            return P(None, bspec, None)
        if name == "state":
            return P(None, bspec, *((None,) * (nd - 2)))
        return P(*((None,) * nd))

    return tree_map_with_path(spec_with_path, cache_tree)


def to_shardings(mesh, spec_tree):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------
def _key(sl: Tuple[slice, ...]) -> tuple:
    return tuple((s.start, s.stop) for s in sl)


class ShardedTensor:
    """A leaf placed under a ``NamedSharding``: ``shards[i]`` is the
    block that mesh device ``i`` (``mesh.devices.flat`` order) holds, on
    that device, at ``index[i]`` of the whole leaf.  Devices that hold
    the same block on the same device share one tensor."""

    def __init__(self, shape, dtype: torch.dtype, sharding: NamedSharding,
                 shards: List[torch.Tensor], index=None):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = shards
        self.index = sharding.indices(self.shape) if index is None else index

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding.spec}, {len(self.blocks())} blocks)")

    def blocks(self) -> List[Tuple[Tuple[slice, ...], torch.Tensor, int]]:
        """Each storage once: (index, tensor, position of its first
        holder in mesh order)."""
        seen = set()
        out = []
        for i, (sl, t) in enumerate(zip(self.index, self.shards)):
            if id(t) not in seen:
                seen.add(id(t))
                out.append((sl, t, i))
        return out

    def full(self, device=None, *, copy: bool = False) -> torch.Tensor:
        """The whole leaf on ``device`` (default: the first mesh
        device's).  A leaf held whole on ``device`` comes back as that
        storage itself unless ``copy``.  (A step's gathers, which
        ``collectives.counting`` records, go through
        ``tensor_parallel.take_region``.)"""
        dev = torch.device(device) if device is not None else \
            self.shards[0].device
        by_block: Dict[tuple, torch.Tensor] = {}
        for sl, t in zip(self.index, self.shards):
            k = _key(sl)
            if k not in by_block or (t.device == dev
                                     and by_block[k].device != dev):
                by_block[k] = t
        if len(by_block) == 1 and not copy:
            (t,) = by_block.values()
            if t.device == dev and tuple(t.shape) == tuple(self.shape):
                return t
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for k, t in by_block.items():
            out[tuple(slice(a, b) for a, b in k)].copy_(t)
        return out


def place(x, sharding: NamedSharding, *,
          may_alias: bool = False) -> ShardedTensor:
    """One leaf under ``sharding``: each block copied once to each device
    that holds it.  With ``may_alias``, a block that is the whole leaf on
    the leaf's own device is the leaf itself (no copy)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    index = sharding.indices(t.shape)
    made: Dict[tuple, torch.Tensor] = {}
    shards = []
    for dev, sl in zip(sharding.mesh.devices.flat, index):
        k = (str(dev), _key(sl))
        if k not in made:
            src = t[sl]
            if may_alias and src.shape == t.shape and t.device == dev:
                made[k] = t
            else:
                blk = torch.empty(src.shape, dtype=t.dtype, device=dev)
                made[k] = blk.copy_(src)
        shards.append(made[k])
    return ShardedTensor(t.shape, t.dtype, sharding, shards, index)


def device_put(tree, shardings, *, may_alias: bool = False):
    """``tree``'s leaves placed under ``shardings`` (a matching tree of
    ``NamedSharding``s, or one for every leaf): a tree of
    ``ShardedTensor``s.  The blocks are new storage unless
    ``may_alias`` (see ``place``)."""
    if isinstance(shardings, NamedSharding):
        return tree_map(lambda x: place(x, shardings, may_alias=may_alias),
                        tree)
    return tree_map(lambda x, s: place(x, s, may_alias=may_alias), tree,
                    shardings)


def gather(tree, device=None):
    """Every ``ShardedTensor`` of ``tree`` whole on ``device`` (default:
    its first mesh device's), other leaves as they are."""
    return tree_map(lambda x: x.full(device)
                    if isinstance(x, ShardedTensor) else x, tree)


__all__ = ["NamedSharding", "P", "PartitionSpec", "ShardedTensor",
           "ShardingPolicy", "batch_pspecs", "cache_pspecs", "device_put",
           "gather", "param_spec", "params_pspecs", "place", "state_pspecs",
           "to_shardings", "tree_map", "tree_map_with_path"]
