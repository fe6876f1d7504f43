"""Checkpointing: atomic-commit manifests, async save, and restore.

Replaces ``repro/checkpoint/store.py`` with the same layout and
manifest keys, so an f32 checkpoint written by either package is read
by the other:

  <dir>/step_000123/
    manifest.json    tree structure, dtypes/shapes, step, extra state
    arr_00000.npy …  one file per leaf, the whole leaf
  <dir>/LATEST       committed step pointer — written LAST (atomic rename),
                     so a crash mid-save never corrupts the restore point.

Trees are dicts, lists, tuples and named tuples (a ``TrainState``) of
tensors (or arrays, or numbers), flattened by this module's own walk in
the reference's leaf order: dict keys sorted, sequences in order,
``None`` a node without leaves; ``restore`` gives a named tuple back as
its own type.  A
leaf is saved from ``t.detach().cpu()``.  bfloat16 has no numpy dtype
here, so a bf16 leaf is saved as its ``uint16`` bits with ``"dtype":
"bfloat16"`` in the manifest (the string the reference writes for one)
and restored bit for bit.  A sharded leaf (a ``ShardedTensor`` of
``distributed/sharding.py``) is gathered and saved whole, in the same
format, so either package reads the result whatever mesh wrote it.
``restore`` puts each leaf on its target tensor's device and dtype (a
``meta`` target's on ``device=``), or, with ``shardings=`` (a matching
tree of ``NamedSharding``s, whose mesh may differ from the one the
checkpoint was written under: the elastic restart), places its blocks
on their devices.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"


class _LeafRef:
    """Placeholder marking leaf ``i`` inside the structure spec."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _flatten(tree) -> Tuple[list, Any]:
    """(leaves, skeleton): the leaves in the reference's order and the
    tree with a ``_LeafRef`` in place of each."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            items = [walk(v) for v in node]
            return _rebuild(node, items)
        if node is None:
            return None
        leaves.append(node)
        return _LeafRef(len(leaves) - 1)

    return leaves, walk(tree)


def _rebuild(node, items: list):
    """``items`` in ``node``'s sequence type (a named tuple's own)."""
    if isinstance(node, tuple):
        return type(node)(*items) if hasattr(node, "_fields") else \
            tuple(items)
    return items


def _unflatten(skeleton, leaf: Callable[[int], Any]):
    if isinstance(skeleton, _LeafRef):
        return leaf(skeleton.i)
    if isinstance(skeleton, dict):
        return {k: _unflatten(v, leaf) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return _rebuild(skeleton, [_unflatten(v, leaf) for v in skeleton])
    return skeleton


def _treedef_str(skeleton) -> str:
    """The skeleton in the spelling of a printed ``PyTreeDef`` (the
    manifest's ``treedef``: informative, never parsed)."""
    def show(node):
        if isinstance(node, _LeafRef):
            return "*"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {show(v)}"
                                   for k, v in node.items()) + "}"
        if isinstance(node, tuple):
            inner = ", ".join(show(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if isinstance(node, list):
            return "[" + ", ".join(show(v) for v in node) + "]"
        return "None"
    return f"PyTreeDef({show(skeleton)})"


def _encode_structure(node):
    """JSON-able spec of a dict/list/tuple tree with ``_LeafRef``
    placeholders at leaf positions; raises TypeError on any node the
    spec cannot represent (non-str dict keys)."""
    if isinstance(node, _LeafRef):
        return {"t": "leaf", "i": node.i}
    if isinstance(node, dict):
        if any(not isinstance(k, str) for k in node):
            raise TypeError("structure spec needs str dict keys")
        return {"t": "dict",
                "items": {k: _encode_structure(v) for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"t": "tuple" if isinstance(node, tuple) else "list",
                "items": [_encode_structure(v) for v in node]}
    if node is None:
        return {"t": "none"}
    raise TypeError(f"cannot encode pytree node of type {type(node)!r}")


def _decode_structure(spec, load: Callable[[int], Any]):
    t = spec["t"]
    if t == "leaf":
        return load(spec["i"])
    if t == "dict":
        return {k: _decode_structure(v, load)
                for k, v in spec["items"].items()}
    if t == "list":
        return [_decode_structure(v, load) for v in spec["items"]]
    if t == "tuple":
        return tuple(_decode_structure(v, load) for v in spec["items"])
    if t == "none":
        return None
    raise ValueError(f"unknown structure node {t!r}")


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array written to its ``.npy`` and the manifest's
    dtype string: bf16 as its ``uint16`` bits."""
    from repro_torch.distributed.sharding import ShardedTensor
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.full("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded ``.npy`` as a CPU tensor; a bf16 leaf from its 16-bit
    words (``uint16`` from this package, two-byte records from a
    reference written with ``ml_dtypes``)."""
    if dtype == BF16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _step_dir(ckpt_dir, step: Optional[int]) -> Path:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    return Path(ckpt_dir) / f"step_{step:09d}"


def save(ckpt_dir: str, step: int, tree, *, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Synchronous save with atomic commit."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    step_name = f"step_{step:09d}"
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=f".{step_name}."))
    try:
        leaves, skeleton = _flatten(tree)
        # Self-describing structure spec (dict/list/tuple trees only):
        # lets ``restore_blind`` rebuild the tree with NO target skeleton
        # — the recovery path, where the restarted process knows nothing
        # about the params structure it is about to inherit.
        try:
            structure = _encode_structure(skeleton)
        except TypeError:
            structure = None
        manifest = {
            "step": step,
            "treedef": _treedef_str(skeleton),
            "n_leaves": len(leaves),
            "leaves": [],
            "structure": structure,
            "extra": extra or {},
        }
        for i, leaf in enumerate(leaves):
            arr, dtype = _to_numpy(leaf)
            np.save(tmp / f"arr_{i:05d}.npy", arr)
            manifest["leaves"].append(
                {"shape": list(arr.shape), "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = ckpt_dir / step_name
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic on same fs
        latest_tmp = ckpt_dir / ".LATEST.tmp"
        latest_tmp.write_text(step_name)
        os.replace(latest_tmp, ckpt_dir / "LATEST")  # commit point
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    _gc(ckpt_dir, keep)
    return str(ckpt_dir / step_name)


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.iterdir()
                   if p.is_dir() and p.name.startswith("step_"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread; at most one in flight
    (a newer snapshot supersedes a queued older one)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: Optional[tuple] = None
        self._thread: Optional[threading.Thread] = None
        self.saved_steps: list = []

    def save(self, step: int, tree, extra: Optional[Dict] = None):
        # Copy to the host *now*: the caller may update the tensors in
        # place before the worker writes them.
        from repro_torch.distributed.sharding import ShardedTensor
        leaves, skeleton = _flatten(tree)
        host = [x.full("cpu", copy=True) if isinstance(x, ShardedTensor)
                else x.detach().to("cpu", copy=True)
                if isinstance(x, torch.Tensor) else np.array(x)
                for x in leaves]
        host_tree = _unflatten(skeleton, host.__getitem__)
        with self._lock:
            self._pending = (step, host_tree, extra)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._drain,
                                                daemon=True)
                self._thread.start()

    def _drain(self):
        while True:
            with self._lock:
                item, self._pending = self._pending, None
            if item is None:
                return
            step, tree, extra = item
            save(self.ckpt_dir, step, tree, extra=extra, keep=self.keep)
            self.saved_steps.append(step)

    def wait(self):
        t = self._thread
        if t is not None:
            t.join()


def latest_step(ckpt_dir: str) -> Optional[int]:
    latest = Path(ckpt_dir) / "LATEST"
    if not latest.exists():
        return None
    return int(latest.read_text().strip().split("_")[-1])


def restore_blind(ckpt_dir: str, *, step: Optional[int] = None
                  ) -> Tuple[Any, Dict]:
    """Rebuild the saved tree with no target skeleton, from the
    manifest's structure spec — the crash-recovery entry point
    (``runtime/recovery.py``): a restarted process inherits params whose
    structure only the checkpoint knows.  Leaves come back as CPU
    tensors.  Raises ValueError for a checkpoint without a structure
    spec (use ``restore`` with an explicit target there)."""
    d = _step_dir(ckpt_dir, step)
    manifest = json.loads((d / "manifest.json").read_text())
    structure = manifest.get("structure")
    if structure is None:
        raise ValueError(
            "checkpoint carries no structure spec (custom pytree nodes); "
            "restore() with a target tree is required")

    def _load(i: int):
        return _to_tensor(np.load(d / f"arr_{i:05d}.npy"),
                          manifest["leaves"][i]["dtype"])

    return _decode_structure(structure, _load), manifest["extra"]


def restore(ckpt_dir: str, target_tree, *, step: Optional[int] = None,
            device=None, shardings=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target_tree``: each leaf takes
    its target tensor's dtype and device (an array or number target, its
    dtype); a ``meta`` target (an abstract tree) puts its leaf on
    ``device`` (default the CPU).  ``shardings``: a matching tree of
    ``NamedSharding``s — each leaf is loaded whole on the host, takes its
    target's dtype and is placed under its sharding
    (``sharding.place``), a ``ShardedTensor`` whose blocks sit on their
    mesh devices."""
    from repro_torch.distributed.sharding import NamedSharding, place
    d = _step_dir(ckpt_dir, step)
    manifest = json.loads((d / "manifest.json").read_text())
    leaves, skeleton = _flatten(target_tree)
    assert manifest["n_leaves"] == len(leaves), \
        f"checkpoint has {manifest['n_leaves']} leaves, target {len(leaves)}"
    if shardings is None:
        shards = [None] * len(leaves)
    else:
        shards, _ = _flatten(shardings)
        if len(shards) != len(leaves) or not all(
                isinstance(s, NamedSharding) for s in shards):
            raise ValueError(f"shardings needs one NamedSharding a leaf: "
                             f"{len(shards)} for {len(leaves)} leaves")
    new_leaves = []
    for i, (ref, shd) in enumerate(zip(leaves, shards)):
        arr = np.load(d / f"arr_{i:05d}.npy")
        ref_shape = tuple(ref.shape) if hasattr(ref, "shape") else ()
        assert tuple(arr.shape) == ref_shape, (arr.shape, ref_shape)
        if not isinstance(ref, torch.Tensor):
            new_leaves.append(arr.astype(np.asarray(ref).dtype))
            continue
        t = _to_tensor(arr, manifest["leaves"][i]["dtype"])
        if shd is not None:
            new_leaves.append(place(t.to(ref.dtype), shd, may_alias=True))
        else:
            dev = ref.device if ref.device.type != "meta" else \
                torch.device(device or "cpu")
            new_leaves.append(t.to(device=dev, dtype=ref.dtype))
    return _unflatten(skeleton, new_leaves.__getitem__), manifest["extra"]
