"""AdamW with configurable moment dtype (bf16 moments for the >100B
archs) + global grad-norm clipping + linear-warmup cosine schedule
(``repro/optim/adamw.py``).

Trees are the params' nested dicts; ``tree_leaves`` walks them in the
reference's leaf order (dict keys sorted), the order ``global_norm``
adds the leaves' sums in.  The schedule's scalars — the learning rate,
``1 - b ** step`` and the clip scale — are f32, as the reference
computes them from its int32 step; the step counter is a 0-d int32 CPU
tensor, so no step waits on the card to read it.

The update is elementwise, as the reference's: ``apply_updates`` takes
each leaf in flat blocks of at most ``BLOCK`` elements, so no f32
temporary of a large leaf (an embedding of 65536 x 8192) is
materialized whole and no tree of clipped grads exists; the clipped
grad is cast back to its dtype before the update, as the reference's
``clip_by_global_norm`` returns it.  The new params and moments are
written into the given tensors (the port's counterpart of the
reference's ``donate_argnums``); the values are those of the
reference's functional form.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

BLOCK = 1 << 26            # elements of a leaf updated at a time


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of nested dicts / tuples in the reference's order."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for node in tree for v in tree_leaves(node)]
    return [] if tree is None else [tree]


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_opt_state(cfg: AdamWConfig, params) -> OptState:
    md = _dtype(cfg.moment_dtype)
    z = lambda p: torch.zeros_like(p, dtype=md)  # noqa: E731
    return OptState(mu=tree_map(z, params), nu=tree_map(z, params),
                    step=torch.zeros((), dtype=torch.int32))


def _f32(v) -> np.float32:
    return np.float32(v)


@functools.lru_cache(maxsize=None)
def _libm_cosf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.argtypes, fn.restype = (ctypes.c_float,), ctypes.c_float
    return fn


def _cosf(x: np.float32) -> np.float32:
    """cos of an f32 in f32 as the C library's ``cosf`` computes it (the
    function XLA's CPU backend calls for the reference's ``jnp.cos``;
    numpy's vectorized cos differs from it in the last bit for some
    arguments)."""
    return _f32(_libm_cosf()(float(x)))


def lr_at(cfg: AdamWConfig, step) -> np.float32:
    """The learning rate at ``step`` in f32, operation for operation as
    the reference's (a Python number is rounded to f32 where it meets
    the f32 step)."""
    s = int(step)
    warm = np.minimum(_f32(s) / _f32(max(cfg.warmup_steps, 1)), _f32(1.0))
    t = np.clip(_f32(s - cfg.warmup_steps)
                / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                _f32(0.0), _f32(1.0))
    cos = _f32(0.5) * (_f32(1) + _cosf(_f32(math.pi) * t))
    return _f32(cfg.lr) * warm * (_f32(0.1) + _f32(0.9) * cos)


def _blocks(t: torch.Tensor):
    flat = t.reshape(-1)
    for i in range(0, flat.numel(), BLOCK):
        yield flat[i:i + BLOCK]


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """sum(g²) in f32, a block at a time, the blocks' sums in order."""
    total = None
    for blk in _blocks(g):
        s = torch.sum(torch.square(blk.to(torch.float32)))
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32, device=g.device)
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of the leaves' f32 sums of squares, added in leaf order."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].device if leaves else "cpu")
    for g in leaves:
        total = total + _square_sum(g)
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(float(_f32(max_norm)) / torch.clamp(norm, min=1e-9),
                       max=1.0)


def clip_by_global_norm(tree, max_norm) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                tree), norm


def _update(cfg: AdamWConfig, p, g, m, v, scale, lr, bc1, bc2) -> None:
    """One leaf's update, written into p, m and v (contiguous: a
    reshape of any other layout is a copy, and the update would be
    lost)."""
    if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
        raise ValueError("AdamW updates params and moments in place: each "
                         "must be a contiguous tensor")
    b1, b2 = _f32(cfg.b1), _f32(cfg.b2)
    c1, c2 = _f32(1 - cfg.b1), _f32(1 - cfg.b2)
    eps, wd = _f32(cfg.eps), _f32(cfg.weight_decay)
    for pb, gb, mb, vb in zip(_blocks(p), _blocks(g), _blocks(m),
                              _blocks(v)):
        gf = (gb.to(torch.float32) * scale).to(gb.dtype).to(torch.float32)
        m32 = float(b1) * mb.to(torch.float32) + float(c1) * gf
        v32 = float(b2) * vb.to(torch.float32) + float(c2) * torch.square(gf)
        mhat = m32 / float(bc1)
        vhat = v32 / float(bc2)
        delta = mhat / (torch.sqrt(vhat) + float(eps))
        pf = pb.to(torch.float32)
        pf = pf - float(lr) * (delta + float(wd) * pf)
        pb.copy_(pf)
        mb.copy_(m32)
        vb.copy_(v32)


def apply_updates(cfg: AdamWConfig, params, grads, state: OptState
                  ) -> Tuple[Any, OptState, dict]:
    """Clip ``grads`` by their global norm and take one AdamW step,
    written into ``params`` and ``state``'s tensors: (params, opt state,
    {"grad_norm", "lr"}), the given trees returned."""
    leaves = [tree_leaves(t) for t in (params, grads, state.mu, state.nu)]
    if len({len(v) for v in leaves}) != 1:
        raise ValueError(f"params, grads, mu and nu have "
                         f"{[len(v) for v in leaves]} leaves")
    with torch.no_grad():
        norm = global_norm(grads)
        scale = _clip_scale(norm, cfg.grad_clip)
        step = int(state.step) + 1
        lr = lr_at(cfg, step)
        bc1 = _f32(1) - _f32(cfg.b1) ** _f32(step)
        bc2 = _f32(1) - _f32(cfg.b2) ** _f32(step)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.mu), tree_leaves(state.nu)):
            _update(cfg, p, g, m, v, scale, lr, bc1, bc2)
        state.step.fill_(step)
    return params, state, {
        "grad_norm": norm,
        "lr": torch.tensor(lr, dtype=torch.float32, device=norm.device)}
