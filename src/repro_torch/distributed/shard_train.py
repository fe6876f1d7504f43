"""The sharded train step: one step of a ``TrainState`` placed on a
("data", "model") mesh (or ("pod", "data", "model")) under the single
controller.  The counterpart of the reference's
``jax.jit(api.train_step, in_shardings=(state, batch))``, beside
serving's ``shard_exec.py``; its semantics are the single-device
step's (``models/api.py::train_step``):

* The state lives as ``ShardedTensor`` blocks under ``state_pspecs``
  (``distributed/sharding.py::device_put``); the mesh is the one its
  leaves are placed on.
* The batch's rows split over the data ranks by ``batch_pspecs``.  A
  batch that does not divide stays whole and runs once, and so does an
  MoE config whose capacity groups over the whole batch
  (``transformer.moe_num_groups``) do not divide by the data degree:
  the groups are contiguous runs of tokens, so where they divide, each
  rank runs its rows with its share of them (``moe_groups=``) and
  capacity and dropped tokens are those of the whole batch.
* Each data rank runs forward and backward on its rows on its device
  (the rank's device at model coordinate 0).  The params are gathered
  whole on that device for the rank's pass, ZeRO-3 style, and dropped
  after it; a leaf held whole there is used in place, with no copy.
* The ranks' gradients are summed in rank order into one buffer on the
  first rank's device (``collectives.psum``'s order:
  ``((g0 + g1) + g2) ...``), divided by the number of ranks (each
  rank's loss is a mean over equally many tokens, so the mean of the
  ranks' losses is the whole batch's), and the loss and its parts are
  the ranks' mean in the same order.
* The global grad norm for clipping is computed once over the whole
  gradients, in the single-device step's leaf order
  (``optim/adamw.py::global_norm``).
* Each block of params and moments is updated once, on its device,
  with its slice of the gradient (``adamw._update``, elementwise: a
  block's update is bitwise the whole leaf's).

So a mesh whose data degree is 1 computes bitwise the single-device
step.  The model axis splits storage and the optimizer's work; the
forward does not split its products over it (no column- and
row-parallel compute).

Under ``collectives.counting`` the step names the logical rank each
part runs on (``collectives.on_rank``: a data rank's pass on its
position, the sums, the norm and the clip on the first rank's, each
block's update on its first holder's) and records its moves: the
params' gathers (all-gathers), each rank's gradients to the first rank
and each block's gradient slice back to its holder (collective-permutes
of what moves between two positions).  A rank's pass (its gather,
forward and backward) and each block's update run through
``collectives.rank_work``; nothing of that changes what the step
computes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (ShardedTensor, batch_pspecs,
                                              gather)
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import api
from repro_torch.models.transformer import moe_num_groups
from repro_torch.optim.adamw import (AdamWConfig, _clip_scale, _f32, _update,
                                     global_norm, lr_at, tree_leaves)


def forward_ranks(mesh) -> List[int]:
    """The data ranks' mesh positions (``mesh.devices.flat`` order) in
    rank order (the dp axes, the first major), each at coordinate 0 of
    the other axes."""
    dpx = dp_axes(mesh)
    at = tuple(slice(None) if a in dpx else 0 for a in mesh.axis_names)
    flat = np.arange(mesh.size).reshape(mesh.devices.shape)
    return [int(i) for i in flat[at].reshape(-1)]


def forward_devices(mesh) -> List[torch.device]:
    """The data ranks' devices in rank order (``forward_ranks``'
    positions)."""
    return [mesh.devices.flat[i] for i in forward_ranks(mesh)]


def row_split(cfg: ModelConfig, mesh, batch) -> Tuple[int, Optional[int]]:
    """(ranks the batch's rows split over, MoE groups a rank or None):
    ``(1, None)`` where the batch runs whole."""
    dp = len(forward_devices(mesh))
    if dp == 1 or any(s[0] is None for s in
                      tree_leaves(batch_pspecs(cfg, mesh, batch))):
        return 1, None
    if cfg.moe is None or cfg.family == "encdec":
        return dp, None
    x = batch["embeds"] if cfg.embed_inputs else batch["tokens"]
    n_tokens = x.shape[0] * x.shape[1]
    groups = moe_num_groups(n_tokens)
    if n_tokens % groups:     # apply_moe then runs one group
        groups = 1
    if groups % dp:
        return 1, None
    return dp, groups // dp


def _mesh_of(state):
    for leaf in tree_leaves(state.params):
        if isinstance(leaf, ShardedTensor):
            return leaf.sharding.mesh
    raise ValueError("the state holds no ShardedTensor: place it with "
                     "sharding.device_put under state_pspecs")


def _rank_mean(values: List[torch.Tensor]) -> torch.Tensor:
    total = values[0]
    for v in values[1:]:
        total = total + v
    return total if len(values) == 1 else total / len(values)


def loss_and_grads(cfg: ModelConfig, mesh, params, batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              List[torch.Tensor]]:
    """(loss, {"xent", "aux"}, grads) of the whole batch: the grads are
    whole, in ``tree_leaves`` order, on the first data rank's device."""
    devs = forward_devices(mesh)
    ranks = forward_ranks(mesh)
    n, groups = row_split(cfg, mesh, batch)
    home = devs[0]
    kw = {} if groups is None else {"moe_groups": groups}
    total: List[torch.Tensor] = []
    losses, parts = [], []
    for r in range(n):
        dev = devs[r]
        with collectives.on_rank(ranks[r]):
            rows = {k: v.narrow(0, r * (v.shape[0] // n),
                                v.shape[0] // n).to(dev)
                    for k, v in batch.items()}
        key = ("pass", tuple((k, tuple(v.shape), v.dtype)
                             for k, v in rows.items()), groups)
        loss, metrics, leaves, grads = collectives.rank_work(
            key, ranks[r],
            lambda: _rank_grads(cfg, params, dev, ranks[r], rows, kw))
        with collectives.on_rank(ranks[0]):
            for i, (p, g) in enumerate(zip(leaves, grads)):
                g = (torch.zeros_like(p) if g is None else g).to(home)
                if r:
                    collectives.record("collective-permute",
                                       g.numel() * g.element_size(), 2)
                grads[i] = None
                if r == 0:
                    total.append(g)
                else:
                    total[i] = total[i] + g
        del leaves, grads
        losses.append(loss.detach().to(home))
        parts.append({k: v.detach().to(home) for k, v in metrics.items()})
    if n > 1:
        with collectives.on_rank(ranks[0]):
            for i in range(len(total)):
                total[i] = total[i] / n
    return (_rank_mean(losses),
            {k: _rank_mean([p[k] for p in parts]) for k in parts[0]}, total)


def _rank_grads(cfg: ModelConfig, params, dev, rank: int, rows, kw):
    """One data rank's pass: the params gathered whole on ``dev``, then
    (loss, metrics, the gathered leaves and their grads, both in
    ``tree_leaves`` order, a grad None where unused)."""
    local = gather(params, dev, rank=rank)
    leaves = tree_leaves(local)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = api.loss_fn(cfg, local, rows, **kw)
            grads = list(torch.autograd.grad(loss, leaves,
                                             allow_unused=True))
        finally:
            for p in leaves:
                p.requires_grad_(False)
    return loss, metrics, leaves, grads


def apply_updates(cfg: AdamWConfig, state, grads: List[torch.Tensor]):
    """Clip ``grads`` (whole, ``tree_leaves`` order) by their global norm
    and take one AdamW step on the sharded ``state``, each block once on
    its device: (state, {"grad_norm", "lr"}), ``state`` updated in
    place."""
    params, mu, nu = (tree_leaves(t) for t in (state.params, state.opt.mu,
                                                state.opt.nu))
    if not len(params) == len(mu) == len(nu) == len(grads):
        raise ValueError(f"params, grads, mu and nu have "
                         f"{[len(params), len(grads), len(mu), len(nu)]} "
                         f"leaves")
    home = forward_ranks(state.opt.step.sharding.mesh)[0]
    with torch.no_grad(), collectives.on_rank(home):
        norm = global_norm(grads)
        scale = _clip_scale(norm, cfg.grad_clip)
        step = int(state.opt.step.shards[0]) + 1
        lr = lr_at(cfg, step)
        bc1 = _f32(1) - _f32(cfg.b1) ** _f32(step)
        bc2 = _f32(1) - _f32(cfg.b2) ** _f32(step)
        for p, m, v, g in zip(params, mu, nu, grads):
            if not (isinstance(p, ShardedTensor) and isinstance(
                    m, ShardedTensor) and isinstance(v, ShardedTensor)
                    and p.index == m.index == v.index):
                raise ValueError("params and moments must be ShardedTensors "
                                 "placed under one spec a leaf")
            for sl, pb, i in p.blocks():
                dev = pb.device
                gb = g[sl]
                if i != home:
                    collectives.record("collective-permute",
                                       gb.numel() * gb.element_size(), 2, i)
                key = ("update",) + tuple(
                    (tuple(t.shape), t.dtype, t.is_contiguous())
                    for t in (pb, gb, m.shards[i], v.shards[i]))
                collectives.rank_work(
                    key, i, lambda: _update(cfg, pb, gb.to(dev), m.shards[i],
                                            v.shards[i], scale.to(dev), lr,
                                            bc1, bc2))
        for _, t, _ in state.opt.step.blocks():
            t.fill_(step)
    return state, {"grad_norm": norm,
                   "lr": torch.tensor(lr, dtype=torch.float32,
                                      device=norm.device)}


def train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, state, batch):
    """One step of a sharded ``TrainState`` (``state_pspecs`` blocks on
    their mesh): ``(state, metrics)`` with the single-device step's
    metrics (``loss``, ``xent``, ``aux``, ``grad_norm``, ``lr``: 0-d f32
    tensors on the first data rank's device).  The blocks are updated in
    place and the state returned."""
    loss, parts, grads = loss_and_grads(cfg, _mesh_of(state), state.params,
                                        batch)
    state, opt_metrics = apply_updates(opt_cfg, state, grads)
    del grads
    metrics = dict(parts)
    metrics.update(loss=loss, **opt_metrics)
    return state, metrics
