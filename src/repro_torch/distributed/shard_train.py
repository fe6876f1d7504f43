"""The sharded train step: one step of a ``TrainState`` placed on a
("data", "model") mesh (or ("pod", "data", "model")) under the single
controller.  The counterpart of the reference's
``jax.jit(api.train_step, in_shardings=(state, batch))``, beside
serving's ``shard_exec.py``; its semantics are the single-device
step's (``models/api.py::train_step``) with GSPMD's split of the
compute over "model":

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
* Each data rank runs forward and backward of its rows over its model
  ranks (``tensor_parallel``): the residual stream on its first model
  rank's device, each sublayer that ``param_spec`` splits over "model"
  (attention and cross-attention, the dense FFN, Mamba, RWKV's mixes,
  the vocabulary) on every model rank with that rank's block (RWKV: its
  whole heads) only, the outputs summed in rank order (Megatron's
  column-parallel in, row-parallel out, as GSPMD runs the reference's
  specs); so do the MoE experts, by expert or by hidden column; the
  rest (norms, the router) runs on the first model rank.  ZeRO-3 a
  layer group at a time: a layer-stack leaf that FSDP splits over the
  data axes is gathered (``tensor_parallel.Deferred``) inside the
  function ``transformer.remat_group`` wraps, so a group's gathered
  blocks live while the group runs, are dropped after its forward and
  gathered again in its recompute; the other FSDP leaves (``embed``,
  ``lm_head``) are gathered for the pass, as the reference gathers
  them outside its scan.
* A leaf's gradient is kept by model block (its block along "model",
  whole along the data axes): summed over the data ranks in data-rank
  order on the block's holder (the first data rank's position at that
  model coordinate).  A layer-stack leaf that FSDP splits lands on its
  FSDP blocks instead: as the backward leaves a group, the group's
  gradient is cut into the blocks' pieces and added on each block's
  device (a reduce-scatter; ``tensor_parallel.ZeroPass``,
  ``ShardGrads``), in data-rank order, so no device holds it whole
  along the data axes.  Each is divided by the number of ranks (each
  rank's loss is a mean over equally many tokens), and the loss and its
  parts are the ranks' mean in the same order.
* The global grad norm for clipping keeps the single-device step's leaf
  order (``optim/adamw.py::global_norm``), a leaf's square sum taken
  over its model blocks in block order, each as ``_square_sum`` of the
  whole block gives it (a landed leaf's runs of ``adamw.BLOCK``
  elements assembled on the block's holder one at a time).
* Each block of params and moments is updated once, on its device,
  with its slice of its model block's gradient, or its own landed
  gradient (``adamw._update``, elementwise: a block's update is bitwise
  the whole leaf's).

With a model degree of 1 a leaf is one block and the step is the
unsplit one: a data degree of 1 then computes bitwise the single-device
step.  With a model degree above 1 the row-parallel sums change the
order of additions, as GSPMD's do in the reference: the step holds the
single-device step within ``tests/test_torch_train.py``'s bars, and
bitwise the same split run on one device (``tensor_parallel.
local_split``).

Under ``collectives.counting`` the step names the logical rank each
part runs on (``collectives.on_rank``; a split sublayer's backward on
the rank whose forward made it, ``collectives.enter``/``leave``) and
records its moves: the gathers over "data" (all-gathers, a layer
group's each time the group runs), the landed gradients
(reduce-scatters, one a group a leaf a model rank), the model group's
sums (all-reduces of group = the model degree, forward and backward),
Mamba's ``in_proj`` columns and each gradient piece that another
position holds (collective-permutes), each block's square sum to the
first rank, and each block's gradient slice to its holder.  A
data rank's pass (its gathers, forward and backward over its model
ranks) and each block's update run through ``collectives.rank_work``;
nothing of that changes what the step computes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import ShardedTensor, batch_pspecs
from repro_torch.launch.mesh import dp_axes, mesh_axis_sizes
from repro_torch.models import api
from repro_torch.models.transformer import moe_num_groups
from repro_torch.optim.adamw import (AdamWConfig, _clip_scale, _f32,
                                     _square_sum, _update, lr_at,
                                     tree_leaves)


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


def pass_ranks(mesh, r: int, wide: bool) -> Tuple[int, ...]:
    """The ranks data rank ``r``'s pass works on: its model ranks, and,
    where ``wide``, every other data rank's positions after them, in
    data-rank order (the same roles in every pass): where a
    ``per_group`` leaf's gradient lands on its FSDP blocks
    (``tensor_parallel.ZeroPass``), or a pass that runs whole attends
    over a cache split over the data axes where it lies."""
    pos = tp.model_positions(mesh)
    if not wide:
        return tuple(pos[r])
    return tuple(pos[r]) + tuple(i for d, row in enumerate(pos) if d != r
                                 for i in row)


def loss_and_grads(cfg: ModelConfig, mesh, params, batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], list]:
    """(loss, {"xent", "aux"}, grads) of the whole batch: ``grads[i]``
    is leaf i's (``tree_leaves`` order) list of model blocks
    (``tensor_parallel.model_blocks``) on their holders, or, for a
    ``per_group`` leaf, a ``tensor_parallel.ShardGrads`` on its FSDP
    blocks."""
    devs = forward_devices(mesh)
    ranks = forward_ranks(mesh)
    n, groups = row_split(cfg, mesh, batch)
    home = devs[0]
    kw = {} if groups is None else {"moe_groups": groups}
    plans = tp.plan_leaves(cfg, mesh, params)
    leaves = tree_leaves(params)
    dtypes = [leaf.dtype for leaf in leaves]
    shards = {i: tp.ShardGrads(leaves[i]) for i, p in enumerate(plans)
              if p.per_group}
    acc: list = []
    losses, parts = [], []
    for r in range(n):
        dev = devs[r]
        with collectives.on_rank(ranks[r]):
            rows = {k: v.narrow(0, r * (v.shape[0] // n),
                                v.shape[0] // n).to(dev)
                    for k, v in batch.items()}
        key = ("pass", tuple((k, tuple(v.shape), v.dtype)
                             for k, v in rows.items()), groups)
        loss, metrics, grads = collectives.rank_work(
            key, ranks[r],
            lambda: _rank_grads(cfg, params, mesh, r, plans, rows, kw,
                                shards),
            ranks=pass_ranks(mesh, r, bool(shards)))
        tp.block_grads(plans, mesh, r, grads, acc, dtypes)
        del grads
        losses.append(loss.detach().to(home))
        parts.append({k: v.detach().to(home) for k, v in metrics.items()})
    for i, sg in shards.items():
        acc[i] = sg
    pos = tp.model_positions(mesh)
    for blocks in acc:
        if isinstance(blocks, tp.ShardGrads):
            blocks.finish(n)
            continue
        for j, g in enumerate(blocks):
            if n > 1:
                with collectives.on_rank(pos[0][j]):
                    blocks[j] = g / n
    return (_rank_mean(losses),
            {k: _rank_mean([p[k] for p in parts]) for k in parts[0]}, acc)


def _rank_grads(cfg: ModelConfig, params, mesh, r: int, plans, rows, kw,
                shards):
    """Data rank ``r``'s pass over its model ranks: (loss, metrics,
    grads), ``grads[i][m]`` the gradient of model rank m's tensor of
    leaf i (None where it holds none or it is unused); a ``per_group``
    leaf's gradient lands in ``shards[i]`` instead (``tensor_parallel.
    ZeroPass``), a group at a time as the backward leaves it."""
    zero = None
    if shards:
        group = tp.model_group(mesh, r)
        with collectives.on_rank(group.ranks[0]):
            zero = tp.ZeroPass(group.devices[0], plans, shards)
    tree, leaves = tp.rank_params(cfg, params, mesh, r, plans, zero=zero)
    flat = [(i, m, x) for i, per in enumerate(leaves)
            for m, x in enumerate(per) if isinstance(x, torch.Tensor)]
    extra = [] if zero is None else [zero.token]
    with torch.enable_grad():
        for _, _, x in flat:
            x.requires_grad_(True)
        try:
            loss, metrics = api.loss_fn(cfg, tree, rows, **kw)
            got = torch.autograd.grad(loss, [x for _, _, x in flat] + extra,
                                      allow_unused=True)
        finally:
            for _, _, x in flat:
                x.requires_grad_(False)
    if zero is not None:
        zero.flush()
    grads = [[None] * len(plans[0].pieces) for _ in plans]
    for (i, m, _), g in zip(flat, got):
        grads[i][m] = g
    del tree, leaves
    return loss, metrics, grads


def apply_updates(cfg: AdamWConfig, state, grads: list):
    """Clip ``grads`` (``loss_and_grads``': by leaf, by model block or
    on the FSDP blocks) by their global norm and take one AdamW step on
    the sharded ``state``, each block once on its device: (state,
    {"grad_norm", "lr"}), ``state`` updated in place.  A leaf's square
    sum is its model blocks' in block order, each as ``_square_sum`` of
    the whole block gives it (a ``ShardGrads`` assembles each run of
    ``adamw.BLOCK`` elements on the block's holder)."""
    params, mu, nu = (tree_leaves(t) for t in (state.params, state.opt.mu,
                                                state.opt.nu))
    if not len(params) == len(mu) == len(nu) == len(grads):
        raise ValueError(f"params, grads, mu and nu have "
                         f"{[len(params), len(grads), len(mu), len(nu)]} "
                         f"leaves")
    mesh = state.opt.step.sharding.mesh
    tpd = mesh_axis_sizes(mesh).get("model", 1)
    pos = tp.model_positions(mesh)
    home = pos[0][0]
    with torch.no_grad():
        with collectives.on_rank(home):
            norm = torch.zeros((), dtype=torch.float32,
                               device=mesh.devices.flat[home])
        for p, blocks in zip(params, grads):
            shards = blocks if isinstance(blocks, tp.ShardGrads) else None
            if shards is not None:      # its model blocks, assembled
                blocks = tp.model_blocks(tuple(p.shape), p.sharding.spec,
                                         tpd)
            for j, g in enumerate(blocks):
                at = pos[0][j]
                with collectives.on_rank(at):
                    sq = (_square_sum(g) if shards is None else
                          shards.square_sum(g, at, mesh.devices.flat[at]))
                if at != home:
                    collectives.record("collective-permute",
                                       sq.element_size(), 2, home)
                with collectives.on_rank(home):
                    norm = norm + sq.to(norm.device)
        with collectives.on_rank(home):
            norm = torch.sqrt(norm)
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
            regions = tp.model_blocks(tuple(p.shape), p.sharding.spec, tpd)
            for k, (sl, pb, i) in enumerate(p.blocks()):
                if isinstance(g, tp.ShardGrads):    # on the block's device
                    gb = g.tensors[k]
                else:
                    j = next(j for j, reg in enumerate(regions)
                             if all(reg[d].start <= s.start and
                                    s.stop <= reg[d].stop
                                    for d, s in enumerate(sl)))
                    gb = g[j][tuple(slice(s.start - r.start,
                                          s.stop - r.start)
                                    for s, r in zip(sl, regions[j]))]
                    if i != pos[0][j]:
                        collectives.record("collective-permute",
                                           gb.numel() * gb.element_size(), 2,
                                           i)
                dev = pb.device
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


def whole_grads(params, grads: list, device="cpu"
                ) -> List[torch.Tensor]:
    """``loss_and_grads``' gradients whole on ``device``, in
    ``tree_leaves`` order: each leaf's model blocks concatenated along
    its "model" dimension (a ``ShardGrads``' blocks put in place)."""
    out = []
    for p, blocks in zip(tree_leaves(params), grads):
        if isinstance(blocks, tp.ShardGrads):
            out.append(blocks.whole(device))
            continue
        dim = next((d for d, e in enumerate(p.sharding.spec)
                    if e == "model"), 0)
        out.append(torch.cat([b.to(device) for b in blocks], dim=dim))
    return out


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
