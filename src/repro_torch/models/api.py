"""Model API over decoder-only and encoder-decoder stacks
(``repro/models/api.py``).

  init_params(cfg, generator, device=) / init_params_abstract(cfg)
  loss_fn(cfg, params, batch)                  (loss, {"xent", "aux"})
  init_train_state(cfg, opt_cfg, generator, device=)
  init_train_state_abstract(cfg, opt_cfg)      shapes and dtypes only
  train_step(cfg, opt_cfg, state, batch)       TrainState -> TrainState
  prefill_step / decode_step / init_decode_caches

Every architecture of ``configs.ARCH_NAMES`` serves and trains on one
device: dense, MoE, hybrid and ssm through ``transformer``, the
encoder-decoder family through ``encdec``.  ``train_step`` takes the
gradient of ``loss_fn`` with autograd (on a card the Mamba layers'
selective scan runs its forward and backward kernels) and applies
AdamW in place: the new params and moments are written into the
state's own tensors, the port's counterpart of the reference's
``donate_argnums``, with the values of the reference's functional step.
Carry a reference ``TrainState`` across with
``transformer.train_state_from_numpy``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.optim.adamw import (AdamWConfig, OptState, apply_updates,
                                     init_opt_state, tree_leaves)


def _mod(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else transformer


def init_params(cfg: ModelConfig, generator=0, *, device=None):
    return _mod(cfg).init_params(cfg, generator, device=device)


def init_params_abstract(cfg: ModelConfig):
    return _mod(cfg).init_params_abstract(cfg)


def loss_fn(cfg: ModelConfig, params, batch, *, moe_groups=None):
    """``moe_groups``: the MoE capacity groups of the batch's tokens,
    where a mesh's data rank runs a share of a larger batch."""
    if moe_groups is None:
        return _mod(cfg).loss_fn(cfg, params, batch)
    return transformer.loss_fn(cfg, params, batch, moe_groups=moe_groups)


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, generator=0,
                     *, device=None) -> TrainState:
    params = init_params(cfg, generator, device=device)
    return TrainState(params, init_opt_state(opt_cfg, params))


def init_train_state_abstract(cfg: ModelConfig,
                              opt_cfg: AdamWConfig) -> TrainState:
    """The train state as ``meta`` tensors (the step counter, a 0-d
    int32, stays a CPU tensor)."""
    params = init_params_abstract(cfg)
    return TrainState(params, init_opt_state(opt_cfg, params))


def train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, state: TrainState,
               batch):
    """One step: ``(state, metrics)`` with metrics ``loss``, ``xent``,
    ``aux``, ``grad_norm`` and ``lr`` (0-d f32 tensors).  ``state``'s
    tensors are updated in place and returned."""
    leaves = tree_leaves(state.params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(cfg, state.params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    params, opt, opt_metrics = apply_updates(opt_cfg, state.params, grads,
                                             state.opt)
    del grads
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics.update(loss=loss.detach(), **opt_metrics)
    return TrainState(params, opt), metrics


def prefill_step(cfg: ModelConfig, params, batch, *, pad_to=None,
                 moe_groups=None):
    """``moe_groups``: the MoE capacity groups of these rows (a data
    rank's share of the whole batch's; ``transformer.forward``)."""
    kw = {} if moe_groups is None else {"moe_groups": moe_groups}
    return _mod(cfg).prefill(cfg, params, batch, pad_to=pad_to, **kw)


def decode_step(cfg: ModelConfig, params, caches, tokens, pos, *,
                moe_groups=None):
    kw = {} if moe_groups is None else {"moe_groups": moe_groups}
    return _mod(cfg).decode_step(cfg, params, caches, tokens, pos, **kw)


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                       device=None):
    return _mod(cfg).init_decode_caches(cfg, batch, max_len, device=device)
