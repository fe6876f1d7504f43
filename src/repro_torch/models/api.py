"""Model API over decoder-only and encoder-decoder stacks, serving
subset (``repro/models/api.py``).

  init_params(cfg, generator, device=)
  prefill_step / decode_step / init_decode_caches

Every architecture of ``configs.ARCH_NAMES`` serves: dense, MoE, hybrid
and ssm through ``transformer``, the encoder-decoder family through
``encdec``.  Training (``loss_fn``, ``init_train_state``,
``train_step``) is ROADMAP queue 1, item 12 and raises
``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer

UNPORTED = "is not ported yet (ROADMAP queue 1, item 12)"


def _mod(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else transformer


def init_params(cfg: ModelConfig, generator=0, *, device=None):
    return _mod(cfg).init_params(cfg, generator, device=device)


def loss_fn(cfg: ModelConfig, params, batch):
    raise NotImplementedError(f"training (loss_fn) {UNPORTED}")


def init_train_state(cfg: ModelConfig, opt_cfg, generator=0):
    raise NotImplementedError(f"training (init_train_state) {UNPORTED}")


def train_step(cfg: ModelConfig, opt_cfg, state, batch):
    raise NotImplementedError(f"training (train_step) {UNPORTED}")


def prefill_step(cfg: ModelConfig, params, batch, *, pad_to=None):
    return _mod(cfg).prefill(cfg, params, batch, pad_to=pad_to)


def decode_step(cfg: ModelConfig, params, caches, tokens, pos):
    return _mod(cfg).decode_step(cfg, params, caches, tokens, pos)


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                       device=None):
    return _mod(cfg).init_decode_caches(cfg, batch, max_len, device=device)
