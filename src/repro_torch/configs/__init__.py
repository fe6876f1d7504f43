"""Architecture config registry: ``get_config("olmo-1b")`` etc. — the
reference's configurations (``repro.configs``) copied as data."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                      shape_applicable)

_MODULES = {
    "olmo-1b": "olmo_1b",
    "starcoder2-15b": "starcoder2_15b",
    "chatglm3-6b": "chatglm3_6b",
    "llama3.2-1b": "llama3_2_1b",
    "dbrx-132b": "dbrx_132b",
    "grok-1-314b": "grok_1_314b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llava-next-34b": "llava_next_34b",
    "rwkv6-3b": "rwkv6_3b",
}

ARCH_NAMES: List[str] = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {n: get_config(n, smoke=smoke) for n in ARCH_NAMES}


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shape_applicable",
           "get_config", "all_configs", "ARCH_NAMES"]
