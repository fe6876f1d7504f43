"""rwkv6-3b [ssm] — 32L d=2560 (attention-free) ff=8960 V=65536.

RWKV-6 "Finch": data-dependent decay time-mix + channel-mix.
Sub-quadratic: long_500k runs (O(1) recurrent state).
The attention IP family is INAPPLICABLE (no QK^T) — see DESIGN.md
§Arch-applicability; projections still route through the matmul IPs.
[arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    norm="layernorm", activation="relu_sq", rope_style="none",
    rwkv=RWKVConfig(head_size=64),
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="rwkv6-3b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=224, vocab_size=256,
    norm="layernorm", activation="relu_sq", rope_style="none",
    rwkv=RWKVConfig(head_size=16, lora_rank_decay=8, lora_rank_mix=8),
    compute_dtype="float32", sub_quadratic=True,
)
