"""grok-1-314b [moe] — 64L d=6144 48H (GQA kv=8) ff=32768 V=131072,
MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    norm="rmsnorm", activation="geglu", rope_style="full",
    moe=MoEConfig(n_experts=8, top_k=2),
    param_dtype="bfloat16", moment_dtype="bfloat16",
    fsdp=True,
)

SMOKE = ModelConfig(
    name="grok-1-314b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=256,
    norm="rmsnorm", activation="geglu", rope_style="full",
    moe=MoEConfig(n_experts=4, top_k=2),
    compute_dtype="float32",
)
