"""dbrx-132b [moe] — 40L d=6144 48H (GQA kv=8) ff=10752 V=100352,
MoE 16 experts top-4 (fine-grained). [hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    norm="layernorm", activation="swiglu", rope_style="full",
    moe=MoEConfig(n_experts=16, top_k=4),
    param_dtype="bfloat16", moment_dtype="bfloat16",
    fsdp=True,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=96, vocab_size=256,
    norm="layernorm", activation="swiglu", rope_style="full",
    moe=MoEConfig(n_experts=4, top_k=2),
    compute_dtype="float32",
)
