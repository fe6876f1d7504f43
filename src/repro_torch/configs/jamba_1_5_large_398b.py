"""jamba-1.5-large-398b [hybrid] — 72L d=8192 64H (GQA kv=8) ff=24576
V=65536; Mamba+attention 1:7 interleave; MoE 16e top-2 on alternate layers.
Sub-quadratic: long_500k runs (attention layers are 1/8 of the stack;
their KV is sequence-sharded). [arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    norm="rmsnorm", activation="swiglu", rope_style="none",
    attn_every=8,
    moe=MoEConfig(n_experts=16, top_k=2, moe_every=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    param_dtype="bfloat16", moment_dtype="bfloat16",
    fsdp=True, sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="jamba-1.5-large-398b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=256,
    norm="rmsnorm", activation="swiglu", rope_style="none",
    attn_every=2,
    moe=MoEConfig(n_experts=4, top_k=2, moe_every=2),
    mamba=MambaConfig(d_state=4, d_conv=2, expand=2),
    compute_dtype="float32", sub_quadratic=True,
)
