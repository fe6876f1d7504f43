"""olmo-1b [dense] — 16L d=2048 16H (MHA kv=16) ff=8192 V=50304.

Non-parametric LayerNorm (the OLMo signature), SwiGLU, full RoPE.
[arXiv:2402.00838; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=50304,
    norm="layernorm_nonparam", activation="swiglu", rope_style="full",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="olmo-1b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    norm="layernorm_nonparam", activation="swiglu", rope_style="full",
    tie_embeddings=True, compute_dtype="float32",
)
