"""llama3.2-1b [dense] — 16L d=2048 32H (GQA kv=8) ff=8192 V=128256.

head_dim = 64 (32 heads x 64 = 2048); RMSNorm + SwiGLU + RoPE.
[hf:meta-llama/Llama-3.2-1B; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128256,
    norm="rmsnorm", activation="swiglu", rope_style="full",
    rope_theta=500_000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=512,
    norm="rmsnorm", activation="swiglu", rope_style="full",
    rope_theta=500_000.0, tie_embeddings=True, compute_dtype="float32",
)
