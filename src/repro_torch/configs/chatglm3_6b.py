"""chatglm3-6b [dense] — 28L d=4096 32H (GQA kv=2) ff=13696 V=65024.

2D-RoPE (applied to half the head dims), GQA kv=2, RMSNorm + SwiGLU.
[arXiv:2406.12793; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=65024,
    norm="rmsnorm", activation="swiglu", rope_style="half",
)

SMOKE = ModelConfig(
    name="chatglm3-6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=192, vocab_size=256,
    norm="rmsnorm", activation="swiglu", rope_style="half",
    compute_dtype="float32",
)
