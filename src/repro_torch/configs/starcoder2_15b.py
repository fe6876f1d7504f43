"""starcoder2-15b [dense] — 40L d=6144 48H (GQA kv=4) ff=24576 V=49152.

GQA + RoPE; LayerNorm + GeLU (starcoder2 uses standard LN/MLP).
[arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152,
    norm="layernorm", activation="gelu", rope_style="full",
)

SMOKE = ModelConfig(
    name="starcoder2-15b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=256, vocab_size=256,
    norm="layernorm", activation="gelu", rope_style="full",
    compute_dtype="float32",
)
