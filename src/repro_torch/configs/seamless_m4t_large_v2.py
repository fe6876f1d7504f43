"""seamless-m4t-large-v2 [audio] — enc-dec 24L d=1024 16H ff=8192 V=256206.

Transformer BACKBONE only: the speech frontend is a STUB — input_specs()
provides precomputed frame embeddings (B, frames, d_model).
[arXiv:2308.11596; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, enc_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206,
    norm="layernorm", activation="gelu", rope_style="none",
    pos_embed="sinusoidal", embed_inputs=True,
)

SMOKE = ModelConfig(
    name="seamless-m4t-large-v2-smoke", family="encdec",
    n_layers=2, enc_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    norm="layernorm", activation="gelu", rope_style="none",
    pos_embed="sinusoidal", embed_inputs=True, compute_dtype="float32",
)
