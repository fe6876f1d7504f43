"""llava-next-34b [vlm] — 60L d=7168 56H (GQA kv=8) ff=20480 V=64000.

Backbone only (anyres patch tiling is the STUB frontend): input_specs()
provides precomputed patch embeddings mixed with text embeddings.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    norm="rmsnorm", activation="swiglu", rope_style="full",
    embed_inputs=True,
    param_dtype="bfloat16", moment_dtype="bfloat16",
    fsdp=True,
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=192, vocab_size=256,
    norm="rmsnorm", activation="swiglu", rope_style="full",
    embed_inputs=True, compute_dtype="float32",
)
