"""Config system: one dataclass family covering all assigned architectures.

Every architecture file in this package exports:
  CONFIG       — the exact published configuration (full scale)
  SMOKE        — a reduced same-family configuration for CPU smoke tests
Registry access: ``repro_torch.configs.get_config(name, smoke=False)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    moe_every: int = 1          # 1 = every FFN is MoE; 2 = alternate (jamba)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0            # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    lora_rank_decay: int = 64
    lora_rank_mix: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- variants ---
    norm: str = "rmsnorm"       # rmsnorm | layernorm | layernorm_nonparam
    activation: str = "swiglu"  # swiglu | gelu | relu_sq
    rope_style: str = "full"    # full | half (chatglm 2d) | none
    rope_theta: float = 10_000.0
    pos_embed: str = "none"     # none | sinusoidal (used when rope_style=none)
    tie_embeddings: bool = False
    # hybrid (jamba): one attention layer every `attn_every` layers; others mamba
    attn_every: int = 0         # 0 = all attention (or all-ssm if family=="ssm")
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # encdec
    enc_layers: int = 0         # >0 -> encoder-decoder; n_layers = decoder layers
    # modality frontend stub: inputs are precomputed embeddings, not token ids
    embed_inputs: bool = False
    # --- numerics / memory policy ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    logit_dtype: str = "bfloat16"   # dtype logits are materialized in
    # dtype attention score chunks are *materialized* in (softmax stats
    # stay f32); bfloat16 halves the dominant S^2 HBM term — §Perf knob
    attn_score_dtype: str = "float32"
    # skip fully-masked causal kv chunks (graph twin of the Pallas
    # kernel's pl.when block skip; exact) — §Perf knob
    causal_skip: bool = False
    # MoE dispatch: "einsum" (GShard dense one-hot contractions) or
    # "scatter" (indexed scatter/gather — no E*C one-hot traffic) — §Perf
    moe_dispatch: str = "einsum"
    remat: str = "block"        # none | block | block_dots (save matmul outs)
    scan_layers: bool = True
    # --- distribution policy ---
    fsdp: bool = False          # ZeRO-3-style param sharding over dp axes
    # --- technique: resource-driven IP selection policy (paper core) ---
    ip_budget: str = "default"  # default | mxu_scarce | vmem_tight | int8
    sub_quadratic: bool = False # True for ssm/hybrid: long_500k is runnable

    # ------------------------------------------------------------------
    @property
    def group_size(self) -> int:
        """GQA group."""
        return self.n_heads // self.n_kv_heads if self.n_kv_heads else 0

    @property
    def attn_layout(self) -> Tuple[str, ...]:
        """Per-layer block kind: 'attn' | 'mamba' | 'rwkv'."""
        if self.family == "ssm":
            return tuple("rwkv" for _ in range(self.n_layers))
        if self.attn_every > 1:
            return tuple("attn" if i % self.attn_every == 0 else "mamba"
                         for i in range(self.n_layers))
        return tuple("attn" for _ in range(self.n_layers))

    @property
    def d_inner(self) -> int:
        mc = self.mamba or MambaConfig()
        return mc.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        mc = self.mamba or MambaConfig()
        return mc.dt_rank or -(-self.d_model // 16)

    def dtype(self, which: str) -> torch.dtype:
        """The torch dtype named by ``<which>_dtype``."""
        return getattr(torch, getattr(self, which + "_dtype"))

    # ---- parameter count (for 6ND model FLOPs) --------------------------
    def param_count(self, active_only: bool = False) -> int:
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        Hq, Hkv, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        n = V * D                     # embed
        if not self.tie_embeddings:
            n += D * V                # lm head
        attn = D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D
        if self.activation in ("swiglu", "geglu"):
            dense_ffn = 3 * D * F
        else:
            dense_ffn = 2 * D * F
        mc = self.mamba or MambaConfig()
        d_in, d_st, dtr = self.d_inner, mc.d_state, self.dt_rank
        mamba = (D * 2 * d_in + mc.d_conv * d_in + d_in * (dtr + 2 * d_st)
                 + dtr * d_in + d_in * D + d_in * d_st + d_in)
        rc = self.rwkv or RWKVConfig()
        rwkv_tm = 4 * D * D + D * D + 2 * rc.lora_rank_decay * D
        rwkv_cm = int(2 * D * (F if F else 4 * D))
        for i, kind in enumerate(self.attn_layout):
            if kind == "attn":
                n += attn
            elif kind == "mamba":
                n += mamba
            else:
                n += rwkv_tm + rwkv_cm
            if kind == "rwkv":
                continue  # rwkv channel-mix already counted
            if self.moe and (i % self.moe.moe_every == 0):
                e = self.moe.top_k if active_only else self.moe.n_experts
                n += e * dense_ffn + D * self.moe.n_experts
            else:
                n += dense_ffn
        if self.enc_layers:
            enc_block = attn + dense_ffn
            cross = attn
            n += self.enc_layers * enc_block + self.n_layers * cross
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs, and why not if it doesn't."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 524k context requires "
                       "sub-quadratic attention (skip per assignment)")
    return True, ""
