"""Step analysis: collective bytes, the op histogram and roofline terms
(``repro/launch/analysis.py``).

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
parses collectives out of the compiled HLO text.  The port has no HLO:
``launch/dryrun.py`` traces one step of the port as it runs, and the
functions here summarize what its counters recorded.

* ``collective_bytes(events)`` sums the *operand* bytes of each
  collective kind from ``distributed.collectives.CollectiveEvent``s,
  under the reference's convention: an all-gather's operand is its
  result / group, a reduce-scatter's its result x group, the others'
  equal to the result.
* ``op_histogram(aten_counts)`` buckets the traced aten ops under the
  reference's six ``hlo_op_histogram`` names.  ``fusion`` and ``while``
  stay 0: eager PyTorch neither fuses ops nor keeps loops in a graph
  (the model's loops run in Python, each op dispatched on its own).

The formulas (``model_flops``, ``ideal_traffic``, ``deployed_traffic``,
``Roofline``) are the reference's, term for term.  The hardware
constants are the NVIDIA H100 SXM's, from its data sheet (dense, without
sparsity): 989e12 bf16 tensor-core FLOP/s, 3.35e12 bytes/s of HBM3, and
NVLink 4 at 18 links of 25e9 bytes/s each way (450 GB/s) to the other
cards of a host.  They are ``Roofline`` fields, so the reference's TPU
v5e numbers can be passed in to check the formulas.  The production
meshes put 256 or 512 cards on a 16-wide model axis, which crosses
hosts of 8 cards, where the link is the network's and not NVLink:
``t_collective`` is a lower bound there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping

import torch

# NVIDIA H100 SXM data sheet, dense rates (the card's full 700 W limit)
H100_PEAK_BF16_FLOPS = 989e12
H100_HBM_BW = 3.35e12
H100_NVLINK_BW_PER_LINK = 25e9      # bytes/s each way
H100_NVLINK_LINKS = 18
H100_HBM_BYTES = 80 * 2**30         # what PyTorch sees of the 80 GB card

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
HISTOGRAM_OPS = ("transpose", "reshape", "copy", "convert", "fusion",
                 "while")

# aten ops under the reference's histogram names (``_to_copy`` is a
# "convert" where it changes the dtype, else a "copy")
_TRANSPOSE = ("transpose", "permute", "t")
_RESHAPE = ("view", "_unsafe_view", "reshape", "_reshape_alias")
_COPY = ("copy_", "clone", "_to_copy", "contiguous")


def collective_bytes(events: Iterable) -> Dict[str, float]:
    """Operand bytes per collective kind of ``events`` (each with
    ``kind``, ``result_bytes`` and ``group``), plus ``total`` and
    ``counts``: the reference's dict from recorded moves."""
    out: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
    counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    for ev in events:
        if ev.kind not in out:
            raise ValueError(f"unknown collective kind {ev.kind!r}; have "
                             f"{COLLECTIVES}")
        nbytes = float(ev.result_bytes)
        g = max(ev.group, 1)
        if ev.kind == "all-gather":
            nbytes = nbytes / g
        elif ev.kind == "reduce-scatter":
            nbytes = nbytes * g
        out[ev.kind] += nbytes
        counts[ev.kind] += 1
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["counts"] = counts  # type: ignore[assignment]
    return out


def histogram_name(op_name: str, dtype_changed: bool = False):
    """The reference histogram bucket of an aten op (``aten.<name>``,
    overload dropped), or None."""
    if op_name == "_to_copy" and dtype_changed:
        return "convert"
    if op_name in _TRANSPOSE:
        return "transpose"
    if op_name in _RESHAPE:
        return "reshape"
    if op_name in _COPY:
        return "copy"
    return None


def op_histogram(buckets: Mapping[str, int],
                 ops=HISTOGRAM_OPS) -> Dict[str, int]:
    """The counterpart of ``hlo_op_histogram``: the traced ops counted
    under the reference's names (``buckets`` as a counter fills it by
    ``histogram_name``); ``fusion`` and ``while`` are 0 in eager
    PyTorch."""
    return {op: int(buckets.get(op, 0)) for op in ops}


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    flops: float                # counted FLOPs (all devices)
    hbm_bytes: float            # counted bytes accessed (all devices)
    coll_bytes: float           # counted collective operand bytes (all)
    chips: int
    model_flops: float = 0.0    # 6·N_active·D analytic useful FLOPs
    min_hbm_bytes: float = 0.0  # analytic minimum traffic (all devices)
    min_coll_bytes: float = 0.0
    peak_flops: float = H100_PEAK_BF16_FLOPS
    hbm_bw: float = H100_HBM_BW
    link_bw: float = H100_NVLINK_BW_PER_LINK
    links: int = H100_NVLINK_LINKS

    def _t(self, flops, hbm, coll):
        return {"compute": flops / (self.chips * self.peak_flops),
                "memory": hbm / (self.chips * self.hbm_bw),
                "collective": coll / (self.chips * self.link_bw
                                      * self.links)}

    @property
    def t_compute(self):
        return self._t(self.flops, self.hbm_bytes, self.coll_bytes)["compute"]

    @property
    def t_memory(self):
        return self._t(self.flops, self.hbm_bytes, self.coll_bytes)["memory"]

    @property
    def t_collective(self):
        return self._t(self.flops, self.hbm_bytes,
                       self.coll_bytes)["collective"]

    @property
    def dominant(self) -> str:
        t = self._t(self.flops, self.hbm_bytes, self.coll_bytes)
        return max(t, key=t.get)

    @property
    def bound_time(self) -> float:
        return max(self._t(self.flops, self.hbm_bytes,
                           self.coll_bytes).values())

    @property
    def ideal_time(self) -> float:
        """Bound time of an ideal implementation: useful FLOPs, minimum
        HBM traffic, minimum collective traffic."""
        return max(self._t(self.model_flops, self.min_hbm_bytes,
                           self.min_coll_bytes).values())

    @property
    def roofline_fraction(self) -> float:
        """ideal bound / actual bound — 1.0 means the traced step is at
        the hardware roofline for this workload."""
        if self.bound_time == 0:
            return 0.0
        return min(self.ideal_time / self.bound_time, 1.0)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "min_hbm_bytes": self.min_hbm_bytes,
            "min_coll_bytes": self.min_coll_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "bound_time_s": self.bound_time, "ideal_time_s": self.ideal_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) for train; 2·N·D per token for
    inference (prefill: xD tokens; decode: 1 token/seq)."""
    n_active = cfg.param_count(active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    per_tok = 6 * n_active if shape.kind == "train" else 2 * n_active
    return float(per_tok) * tokens


def itemsize(dtype_str: str) -> int:
    """Bytes an element of the dtype named ``dtype_str`` (torch's
    names: "float32", "bfloat16", ...)."""
    dt = getattr(torch, dtype_str, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"{dtype_str!r} names no torch dtype")
    return dt.itemsize


def ideal_traffic(cfg, shape, dp: int, tp: int, chips: int,
                  fsdp: bool = False):
    """Analytic minimum (HBM bytes, collective bytes), summed over
    devices: the reference's formula, term for term (its documented
    approximations: params sharded over tp, plus dp under fsdp; train
    HBM is params read fwd+bwd+update, grads and moments, boundary
    activations, logits and embeds; decode reads the param shard and the
    caches spread over all devices; collectives are the DP grad ring,
    fsdp weight gathers, TP activation all-reduces and MoE
    all-to-alls)."""
    p_item = itemsize(cfg.param_dtype)
    m_item = itemsize(cfg.moment_dtype)
    c_item = itemsize(cfg.compute_dtype)
    N = cfg.param_count()
    shard = tp * (dp if fsdp else 1)
    params_store_dev = N * p_item / shard
    opt_dev = 2 * N * m_item / shard
    B, S = shape.global_batch, shape.seq_len
    B_loc = B / dp if B >= dp else B
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    tokens_loc = B_loc * (S if shape.kind != "decode" else 1)

    from repro_torch.models.transformer import block_period
    P = block_period(cfg)
    G = max(L // P, 1)

    if shape.kind == "train":
        # weights must be materialized per chip at N/tp for the big
        # activation matmuls, whether stored locally or gathered.
        params_use_dev = N * p_item / tp
        hbm_dev = (3 * params_use_dev + 2 * opt_dev + 2 * N * 4 / shard
                   + 2 * G * B_loc * S * D * c_item                # boundaries
                   + 2 * B_loc * S * V / tp * c_item               # logits
                   + 2 * B_loc * S * D * c_item)                   # embeds
        coll_dev = (2 * (N * 4 / shard) * (dp - 1) / dp            # grad sync
                    + (8 if tp > 1 else 0) * L * B_loc * S * D * c_item)
        if fsdp:
            coll_dev += 2 * params_use_dev * (dp - 1) / dp         # w gathers
        if cfg.moe:
            coll_dev += 4 * tokens_loc * D * c_item * cfg.moe.top_k \
                * (L // cfg.moe.moe_every) / L
    elif shape.kind == "prefill":
        cache_dev = L * B_loc * S * cfg.n_kv_heads * cfg.head_dim * 2 * c_item
        hbm_dev = (params_store_dev + 2 * G * B_loc * S * D * c_item
                   + cache_dev)
        coll_dev = (4 if tp > 1 else 0) * L * B_loc * S * D * c_item
        if cfg.moe:
            coll_dev += 2 * tokens_loc * D * c_item * cfg.moe.top_k \
                * (L // cfg.moe.moe_every) / L
    else:  # decode
        n_attn = sum(1 for k in cfg.attn_layout if k == "attn")
        cache_total = B * S * cfg.n_kv_heads * cfg.head_dim * 2 * c_item * n_attn
        if cfg.family == "encdec":
            cache_total *= 2  # self + cross caches
        state_total = 0.0
        if any(k == "mamba" for k in cfg.attn_layout):
            n_m = sum(1 for k in cfg.attn_layout if k == "mamba")
            state_total += n_m * B * cfg.d_inner * (cfg.mamba.d_state * 4
                                                    + c_item)
        if any(k == "rwkv" for k in cfg.attn_layout):
            hs = cfg.rwkv.head_size
            state_total += L * B * (D // hs) * hs * hs * 4
        # best case: params stay sharded (2D TP), cache spread over chips
        hbm_dev = params_store_dev + (cache_total + state_total) / chips
        coll_dev = (4 if tp > 1 else 0) * L * B_loc * 1 * D * c_item \
            + (2 * L * B_loc * D * c_item if fsdp else 0)  # dp-axis psums
    return hbm_dev * chips, coll_dev * chips


# ---------------------------------------------------------------------------
# Kernel-deployed memory model
# ---------------------------------------------------------------------------
def deployed_traffic(cfg, shape, dp: int, tp: int, chips: int,
                     fsdp: bool = False) -> float:
    """HBM bytes/step (all devices) of a deployment where attention runs
    through flash / flash-decode kernels (score chunks stay on chip:
    their device-memory traffic is q/k/v/o only) and every other major
    op's output crosses device memory exactly once (no fusion credit):
    the reference's model, term for term.  The port's eager step
    materializes its score chunks, so its traced bytes are above this."""
    c_item = itemsize(cfg.compute_dtype)
    p_item = itemsize(cfg.param_dtype)
    m_item = itemsize(cfg.moment_dtype)
    N = cfg.param_count()
    B, S = shape.global_batch, shape.seq_len
    B_loc = B / dp if B >= dp else B
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv_dim = (Hq + 2 * Hkv) * Dh / tp if Hq % tp == 0 else (Hq + 2 * Hkv) * Dh
    shard = tp * (dp if fsdp else 1)

    if shape.kind == "decode":
        S_act = 1
    else:
        S_act = S
    act = B_loc * S_act * c_item

    per_attn = act * (2 * D + 2 * qkv_dim + 2 * Hq * Dh / max(tp, 1) + 2 * D)
    ffn_f = F / tp if F % tp == 0 else F
    per_ffn = act * (2 * D + 4 * ffn_f + 2 * D)
    if cfg.moe:
        per_ffn *= cfg.moe.top_k * 1.25 / cfg.moe.moe_every + (
            1 - 1 / cfg.moe.moe_every)
    mamba_di = cfg.d_inner / tp
    per_mamba = act * (2 * D + 8 * mamba_di + 2 * D)
    per_rwkv = act * (2 * D + 12 * D + 4 * F)

    layer_bytes = 0.0
    for kind in cfg.attn_layout:
        layer_bytes += {"attn": per_attn + per_ffn,
                        "mamba": per_mamba + per_ffn,
                        "rwkv": per_rwkv}[kind]
    if cfg.enc_layers:
        layer_bytes += cfg.enc_layers * (per_attn + per_ffn) \
            + cfg.n_layers * per_attn  # cross-attn
    logits = 2 * B_loc * S_act * V / max(tp, 1) * c_item

    if shape.kind == "train":
        # fwd + remat-recompute fwd + bwd ~ 3x activation traffic;
        # params read fwd+bwd + grads + opt update
        total = (3 * layer_bytes + 2 * logits
                 + 3 * N * p_item / tp + 2 * N * 4 / shard
                 + 2 * 2 * N * m_item / shard)
    elif shape.kind == "prefill":
        cache_w = cfg.n_layers * B_loc * S * Hkv * Dh * 2 * c_item
        total = layer_bytes + logits + N * p_item / tp + cache_w
    else:
        n_attn = sum(1 for k in cfg.attn_layout if k == "attn")
        cache = (B * S * Hkv * Dh * 2 * c_item * n_attn
                 * (2 if cfg.family == "encdec" else 1)) / chips
        state = 0.0
        if any(k == "mamba" for k in cfg.attn_layout):
            n_m = sum(1 for k in cfg.attn_layout if k == "mamba")
            state += n_m * B * cfg.d_inner * (cfg.mamba.d_state * 4 + c_item) / chips
        if any(k == "rwkv" for k in cfg.attn_layout):
            hs = cfg.rwkv.head_size
            state += cfg.n_layers * B * (D // hs) * hs * hs * 4 / chips
        total = layer_bytes + logits + N * p_item / shard + cache + state
    return total * chips
