"""GShard-style top-k MoE with capacity-factor dispatch
(``repro/models/moe.py``).

Tokens are grouped, each group computes its own expert capacity, and
two dispatch/combine contractions bracket the expert FFN.  Plain
PyTorch, as the reference is plain jnp: no kernel of the reference's
reaches this module.  Two dispatch modes, as ``cfg.moe_dispatch``:

  * ``"einsum"``  — GShard dense one-hot contractions (the default);
  * ``"scatter"`` — indexed scatter-add into (expert, slot) and a gather
                    back: no E*C one-hot traffic.

The aux load-balancing loss is GShard/Switch's.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import gelu, init_ffn, normal


def init_moe(cfg: ModelConfig, gen: torch.Generator, shape_prefix=(),
             device="cpu"):
    assert cfg.moe is not None
    E = cfg.moe.n_experts
    pre = tuple(shape_prefix)
    router = normal(gen, pre + (cfg.d_model, E), cfg.d_model ** -0.5,
                    cfg.dtype("param"), device)
    experts = init_ffn(cfg, gen, shape_prefix=pre + (E,), device=device)
    return {"router": router, "experts": experts}


def _expert_ffn(cfg: ModelConfig, p, x):
    """x: (G, E, C, D); expert-stacked weights (E, D, F)."""
    cd = cfg.dtype("compute")
    x = x.to(cd)
    if cfg.activation in ("swiglu", "geglu"):
        g = torch.einsum("gecd,edf->gecf", x, p["w_gate"].to(cd))
        u = torch.einsum("gecd,edf->gecf", x, p["w_up"].to(cd))
        act = F.silu if cfg.activation == "swiglu" else gelu
        h = act(g) * u
    else:
        h = torch.einsum("gecd,edf->gecf", x, p["w_in"].to(cd))
        h = gelu(h) if cfg.activation == "gelu" else torch.square(F.relu(h))
    return torch.einsum("gecf,efd->gecd", h, p["w_down"].to(cd))


def _one_hot(idx, n: int, dtype) -> torch.Tensor:
    """``F.one_hot(idx, n).to(dtype)`` for ``idx`` in [0, n), as one
    compare against ``arange(n)``: the same ops on every device
    (``F.one_hot`` checks its indices on the host on the CPU and scatters
    on a card), so a step counts alike on ``meta`` and on the card."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k_gating(logits, k: int):
    """Iterative top-1 x k (GShard): returns per-slot (index, prob).

    ``torch.argmax`` takes the first maximal index, as ``jnp.argmax``
    does, so tied probabilities pick the experts the reference picks
    (``torch.topk``'s tie order is unspecified)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)    # (G, N, E)
    masked = probs
    idxs, gates = [], []
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)                      # (G, N)
        gate = torch.gather(masked, -1, idx[..., None])[..., 0]
        idxs.append(idx)
        gates.append(gate)
        masked = masked * (1.0 - _one_hot(idx, probs.shape[-1],
                                          probs.dtype))
    idx = torch.stack(idxs, dim=-1)          # (G, N, k)
    gate = torch.stack(gates, dim=-1)        # (G, N, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return idx, gate, probs


def apply_moe(cfg: ModelConfig, p, x, *, num_groups: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).

    Capacity is computed per group; a (token, slot) pair past its
    expert's capacity is dropped (its gate zeroed).  Positions within an
    expert count token-major, slot-minor over the group, as the
    reference's cumsum does."""
    mc = cfg.moe
    E, K = mc.n_experts, mc.top_k
    B, S, D = x.shape
    N = B * S
    G = num_groups if N % num_groups == 0 else 1
    Ng = N // G
    cap = max(int(mc.capacity_factor * K * Ng / E), 1)
    xg = x.reshape(G, Ng, D)
    cd = cfg.dtype("compute")

    logits = torch.einsum("gnd,de->gne", xg.to(cd), p["router"].to(cd))
    idx, gate, probs = _top_k_gating(logits, K)                 # (G,N,k)

    # Aux load-balance loss (Switch): E * sum(frac_tokens * frac_prob).
    me = _one_hot(idx[..., 0], E, torch.float32).mean(dim=1)
    ce = probs.mean(dim=1)
    aux = E * (me * ce).sum(-1).mean()

    # Capacity assignment: position of each (token, slot) within its expert.
    onehot = _one_hot(idx, E, torch.float32)                    # (G,N,k,E)
    flat = onehot.reshape(G, Ng * K, E)
    pos = torch.cumsum(flat, dim=1) - flat                      # (G,N*k,E)
    pos = (pos * flat).sum(-1).reshape(G, Ng, K).to(torch.int64)
    keep = pos < cap
    gate = gate * keep
    pos_c = torch.clamp(pos, max=cap - 1)                       # (G,N,k)

    if cfg.moe_dispatch == "scatter":
        # a dropped pair adds zeros at slot cap - 1; kept pairs own their
        # slots, so the accumulation order changes no sum
        gi = torch.arange(G, device=x.device)[:, None, None]   # (G,1,1)
        contrib = (xg[:, :, None, :] * keep[..., None]).to(cd)
        expert_in = torch.zeros((G, E, cap, D), dtype=cd, device=x.device)
        expert_in.index_put_((gi, idx, pos_c), contrib, accumulate=True)
        expert_out = _expert_ffn(cfg, p["experts"], expert_in)  # (G,E,C,D)
        back = expert_out[gi, idx, pos_c]                       # (G,N,k,D)
        out = torch.einsum("gnkd,gnk->gnd", back, gate.to(cd))
    else:
        # jax.nn.one_hot gives zeros past `cap`: one-hot the clamped
        # position and mask the dropped pairs
        pos_oh = _one_hot(pos_c, cap, cd) * keep[..., None]      # (G,N,k,C)
        oh = onehot.to(cd)
        disp = torch.einsum("gnke,gnkc->gnec", oh, pos_oh)
        expert_in = torch.einsum("gnec,gnd->gecd", disp, xg.to(cd))
        expert_out = _expert_ffn(cfg, p["experts"], expert_in)  # (G,E,C,D)
        comb = torch.einsum("gnke,gnkc,gnk->gnec", oh, pos_oh, gate.to(cd))
        out = torch.einsum("gnec,gecd->gnd", comb, expert_out)
    return out.reshape(B, S, D).to(x.dtype), aux.to(torch.float32)
