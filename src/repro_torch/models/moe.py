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

On a mesh (``distributed/tensor_parallel.py``) the experts are a
``Split`` over the model ranks, as the reference's ``param_spec`` lays
them out: by expert where the experts divide the model degree (expert
parallelism), else by each expert's hidden columns (the dense FFN's
column/row split, per expert).  The routing (logits, top-k gating,
capacity positions, the aux loss) runs once on the stream's device and
is handed to every rank, so the aux loss and the router's gradient are
counted once and a pair is dropped on every rank or on none; each rank
dispatches to its experts (or to every expert, with its hidden
columns), and the ranks' combined outputs are summed in rank order.  A
rank's work does not depend on the routing: it dispatches through its
experts' columns of the one-hot (``"einsum"``), or scatters every pair
with those of other ranks' experts masked to zeros (``"scatter"``).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
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


def _route(cfg: ModelConfig, router, x, num_groups: int):
    """The routing, replicated over the model ranks and computed once on
    the stream's device: (xg (G, N, D), idx (G, N, k), gate (G, N, k),
    with dropped pairs' gates zeroed, keep, pos_c, onehot (G, N, k, E),
    cap, aux)."""
    mc = cfg.moe
    E, K = mc.n_experts, mc.top_k
    B, S, D = x.shape
    N = B * S
    G = num_groups if N % num_groups == 0 else 1
    Ng = N // G
    cap = max(int(mc.capacity_factor * K * Ng / E), 1)
    xg = x.reshape(G, Ng, D)
    cd = cfg.dtype("compute")

    logits = torch.einsum("gnd,de->gne", xg.to(cd), router.to(cd))
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
    return xg, idx, gate, keep, pos_c, onehot, cap, aux


def _scatter_experts(cfg: ModelConfig, experts, m: int, xg, idx, gate,
                     keep, pos_c, *, cap: int):
    """``"scatter"`` dispatch to the experts that ``experts`` holds (all
    of them, or model rank ``m``'s n: [m n, (m + 1) n)), their FFN and
    the combine: (G, N, D).  A pair routed elsewhere adds zeros at a
    clamped slot and its gate is zeroed, so every rank does the same
    work whatever the routing."""
    cd = cfg.dtype("compute")
    G, _, D = xg.shape
    n = experts["w_down"].shape[0]
    gi = torch.arange(G, device=xg.device)[:, None, None]      # (G,1,1)
    if n != cfg.moe.n_experts:
        local = idx - m * n
        mine = (local >= 0) & (local < n)
        idx = torch.clamp(local, 0, n - 1)
        keep = keep & mine
        gate = gate * mine
    # a dropped pair adds zeros at slot cap - 1; kept pairs own their
    # slots, so the accumulation order changes no sum
    contrib = (xg[:, :, None, :] * keep[..., None]).to(cd)
    expert_in = torch.zeros((G, n, cap, D), dtype=cd, device=xg.device)
    expert_in.index_put_((gi, idx, pos_c), contrib, accumulate=True)
    expert_out = _expert_ffn(cfg, experts, expert_in)           # (G,n,C,D)
    back = expert_out[gi, idx, pos_c]                           # (G,N,k,D)
    return torch.einsum("gnkd,gnk->gnd", back, gate.to(cd))


def _einsum_experts(cfg: ModelConfig, experts, m: int, xg, onehot,
                    pos_oh, gate):
    """``"einsum"`` dispatch to the experts that ``experts`` holds (all
    of them, or model rank ``m``'s n): their columns of the one-hot,
    their FFN and the combine: (G, N, D)."""
    cd = cfg.dtype("compute")
    n = experts["w_down"].shape[0]
    if n != cfg.moe.n_experts:
        onehot = onehot[..., m * n:(m + 1) * n]
    oh = onehot.to(cd)
    disp = torch.einsum("gnke,gnkc->gnec", oh, pos_oh)
    expert_in = torch.einsum("gnec,gnd->gecd", disp, xg.to(cd))
    expert_out = _expert_ffn(cfg, experts, expert_in)           # (G,n,C,D)
    comb = torch.einsum("gnke,gnkc,gnk->gnec", oh, pos_oh, gate.to(cd))
    return torch.einsum("gnec,gecd->gnd", comb, expert_out)


def apply_moe(cfg: ModelConfig, p, x, *, num_groups: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).

    Capacity is computed per group; a (token, slot) pair past its
    expert's capacity is dropped (its gate zeroed).  Positions within an
    expert count token-major, slot-minor over the group, as the
    reference's cumsum does.

    ``p["experts"]`` a ``tensor_parallel.Split``: the routing runs once
    on the stream's device and is handed to every model rank (the
    column-parallel input); each rank dispatches to the experts it holds
    (expert parallelism: ``E / tp`` of them) or to every expert with its
    ``F / tp`` hidden columns (the expert-hidden split), and the ranks'
    combined outputs are summed in rank order."""
    B, S, D = x.shape
    cd = cfg.dtype("compute")
    xg, idx, gate, keep, pos_c, onehot, cap, aux = _route(
        cfg, p["router"], x, num_groups)
    experts = p["experts"]
    if cfg.moe_dispatch == "scatter":
        body = functools.partial(_scatter_experts, cfg, cap=cap)
        args = (xg, idx, gate, keep, pos_c)
    else:
        # jax.nn.one_hot gives zeros past `cap`: one-hot the clamped
        # position and mask the dropped pairs
        pos_oh = _one_hot(pos_c, cap, cd) * keep[..., None]      # (G,N,k,C)
        body = functools.partial(_einsum_experts, cfg)
        args = (xg, onehot, pos_oh, gate)
    if isinstance(experts, tp.Split):
        out = tp.reduce(experts.group, [o[0] for o in tp.run(
            experts.group, experts.parts,
            lambda m, part, *a: body(part, m, *a), *args)])
    else:
        out = body(experts, 0, *args)
    return out.reshape(B, S, D).to(x.dtype), aux.to(torch.float32)
