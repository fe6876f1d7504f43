"""Batched serving: prefill + decode with continuous batching
(``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --smoke --requests 12 --max-new 16 --device cpu

A minimal but real serving loop: a request queue feeds fixed-slot
batches; prefill fills a slot's caches (KV padded to max_len so decode
appends in place), decode advances all live slots one token per tick at
one uniform position, finished slots are immediately refilled from the
queue (continuous batching).  Greedy sampling; per-slot position
bookkeeping.  ``serve_requests`` is the loop for a given config and
params, for every token-in architecture (dense, MoE, hybrid, rwkv);
``serve(argv)`` is the command-line front end, whose params come from a
``torch.Generator`` seeded with ``--seed`` and whose prompts come from
``np.random.default_rng(seed)`` as in the reference.  Dead slots decode
too (and, under MoE, compete for expert capacity), as in the reference;
the command line refuses an ``embed_inputs`` architecture, as the
reference's does.

The batched caches are owned by the loop: a slot's prefill cache is
written into its row in place.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models.frontends import resolve_device
from repro_torch.models.transformer import tree_map


class Request:
    def __init__(self, rid: int, prompt: np.ndarray, max_new: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.generated: List[int] = []
        self.done = False


def make_requests(cfg: ModelConfig, n: int, prompt_len: int, max_new: int,
                  rng: np.random.Generator) -> List[Request]:
    """``n`` requests with prompts drawn from ``rng`` in the reference's
    order: token ids in [1, vocab)."""
    return [Request(i, rng.integers(1, cfg.vocab_size, (prompt_len,),
                                    dtype=np.int64), max_new)
            for i in range(n)]


def write_slot(caches, slot_cache, slot: int):
    """Write a 1-row prefill cache into row ``slot`` of the batched
    caches (in place): a leaf whose rank differs is left as it is, and a
    shorter time axis (dim 2) is zero-padded, as the reference's rule."""
    def upd(c, s):
        if c.dim() != s.dim():
            return c
        if s.dim() >= 3 and s.shape[2] != c.shape[2]:
            s = torch.nn.functional.pad(
                s, (0, 0) * (s.dim() - 3) + (0, c.shape[2] - s.shape[2]))
        c[:, slot:slot + 1] = s.to(c.dtype)
        return c
    return tree_map(upd, caches, slot_cache)


def serve_requests(cfg: ModelConfig, params, requests: List[Request], *,
                   slots: int, max_len: int, device=None):
    """Serve ``requests`` (consumed in order) through ``slots`` batch
    slots with caches of ``max_len`` positions on ``device`` (``None`` =
    ``cuda``; ``params`` must lie there).  Returns (completed requests,
    stats): the wall seconds, decode ticks and tokens."""
    dev = resolve_device(device)
    B, L = slots, max_len
    queue = list(requests)
    caches = api.init_decode_caches(cfg, B, L, device=dev)
    live: List[Optional[Request]] = [None] * B
    pos = np.zeros(B, dtype=np.int64)
    cur_tok = np.zeros(B, dtype=np.int64)
    completed: List[Request] = []
    t0 = time.time()
    n_decode_ticks = 0

    def admit(caches):
        for s in range(B):
            if live[s] is None and queue:
                req = queue.pop(0)
                batch = {"tokens": torch.as_tensor(req.prompt[None, :],
                                                   device=dev)}
                logits, c1, plen = api.prefill_step(cfg, params, batch,
                                                    pad_to=L)
                caches = write_slot(caches, c1, s)
                live[s] = req
                pos[s] = plen
                cur_tok[s] = int(torch.argmax(logits[0]))
                req.generated.append(int(cur_tok[s]))
        return caches

    caches = admit(caches)
    while any(s is not None for s in live) or queue:
        # one decode tick for all live slots (dead slots decode garbage
        # into their own rows — isolated and overwritten on admit)
        tick_pos = int(max(pos))  # uniform pos: caches padded to max_len
        tokens = torch.as_tensor(cur_tok[:, None], device=dev)
        logits, caches = api.decode_step(cfg, params, caches, tokens,
                                         tick_pos)
        n_decode_ticks += 1
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for s in range(B):
            req = live[s]
            if req is None:
                continue
            pos[s] += 1
            cur_tok[s] = nxt[s]
            req.generated.append(int(nxt[s]))
            if len(req.generated) >= req.max_new or pos[s] >= L - 1:
                req.done = True
                completed.append(req)
                live[s] = None
        caches = admit(caches)

    wall = time.time() - t0
    toks = sum(len(r.generated) for r in completed)
    return completed, {"wall_s": wall, "decode_ticks": n_decode_ticks,
                       "tokens": toks}


def serve(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.embed_inputs:
        raise SystemExit("serve.py drives token-in archs; use examples for "
                         "stub-frontend archs")
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    params = api.init_params(cfg, args.seed, device=dev)
    requests = make_requests(cfg, args.requests, args.prompt_len,
                             args.max_new, rng)
    completed, stats = serve_requests(cfg, params, requests,
                                      slots=args.slots,
                                      max_len=args.max_len, device=dev)
    dt, toks = stats["wall_s"], stats["tokens"]
    print(f"[serve] {len(completed)} requests, {toks} tokens, "
          f"{stats['decode_ticks']} decode ticks, {dt:.2f}s "
          f"({toks/dt:.1f} tok/s)", flush=True)
    for r in completed[:3]:
        print(f"  req {r.rid}: {r.generated[:8]}...", flush=True)
    return completed


if __name__ == "__main__":
    serve()
