"""Deterministic, resumable, shard-aware synthetic LM data pipeline
(``repro/data/pipeline.py``).

Stateless-indexable: batch ``i`` is a pure function of (seed, i, shard)
— so restart-from-checkpoint resumes *exactly* by skipping to the saved
step, and every data shard draws disjoint token streams without any
coordination (the property the fault-tolerance layer leans on).

The generator is a counter-mode Threefry-2x32 stream over a Zipf-ish
unigram table.  The reference draws it with ``jax.random``; this module
computes the same bits in numpy (``threefry2x32``, ``prng_key``,
``fold_in``, ``random_bits`` in the partitionable counter layout and
``uniform``'s mantissa trick), so a batch is bitwise the reference's.
An optional memmap file source provides the same interface for real
token files.  Batches are CPU ``int32`` tensors; the trainer moves them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


# ---------------------------------------------------------------------------
# Threefry-2x32 (Salmon et al., 2011), as jax.random computes it
# ---------------------------------------------------------------------------
def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return (v << np.uint32(d)) | (v >> np.uint32(32 - d))


def threefry2x32(k0, k1, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under key
    (k0, k1): 20 rounds, a key injection every 4, all mod 2^32."""
    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32(k0) ^ np.uint32(k1) ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for rot in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = x[0] ^ _rotl(x[1], rot)
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the key hashed with the counter (0,
    data mod 2^32)."""
    y0, y1 = threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.concatenate([y0, y1])


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits an element (``jax_threefry_partitionable``): each
    element hashes its row-major index, as a 64-bit counter split into
    (high, low) words, and the two outputs are xor-ed."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key[0], key[1], hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in f32 on [0, 1): the top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape) >> np.uint32(32 - 23)
    one = np.array(1.0, np.float32).view(np.uint32)
    return np.maximum(np.float32(0.0),
                      (bits | one).view(np.float32) - np.float32(1.0))


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1            # data-parallel shards
    shard_id: int = 0
    zipf_a: float = 1.2
    token_file: Optional[str] = None   # memmap .bin of int32 tokens


class SyntheticLM:
    """Indexable dataset of (tokens, labels) batches."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_shards == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_shards
        # Zipf-ish unigram distribution, fixed by seed.
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** -cfg.zipf_a
        self._probs = probs / probs.sum()
        self._perm = rng.permutation(cfg.vocab_size)
        self._mm = None
        if cfg.token_file:
            self._mm = np.memmap(cfg.token_file, dtype=np.int32, mode="r")

    def __getitem__(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if self._mm is not None:
            span = self.local_batch * (cfg.seq_len + 1)
            start = ((step * cfg.n_shards + cfg.shard_id) * span) % max(
                len(self._mm) - span, 1)
            flat = np.asarray(self._mm[start:start + span])
            toks = flat.reshape(self.local_batch, cfg.seq_len + 1)
        else:
            key = fold_in(fold_in(prng_key(cfg.seed), step), cfg.shard_id)
            u = uniform(key, (self.local_batch, cfg.seq_len + 1))
            cdf = np.cumsum(self._probs)
            toks = self._perm[np.searchsorted(cdf, u)]
            toks = np.clip(toks, 0, cfg.vocab_size - 1)
        toks = toks.astype(np.int32)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                "labels": torch.from_numpy(toks[:, 1:].copy())}

    def iter_from(self, step: int) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self[step]
            step += 1


def make_pipeline(vocab_size: int, seq_len: int, global_batch: int, *,
                  seed: int = 0, n_shards: int = 1, shard_id: int = 0,
                  token_file: Optional[str] = None) -> SyntheticLM:
    return SyntheticLM(DataConfig(vocab_size, seq_len, global_batch,
                                  seed=seed, n_shards=n_shards,
                                  shard_id=shard_id, token_file=token_file))
