"""The one traffic generator: it reads a mix's parameters and a seed and
yields what the clients send.

A mix's ``loop`` key names how the clients send.  The one loop so far is
``closed``: waves of ``wave`` requests a tenant (``{"heavy": 256,
"light": 64}``), in an order drawn from the seed; the next wave is sent
when the server's round returns.

Every request names an image of its tenant's pool (``pool_per_tenant``),
drawn from the seed.  Seeds change the order and the draws, not the
amount of work a wave holds.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

LOOPS = ("closed",)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of draws for ``seed`` (streams: 0 the timed
    traffic, 1 the warm-up, 2 the sample of answers checked)."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def check_loop(params: dict) -> None:
    if params["loop"] not in LOOPS:
        raise ValueError(f"traffic loop {params['loop']!r}: the harness "
                         f"drives {LOOPS}")


def waves(params: dict, rng: np.random.Generator
          ) -> Iterator[List[Tuple[str, int]]]:
    """Endless closed-loop waves: (tenant, image) pairs, shuffled."""
    names = [n for n, k in params["wave"].items() for _ in range(k)]
    pool = params["pool_per_tenant"]
    while True:
        order = rng.permutation(len(names))
        images = rng.integers(0, pool, len(names))
        yield [(names[i], int(j)) for i, j in zip(order, images)]
