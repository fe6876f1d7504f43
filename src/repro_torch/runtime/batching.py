"""Shape-bucketed request batching.

Inference requests land in FIFO buckets keyed by (tenant, per-sample
shape, dtype); a batch stacks up to ``max_batch`` same-bucket samples
along a new leading axis so ONE planned execution serves them all.
Bucketing by shape is what keeps the plan cache hot: every batch of the
same (tenant, shape, size) resolves to the same graph key, so repeat
batches cost zero selector work (``core/plan.py`` memoization).

For full-precision plans batching is *exact* — every family's kernels
are batch-independent — and the tests assert batched == per-request.
Quantized plans use per-tensor activation scales, so a batch shares one
scale where per-request execution would pick each its own; the error
stays within the per-site reported bound either way.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class Request:
    """One queued inference request: a single sample for one tenant."""

    rid: int
    tenant: str
    x: Any                  # (H, W, C) sample array
    arrival: float          # server clock, est-cycles units

    @property
    def bucket_key(self) -> Tuple[str, Tuple[int, ...], str]:
        return (self.tenant, tuple(self.x.shape), str(self.x.dtype))


class ShapeBucketQueue:
    """FIFO queue per (tenant, sample-shape, dtype) bucket.

    Buckets drain in creation order and requests within a bucket in
    arrival order — deterministic given the submission sequence.
    """

    def __init__(self):
        self._buckets: Dict[Tuple, Deque[Request]] = {}
        # Lifetime counters (never reset) for metrics exposition.
        self.pushes = 0
        self.pops = 0
        self.popped_requests = 0

    def push(self, req: Request) -> None:
        self.pushes += 1
        self._buckets.setdefault(req.bucket_key, deque()).append(req)

    def keys(self) -> Tuple[Tuple, ...]:
        return tuple(k for k, q in self._buckets.items() if q)

    def pop_batch(self, key: Tuple, max_batch: int) -> List[Request]:
        """Up to ``max_batch`` oldest requests of one bucket (empty list
        when the bucket is drained; drained buckets are dropped)."""
        q = self._buckets.get(key)
        if not q:
            self._buckets.pop(key, None)
            return []
        batch = [q.popleft() for _ in range(min(max_batch, len(q)))]
        if not q:
            self._buckets.pop(key, None)
        self.pops += 1
        self.popped_requests += len(batch)
        return batch

    def stats(self) -> Dict[str, int]:
        """Lifetime counters: requests pushed, batches popped, requests
        popped, plus the current depth and live bucket count."""
        return {"pushes": self.pushes, "pops": self.pops,
                "popped_requests": self.popped_requests,
                "pending": len(self),
                "buckets": len(self.keys())}

    def pending(self, tenant: str) -> int:
        return sum(len(q) for (t, _, _), q in self._buckets.items()
                   if t == tenant)

    def __len__(self) -> int:
        return sum(len(q) for q in self._buckets.values())

    def __bool__(self) -> bool:
        return len(self) > 0
