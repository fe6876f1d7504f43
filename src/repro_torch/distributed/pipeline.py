"""GPipe-style pipeline parallelism under a single controller
(``repro/distributed/pipeline.py``).

Each rank along the ``pipe`` mesh axis owns one stage's params on its
device; microbatches stream through the ranks, handed to the next rank
with ``Tensor.to(device)`` (no copy where two logical devices share one
card).  Fill+drain schedule: ``n_micro + n_stages - 1`` ticks, in which
rank ``r`` computes microbatch ``t - r`` at tick ``t``.  The reference
computes every rank at every tick and masks the stale ticks (outside
``[r, r + n_micro)``) to zeros before the handoff and the outputs; here
those ticks are skipped, so whatever ``stage_fn`` makes of a zero
buffer (``f(0) != 0``) never reaches either.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.sharding import tree_map


def gpipe_forward(stage_fn: Callable, mesh, *, axis: str = "pipe"):
    """Build a pipelined forward over one mesh axis.

    stage_fn(stage_params, x) -> y, applied by every rank to the
    microbatch currently resident on it.

    Returns pipelined(stage_params_stacked, x_micro) where
      stage_params_stacked: tree (dicts, lists, tuples) of tensors with
        leading dim n_stages; rank r holds slice r on its device,
      x_micro: (n_micro, micro_batch, ...) input microbatches,
    and the result is (n_micro, micro_batch, ...) outputs of the LAST
    stage, in order, on ``x_micro``'s device.
    """
    at = tuple(slice(None) if a == axis else 0 for a in mesh.axis_names)
    devs = list(mesh.devices[at].reshape(-1))
    n_stages = len(devs)

    def pipelined(stage_params, x_micro):
        params = [tree_map(lambda t, r=r: t[r].to(dev), stage_params)
                  for r, dev in enumerate(devs)]
        n_micro = x_micro.shape[0]
        outs = [None] * n_micro
        buf = [None] * n_stages
        for t in range(n_micro + n_stages - 1):
            nxt = [None] * n_stages
            for r in range(max(0, t - n_micro + 1), min(t, n_stages - 1) + 1):
                # rank r's tick-t work is microbatch t - r (fill+drain)
                x = x_micro[t].to(devs[0]) if r == 0 else buf[r]
                y = stage_fn(params[r], x)
                if r == n_stages - 1:
                    outs[t - r] = y
                else:
                    nxt[r + 1] = y.to(devs[r + 1])
            buf = nxt
        return torch.stack([o.to(x_micro.device) for o in outs])

    return pipelined
