"""Mesh execution under a single controller: the collectives over
per-device lists of tensors and the sharded plan executor (the
reference's ``shard_map`` paths), re-exported here; the sharding rules
and placement (``sharding``), the sharded train step (``shard_train``)
and GPipe (``pipeline``) are imported from their modules."""
from repro_torch.distributed.collectives import (all_gather, bucketed_psum,
                                                 psum, ring_all_reduce)
from repro_torch.distributed.shard_exec import (apply_plan_replicated,
                                                apply_plan_sharded,
                                                mesh_devices)

__all__ = ["all_gather", "apply_plan_replicated", "apply_plan_sharded",
           "bucketed_psum", "mesh_devices", "psum", "ring_all_reduce"]
