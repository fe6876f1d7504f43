"""Mesh demo — one NetworkPlan spanning more than one device, on the
PyTorch/CUDA port.

The paper's library adapts an IP to the resources ONE fabric offers;
``plan_network(mesh=...)`` extends the same resource-driven story
across a device mesh, narrated here in three moves:

1. SPLIT WINS — a conv that saturates one device (the budget pins the
   MXU, forcing the slow VPU member) is batch-split across 2 devices:
   the per-device footprint halves, the planner flips to the MXU
   member, and the collective bill (priced into ``comm_cycles``) still
   leaves the split cheaper.  Execution goes through the single
   controller's sharded walk (``distributed/shard_exec.py``) and is
   bit-identical to the replicated walk.
2. REFUSAL — a tiny 1x1 conv whose collectives dwarf its compute
   plans at degree=1: the mesh is offered, and honestly declined.
3. SERVING — ``AdaptiveServer(mesh=...)`` grants tenants whole-device
   slices via the arbiter and serves sharded plans live.

The two devices are logical: ``devices=`` names one device twice (two
logical devices of one card, or of the CPU with ``--device cpu``), as
the reference forces two host devices with ``XLA_FLAGS``.

    PYTHONPATH=src python examples_torch/mesh_demo.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.ip import SiteSpec  # noqa: E402
from repro_torch.core.plan import plan_network  # noqa: E402
from repro_torch.core.resources import MeshSpec, ResourceBudget  # noqa: E402
from repro_torch.distributed.shard_exec import (  # noqa: E402
    apply_plan_replicated, apply_plan_sharded)
from repro_torch.models.frontends import (init_cnn_frontend,  # noqa: E402
                                          resolve_device)


def describe(tag, plan):
    s = plan.sites[0]
    shard = (f"{s.shard_axis}x{s.shard_degree}" if s.sharded
             else "replicated")
    print(f"  {tag:<18} {s.ip.name.split('.')[-1]:<10} {shard:<10} "
          f"est={plan.total_cycles:.3e} cyc "
          f"(comm={s.footprint.comm_cycles:.3e})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (their plain "
                         "versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    logical = [dev, dev]
    print(f"mesh devices: {[str(d) for d in logical]} (two logical "
          f"devices of one {dev.type} device)")
    mesh = MeshSpec(devices=2)
    rng = np.random.default_rng(0)

    print("\n== 1. SPLIT WINS: one device saturates, two flip the "
          "member ==")
    budget = ResourceBudget(mxu_passes_budget=7)   # the MXU is rationed
    x = torch.from_numpy(
        rng.normal(size=(8, 16, 16, 32)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(0, (9 * 32) ** -0.5,
                                    (3, 3, 32, 128)).astype(np.float32))
    w = w.to(dev)
    spec = SiteSpec.make("conv", "conv2d", (tuple(x.shape), tuple(w.shape)),
                         "float32", dual=False)
    p1 = plan_network((spec,), budget)
    p2 = plan_network((spec,), budget, mesh=mesh)
    describe("1 device", p1)
    describe("2-device mesh", p2)
    assert p2.sites[0].sharded and p2.total_cycles < p1.total_cycles
    y_rep = apply_plan_replicated(p2, x, {"conv": w})
    y_shd = apply_plan_sharded(p2, x, {"conv": w}, devices=logical)
    assert torch.equal(y_rep, y_shd)
    print("  -> batch split halves the per-device footprint, the "
          "planner buys the\n     MXU member back, and the sharded "
          "result is bit-identical")

    print("\n== 2. REFUSAL: collectives would dwarf the compute ==")
    xr_shape, wr_shape = (4, 64, 64, 4), (1, 1, 4, 128)
    rspec = SiteSpec.make("conv", "conv2d", (xr_shape, wr_shape),
                          "float32", dual=False)
    pr = plan_network((rspec,), ResourceBudget(), mesh=mesh)
    describe("2-device mesh", pr)
    assert not pr.sites[0].sharded
    print("  -> the mesh was offered and declined: an all-reduce of "
          "the 8 MiB output\n     costs ~11x the whole site's compute")

    print("\n== 3. SERVING: tenants hold whole-device slices ==")
    from repro_torch.runtime.server import AdaptiveServer
    params = init_cnn_frontend(0, channels=(3, 8, 8), d_model=16,
                               device=dev)
    srv = AdaptiveServer(ResourceBudget(), mesh=mesh, max_batch=4,
                         device=dev, devices=logical)
    srv.register("vision", params, (16, 16, 3))
    xb = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    srv.submit("vision", xb)
    done = srv.drain()
    share = srv.shares()["vision"]
    print(f"  served {len(done)} requests; tenant holds "
          f"{share.devices}/{mesh.devices} devices "
          f"(sub-mesh planned + sharded walk executed)")
    assert len(done) == 4 and all(c.ok for c in done)

    # the library's central promise, now across devices: the mesh
    # changes the implementation, never the result
    json_rt = type(p2).from_json(p2.to_json())
    assert json_rt.to_json() == p2.to_json()
    print("\nplan JSON round-trips the sharding fields bit-exactly")


if __name__ == "__main__":
    main()
