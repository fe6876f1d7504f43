"""Elastic-restart demo — plan-preserving serving recovery, on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples_torch/elastic_restart.py [--device cpu]

A two-tenant SLO deployment serves a few waves on the device, snapshots
its full state (params, plan cache, arbiter grants, SLO specs), then the
worker "dies" (every in-memory planner memo is wiped — what a real
process death destroys).  Recovery rebuilds the server from the
checkpoint and serves the next wave; the demo's claim, asserted at the
end, is that the restarted deployment re-plans **zero** graphs cold:
the plan-cache import plus bit-identical grant restore means every
post-crash batch hits the imported cache instead of paying the restart
storm.
"""
import argparse
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

from repro_torch.core.plan import STATS, plan_cache_stats  # noqa: E402
from repro_torch.core.resources import ResourceBudget  # noqa: E402
from repro_torch.models.frontends import (init_cnn_frontend,  # noqa: E402
                                          resolve_device)
from repro_torch.runtime import (AdaptiveServer, SLOScheduler,  # noqa: E402
                                 SLOSpec, recover_server,
                                 simulate_worker_death, snapshot_server)


def deployment(dev):
    srv = AdaptiveServer(ResourceBudget(vpu_ops_budget=15_000_000),
                         policy="demand", max_batch=4, slo_pressure=2.0,
                         device=dev)
    sched = SLOScheduler(srv)
    sched.register(
        "vision-heavy",
        init_cnn_frontend(0, channels=(8, 16), d_model=32, device=dev),
        (32, 32, 8), slo=SLOSpec(deadline_s=5.0, priority=0))
    sched.register(
        "edge-light",
        init_cnn_frontend(1, channels=(6, 12), d_model=16, device=dev),
        (24, 24, 6), activation="tanh", ladder=(16, 8),
        slo=SLOSpec(deadline_s=1.0, priority=1))
    return srv, sched


def wave(sched, rng):
    for _ in range(8):
        sched.submit("vision-heavy",
                     rng.normal(size=(32, 32, 8)).astype(np.float32))
    for _ in range(4):
        sched.submit("edge-light",
                     rng.normal(size=(24, 24, 6)).astype(np.float32))
    return sched.run()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (their plain "
                         "versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    ckpt = tempfile.mkdtemp(prefix="elastic_restart_")
    try:
        print(f"=== phase 1: serve (on {dev}) ===")
        srv, sched = deployment(dev)
        rng = np.random.default_rng(0)
        # two identical waves settle the demand EWMA at the mix's fixed
        # point — the post-crash wave then re-arbitrates to the SAME
        # grants, keeping every slice-budget cache key identical
        for i in (1, 2):
            comps = wave(sched, rng)
            print(f"wave {i}: served {len(comps)} requests; grants: "
                  + ", ".join(f"{n}={t.granted:.3f}"
                              for n, t in srv.tenants.items()))
        cache = plan_cache_stats()
        print(f"plan cache: {cache['size']} plans, "
              f"hit rate {cache['hit_rate']:.2f}")

        print("\n=== phase 2: snapshot, then the worker dies ===")
        snapshot_server(srv, ckpt, step=1, scheduler=sched)
        print(f"snapshot committed to {ckpt}")
        simulate_worker_death()
        print(f"worker died: plan cache now holds "
              f"{plan_cache_stats()['size']} plans")

        print("\n=== phase 3: recover and serve on ===")
        misses_before = STATS.plan_misses
        srv2, sched2 = recover_server(ckpt, device=dev)
        print("restored: tenants="
              + ", ".join(f"{n} (grant {t.granted:.3f})"
                          for n, t in srv2.tenants.items())
              + "; SLOs="
              + str({n: s.deadline_s for n, s in sched2.slos.items()}))
        comps = wave(sched2, np.random.default_rng(0))
        cold = STATS.plan_misses - misses_before
        print(f"post-crash wave: served {len(comps)} requests, "
              f"{cold} cold plans")
        assert len(comps) == 12
        assert cold == 0, "recovery must re-plan nothing cold"
        print("\nplan-preserving restart ✓ (zero cold plans)")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
