"""Observability demo — watch every layer of the stack decide, on the
PyTorch/CUDA port.

Four views onto one small CNN serving stack, narrated end to end:

1. AUDIT   — plan the network under an ample and then a constrained
   budget; ``NetworkPlan.explain()`` names the concrete clause that
   rejected every candidate the selector passed over plus plan-level
   events (fusion decisions, partition repairs, shard refusals).
2. TRACE   — enable the span tracer, run a multi-tenant serving cycle on
   the device, and export Chrome trace-event JSON (open it at
   ui.perfetto.dev): plan/replan spans, kernel launches, arbiter
   splits, batch queue waits.  Disabled, the tracer costs the hot loop
   nothing.
3. METRICS — render the server's state as Prometheus-style text:
   per-tenant request counts, latency quantiles, shard degree,
   comm-cycles share, plan-cache size.
4. DRIFT   — fit a calibration table, then compare an honest and an
   8x mis-scaled copy against fresh measurements: the drift monitor
   stays quiet on the first, trips on the second, and
   ``recalibrate()`` refits it quiet again.

    PYTHONPATH=src python examples_torch/observability_demo.py [--device cpu]
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

from repro_torch.core.calibrate_cost import (collect_plan_samples,  # noqa: E402
                                             measure_planned_site,
                                             member_key)
from repro_torch.core.plan import clear_plan_cache, plan_network  # noqa: E402
from repro_torch.core.resources import ResourceBudget  # noqa: E402
from repro_torch.models.blocks import cnn_block_site_specs  # noqa: E402
from repro_torch.models.frontends import resolve_device  # noqa: E402
from repro_torch.obs import (EVENTS, TRACER, DriftMonitor,  # noqa: E402
                             mis_scaled_table)

LAYERS = [(8, 16), (16, 32), (32, 32)]
REPEAT = 7


def network_specs():
    specs, shape = [], (2, 32, 32, LAYERS[0][0])
    for li, (cin, cout) in enumerate(LAYERS):
        layer, out = cnn_block_site_specs(
            shape, (3, 3, cin, cout), x_dtype="float32", pool_mode="max",
            activation="relu", site=f"layer{li}", ladder=(16, 8))
        specs += layer
        shape = out[0]
    return tuple(specs)


def serving_cycle(dev):
    """One small two-tenant serving trace on ``dev``; returns the
    server."""
    from repro_torch.models.frontends import init_cnn_frontend
    from repro_torch.runtime import AdaptiveServer

    clear_plan_cache()
    budget = ResourceBudget(vpu_ops_budget=60_000_000,
                            vmem_bytes=12 * 1024 * 1024)
    heavy = init_cnn_frontend(0, channels=(8, 16), d_model=32, device=dev)
    light = init_cnn_frontend(1, channels=(6, 12), d_model=16, device=dev)
    srv = AdaptiveServer(budget, policy="demand", max_batch=4, device=dev)
    srv.register("vision-heavy", heavy, (32, 32, 8))
    srv.register("edge-light", light, (24, 24, 6), activation="tanh",
                 ladder=(16, 8))
    rng = np.random.default_rng(0)
    # demand flips between waves so the arbiter actually re-balances
    # (and logs an ``arbiter.rebalance`` event) mid-trace
    for n_heavy, n_light in ((4, 1), (1, 4)):
        for _ in range(n_heavy):
            srv.submit("vision-heavy",
                       rng.normal(size=(32, 32, 8)).astype(np.float32))
        for _ in range(n_light):
            srv.submit("edge-light",
                       rng.normal(size=(24, 24, 6)).astype(np.float32))
        srv.step()
    return srv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (their plain "
                         "versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    specs = network_specs()

    print("== 1. AUDIT: why did the plan choose what it chose? ==")
    clear_plan_cache()
    ample = plan_network(specs, ResourceBudget())
    tight = plan_network(specs, ResourceBudget(vpu_ops_budget=2_000_000))
    moved = [s.spec.name for s in tight.sites
             if (s.ip.name, s.precision_bits) != next(
                 ((a.ip.name, a.precision_bits) for a in ample.sites
                  if a.spec.name == s.spec.name), None)]
    print(f"  ample plan: {len(ample.sites)} sites; the VPU-starved "
          f"budget moved {len(moved)} site choices")
    print("  --- tight.explain() ---")
    print("\n".join("  " + line
                    for line in tight.explain().splitlines()))

    print(f"\n== 2. TRACE: a serving cycle under the span tracer "
          f"(on {dev}) ==")
    serving_cycle(dev)                   # warm caches untraced
    EVENTS.clear()
    TRACER.clear()
    TRACER.enable()
    try:
        srv = serving_cycle(dev)
        metrics_text = srv.metrics().render()
    finally:
        TRACER.disable()
    doc = json.loads(TRACER.export_chrome_trace())
    cats = sorted({e["cat"] for e in doc["traceEvents"]})
    out = ROOT / "experiments" / "obs_torch"
    out.mkdir(parents=True, exist_ok=True)
    (out / "demo_trace.json").write_text(
        TRACER.export_chrome_trace(indent=None))
    print(f"  {len(doc['traceEvents'])} events over categories "
          f"{'|'.join(cats)}")
    print(f"  -> {out / 'demo_trace.json'} (load at ui.perfetto.dev)")
    assert doc["traceEvents"] and "plan" in cats
    print("  event log (always on, even with the tracer off):")
    for ev in EVENTS.recent(4):
        print(f"    {ev['kind']}: "
              + ", ".join(f"{k}={v}" for k, v in sorted(ev.items())
                          if k not in ("kind", "t")))

    print("\n== 3. METRICS: Prometheus-style exposition ==")
    wanted = ("repro_tenant_requests", "repro_tenant_shard_degree",
              "repro_plan_cache_size", "quantile=\"0.5\"")
    shown = [line for line in metrics_text.splitlines()
             if any(w in line for w in wanted)]
    for line in shown:
        print(f"  {line}")
    assert any("repro_tenant_requests" in line for line in shown)

    print("\n== 4. DRIFT: honest table quiet, mis-scaled table loud ==")
    clear_plan_cache()
    plan = plan_network(specs, ResourceBudget())
    for site in plan.sites:          # discard a warm pass per site so the
        measure_planned_site(site, repeat=1, device=dev)  # fit sees warm
    # medians of REPEAT calls: a host clock around single small calls is
    # noisy enough to trip an honest table now and then
    table = collect_plan_samples([plan], repeat=REPEAT, device=dev).fit()
    honest = DriftMonitor(table, threshold=2.0, min_observations=3)
    lying = DriftMonitor(mis_scaled_table(table, 8.0), threshold=2.0,
                         min_observations=3)
    for site in plan.sites:
        member = member_key(site.ip.name, site.precision_bits,
                            site.spec.native_bits)
        us = measure_planned_site(site, repeat=REPEAT, device=dev)
        honest.observe(member, site.footprint, us)
        lying.observe(member, site.footprint, us)
    print(f"  honest table:    drifted={honest.drifted} "
          f"(mean rel err {honest.mean_rel_error:.2f})")
    print(f"  8x mis-scaled:   drifted={lying.drifted} "
          f"(mean rel err {lying.mean_rel_error:.2f})")
    assert not honest.drifted and lying.drifted
    lying.recalibrate()
    for site in plan.sites:
        member = member_key(site.ip.name, site.precision_bits,
                            site.spec.native_bits)
        lying.observe(member, site.footprint,
                      measure_planned_site(site, repeat=REPEAT,
                                           device=dev))
    print(f"  after recalibrate(): drifted={lying.drifted} "
          f"(mean rel err {lying.mean_rel_error:.2f})")
    assert not lying.drifted
    print("  -> the stale cost model was caught from serving-shaped "
          "samples\n     and refit without replanning by hand")


if __name__ == "__main__":
    main()
