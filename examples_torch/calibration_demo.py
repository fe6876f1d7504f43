"""Calibration demo — teach the planner what the stopwatch knows, on the
PyTorch/CUDA port.

The planner's analytical cost model (est-cycles) can disagree with
measured wall-clock; the calibration loop closes that gap in three
moves, narrated here on a 3-layer CNN:

1. SAMPLE  — plan the network, run every distinct planned site
   standalone on the device, and record (member, footprint, measured
   us) samples.
2. FIT     — per-member affine fits over the footprint's analytical
   axes (compute cycles, HBM bytes), global fallback under 3 samples.
3. RE-PLAN — the same ``plan_network`` call with ``calibration=`` now
   ranks members and fusion groups by measured cost; a synthetic
   "fused is slow on this machine" table demonstrably flips the
   fused/unfused decision while numerics stay identical.

The table round-trips through versioned JSON bit-exactly, so a fitted
table ships with a deployment.

    PYTHONPATH=src python examples_torch/calibration_demo.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.calibrate_cost import (AffineFit,  # noqa: E402
                                             CalibrationTable,
                                             collect_plan_samples, member_key)
from repro_torch.core.plan import clear_plan_cache, plan_network  # noqa: E402
from repro_torch.core.resources import ResourceBudget  # noqa: E402
from repro_torch.models.blocks import (apply_cnn_block,  # noqa: E402
                                       cnn_block_site_specs)
from repro_torch.models.frontends import resolve_device  # noqa: E402

LAYERS = [(8, 16), (16, 32), (32, 32)]


def network_specs(ladder=()):
    specs, shape = [], (2, 32, 32, LAYERS[0][0])
    for li, (cin, cout) in enumerate(LAYERS):
        layer, out = cnn_block_site_specs(
            shape, (3, 3, cin, cout), x_dtype="float32", pool_mode="max",
            activation="relu", site=f"layer{li}", ladder=ladder)
        specs += layer
        shape = out[0]
    return tuple(specs)


def describe(tag, plan, table=None):
    fams = [s.spec.family for s in plan.sites]
    fused = fams.count("cnn_fused")
    print(f"  {tag:<22} {len(plan.sites)} sites, {fused} fused; "
          f"est={plan.total_cycles:.3e} cyc, "
          f"calibrated={plan.calibrated_cycles(table):.3e} cyc")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (their plain "
                         "versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    budget = ResourceBudget()
    specs = network_specs(ladder=(16, 8))
    clear_plan_cache()

    print(f"== 1. SAMPLE: measure every distinct site the analytical "
          f"plans chose (on {dev}) ==")
    plans = [plan_network(specs, budget, fuse=f) for f in (False, True)]
    table = collect_plan_samples(plans, repeat=3, device=dev)
    print(f"  {table.sample_count()} samples over "
          f"{len({s.member for s in table.samples})} executed members")

    print("== 2. FIT: per-member affine models over (compute, hbm) ==")
    table.fit()
    for m, f in sorted(table.fits.items()):
        print(f"  {m:<28} us = {f.us_per_compute_cycle:.3g}*cyc "
              f"+ {f.us_per_hbm_byte:.3g}*B + {f.overhead_us:.3g}")
    text = table.to_json()
    assert CalibrationTable.from_json(text).to_json() == text
    print(f"  JSON round-trip bit-exact ({len(text)} bytes, "
          f"fingerprint {table.fingerprint()})")

    print("== 3. RE-PLAN: the same call, measured objective ==")
    describe("analytical fuse=True", plans[1], table)
    cal = plan_network(specs, budget, fuse=True, calibration=table)
    describe("calibrated fuse=True", cal, table)

    print("\n== counterfactual: a host where the fused member measures "
          "slow ==")
    slow = CalibrationTable(fits={
        member_key(s.ip.name, s.precision_bits, s.spec.native_bits):
            AffineFit(0.0, 0.0, 1e6, 3)
        for p in plans for s in p.sites if s.spec.family == "cnn_fused"})
    flipped = plan_network(specs, budget, fuse=True, calibration=slow)
    describe("calibrated fuse=True", flipped, slow)
    assert all(s.spec.family != "cnn_fused" for s in flipped.sites), \
        "a measured-slow fused member must unfuse the plan"
    print("  -> the planner unfused every block: it optimizes what was "
          "measured,\n     while feasibility (fits, floors) stayed "
          "analytical")

    # numerics never depend on the cost model that picked the plan
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.normal(size=(2, 32, 32, 8)).astype(np.float32)).to(dev)
    ws = [torch.from_numpy(rng.normal(0, (9 * cin) ** -0.5,
                                      (3, 3, cin, cout)).astype(np.float32))
          .to(dev) for cin, cout in LAYERS]

    def run(network):
        y = x
        for li, w in enumerate(ws):
            y = apply_cnn_block({"w": w}, y, pool_mode="max",
                                activation="relu", site=f"layer{li}",
                                network=network, ladder=(16, 8))
        return y

    a, b = run(cal), run(flipped)
    # one member's kernel and another's sum in their own orders: on the
    # card f32 results agree to rounding (the port's f32 bar), on the
    # CPU's plain versions bitwise
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    diff = float((a - b).abs().max())
    print(f"  -> the same outputs under both cost models (max |diff| "
          f"{diff:.1e}: budget/calibration\n     change the "
          f"implementation, never the result)")


if __name__ == "__main__":
    main()
