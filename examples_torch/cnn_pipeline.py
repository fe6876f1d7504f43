"""Adaptive CNN pipeline — the paper's future-work scenario closed on the
PyTorch/CUDA port: a full CNN layer stack (conv -> pool -> activation)
planned as ONE NetworkPlan — every op site competes for a slice of the
same budget, and the budget is partitioned across the whole graph up
front.

    PYTHONPATH=src python examples_torch/cnn_pipeline.py [--device cpu]

Part 1 runs an int8 fixed-point CNN under three deployment budgets
(ample / MXU-starved / VPU-starved): the planned IPs differ per budget,
the outputs are bit-identical — adaptation changes the implementation,
never the math.  Plans are memoized (re-planning the same graph+budget
is a dict hit) and serialize to JSON for experiment artifacts.

Part 2 shows the precision axis the activation family adds: under an
8-bit-precision budget the selector swaps the exact transcendental for
the fixed-point LUT IP, trading a bounded approximation error for ~4x
fewer vector ops and 1-byte operand streaming.

Part 3 plans the precision ladder: a float32 block that does NOT fit a
tight on-chip memory envelope is re-planned with per-site
``ladder=(16, 8)`` — the planner lowers exactly the sites that need it
(the ``p=`` column of ``describe()``), execution quantizes accordingly,
and the per-site error report quantifies what the fit cost.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.plan import (NetworkPlan, plan_network,  # noqa: E402
                                   planner_stats)
from repro_torch.core.resources import ResourceBudget  # noqa: E402
from repro_torch.core.selector import select_activation_ip  # noqa: E402
from repro_torch.kernels.activation.ops import activation  # noqa: E402
from repro_torch.kernels.conv2d.ops import conv2d  # noqa: E402
from repro_torch.kernels.pool2d.ops import pool2d  # noqa: E402
from repro_torch.models.blocks import (apply_cnn_block,  # noqa: E402
                                       cnn_block_site_specs, init_cnn_block)
from repro_torch.models.frontends import resolve_device  # noqa: E402
from repro_torch.quant.report import max_rel_error, summarize  # noqa: E402

LAYERS = [  # (cin, cout, kernel)
    (8, 16, 3),
    (16, 32, 3),
    (32, 32, 3),
]

BUDGETS = {
    "ample": ResourceBudget(),
    "mxu_starved": ResourceBudget(mxu_available=False),
    "vpu_starved": ResourceBudget(vpu_ops_budget=2_000_000),
}


def requantize(y):
    y = torch.div(y, 8, rounding_mode="floor")
    return torch.clamp(y, -128, 127).to(torch.int8)


def stack_site_specs(img_shape):
    """The whole stack as declarative sites: conv (int8 operands) ->
    maxpool -> relu (both on the conv's int32 accumulator), requantized
    back to int8 between layers."""
    specs = []
    shape = tuple(img_shape)
    for li, (cin, cout, k) in enumerate(LAYERS):
        layer, out = cnn_block_site_specs(
            shape, (k, k, cin, cout), x_dtype=torch.int8, pool_mode="max",
            activation="relu", site=f"layer{li}")
        specs += layer
        shape = out[0]
    return specs


def run_stack(img, weights, budget):
    """conv -> maxpool -> relu -> requant per layer, from one plan.
    fuse=False: this part drives each op kernel by hand (with its own
    requantize between them), so it needs the per-op sites the fused
    default would collapse."""
    plan = plan_network(stack_site_specs(img.shape), budget, fuse=False)
    x = img
    for li, w in enumerate(weights):
        x = conv2d(x, w, ip=plan[f"layer{li}.conv"][0].name)
        x = pool2d(x, window=(2, 2), mode="max",
                   ip=plan[f"layer{li}.pool"][0].name)
        x = requantize(activation(x, kind="relu",
                                  ip=plan[f"layer{li}.act"][0].name))
    return x, plan


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (their plain "
                         "versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(-128, 128, (2, 40, 40, 8),
                                        dtype=np.int8)).to(dev)
    weights = [torch.from_numpy(rng.integers(-16, 16, (k, k, cin, cout),
                                             dtype=np.int8)).to(dev)
               for cin, cout, k in LAYERS]

    results = {}
    for bname, budget in BUDGETS.items():
        out, plan = run_stack(img, weights, budget)
        results[bname] = out.cpu().numpy()
        print(f"\n=== budget: {bname} ===")
        print(plan.describe())
        print(f"  output: {tuple(out.shape)}, "
              f"sum={int(results[bname].sum())} on {out.device}")

    base = results["ample"]
    for bname, out in results.items():
        assert np.array_equal(out, base), bname
    print("\nall budgets produced IDENTICAL outputs — adaptation changed "
          "the implementation, not the math. ✓")

    # --- plan cache + JSON artifacts ------------------------------------
    evals_before = planner_stats().selector_evals
    replanned = plan_network(stack_site_specs(img.shape), BUDGETS["ample"],
                             fuse=False)
    assert planner_stats().selector_evals == evals_before
    assert replanned is plan_network(stack_site_specs(img.shape),
                                     BUDGETS["ample"], fuse=False)
    roundtrip = NetworkPlan.from_json(replanned.to_json())
    assert roundtrip == replanned
    print("plan cache hit (zero new selector evals) + JSON round-trip. ✓")

    # --- Part 2: the precision axis -------------------------------------
    feats = torch.from_numpy(
        rng.normal(0, 2, (2, 10, 10, 32)).astype(np.float32)).to(dev)
    full = ResourceBudget(precision_bits=16)
    low = ResourceBudget(precision_bits=8)
    ip_full = select_activation_ip(tuple(feats.shape), kind="tanh",
                                   budget=full)
    ip_low = select_activation_ip(tuple(feats.shape), kind="tanh",
                                  budget=low)
    y_full = activation(feats, kind="tanh", ip=ip_full.name)
    y_low = activation(feats, kind="tanh", ip=ip_low.name)
    err = float((y_full - y_low).abs().max())
    print(f"\ntanh head: precision>=16b -> {ip_full.name}, "
          f"precision<=8b -> {ip_low.name}")
    print(f"max |exact - lut| = {err:.4f} (bounded by the 256-level grid)")
    assert ip_full.name == "activation.act_vpu"
    assert ip_low.name == "activation.act_lut"
    assert err < 0.05
    print("precision-driven swap verified. ✓")

    # --- Part 3: the precision ladder ------------------------------------
    block = init_cnn_block(0, cin=8, cout=16, k=3, device=dev)
    xs = torch.from_numpy(
        rng.normal(size=(2, 16, 16, 8)).astype(np.float32)).to(dev)
    y_f32 = apply_cnn_block(block, xs, activation="relu")
    # 24 KiB: too tight for the f32 fused block (the planner fuses by
    # default), loose enough for its int16 rung.
    tight = ResourceBudget(vmem_bytes=24 * 1024)
    try:
        apply_cnn_block(block, xs, budget=tight, activation="relu")
        raise AssertionError("expected the f32-only block to be infeasible")
    except ValueError:
        print(f"\nf32-only block under {tight.vmem_bytes // 1024}KiB on-chip "
              "memory: infeasible (as expected)")
    report = {}
    y_lad = apply_cnn_block(block, xs, budget=tight, ladder=(16, 8),
                            activation="relu", quant_report=report)
    specs3, _ = cnn_block_site_specs(tuple(xs.shape),
                                     tuple(block["w"].shape),
                                     x_dtype=xs.dtype, activation="relu",
                                     ladder=(16, 8))
    plan3 = plan_network(specs3, tight)
    print("ladder-planned block (note the p= column):")
    print(plan3.describe())
    print("per-site quantization error report:")
    print(summarize(report))
    rel = float(torch.linalg.norm(y_lad - y_f32) / torch.linalg.norm(y_f32))
    assert max_rel_error(report) <= 5e-2 and rel <= 5e-2
    print(f"ladder made the block fit; end-to-end rel err {rel:.2e} ≤ 5e-2 ✓")


if __name__ == "__main__":
    main()
