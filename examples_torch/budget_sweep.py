"""Budget sweep — paper Table III as an executable experiment, extended
to the LM hot path and planned as a WHOLE NETWORK: for each resource
budget, the paper's 3x3 conv, an LM FFN matmul, and attention at
train/decode shapes are mapped by one ``plan_network`` call — the four
sites share the envelope (partitioned proportional-to-cost with greedy
repair) instead of each seeing the full budget.

The FFN site carries a precision *ladder* (it may drop to w8a8): each
cell prints ``member@bits``, and a trailing ``*`` marks sites the
planner lowered below their native width to make the network fit —
the ladder engaging is visible per budget.  The table is the reference
example's (``examples/budget_sweep.py``), byte for byte.  Then the conv
site runs once per budget through its planned member on the device, and
every budget's output is the same.

    PYTHONPATH=src python examples_torch/budget_sweep.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.ip import SiteSpec  # noqa: E402
from repro_torch.core.plan import plan_network, select_ip  # noqa: E402
from repro_torch.core.resources import ResourceBudget  # noqa: E402
from repro_torch.kernels.conv2d.ops import conv2d  # noqa: E402
from repro_torch.models.frontends import resolve_device  # noqa: E402

BUDGETS = {
    "ample": ResourceBudget(),
    "no_mxu": ResourceBudget(mxu_available=False),
    "vmem_16MiB": ResourceBudget(vmem_bytes=16 * 2**20),
    "vmem_6MiB": ResourceBudget(vmem_bytes=6 * 2**20),
    "int8_parallel": ResourceBudget(precision_bits=8,
                                    prefer_parallel_streams=True),
    "int8_serial": ResourceBudget(precision_bits=8),
}
CONV = ((8, 64, 64, 16), (3, 3, 16, 32))


def lm_network_specs(cfg, budget):
    D, F = cfg.d_model, cfg.d_ff
    dual = budget.prefer_parallel_streams
    mm_dtype = torch.int8 if budget.precision_bits <= 8 else torch.bfloat16
    return [
        SiteSpec.make("conv3x3", "conv2d", CONV, torch.int8, dual=dual),
        # the FFN tolerates w8a8: the planner may descend to 8 bits
        SiteSpec.make("ffn", "matmul", ((4096, D), (D, F)), mm_dtype,
                      ladder=(8,), dual=dual),
        SiteSpec.make("attn_train4k", "attention",
                      ((8, 32, 4096, 64), (8, 8, 4096, 64)), torch.bfloat16),
        SiteSpec.make("attn_decode32k", "attention",
                      ((128, 32, 1, 64), (128, 8, 32768, 64)),
                      torch.bfloat16),
    ]


def _cell(site):
    """member@bits, '*' when the precision ladder lowered the site."""
    return (f"{site.ip.name.split('.')[-1]}@{site.precision_bits}b"
            + ("*" if site.lowered else ""))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (their plain "
                         "versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_config("llama3.2-1b")
    print(f"arch for LM sites: {cfg.name} (D={cfg.d_model}, F={cfg.d_ff})\n")
    hdr = (f"{'budget':<14s} {'conv3x3':<18s} {'ffn matmul':<20s} "
           f"{'attn train4k':<22s} {'attn decode32k'}")
    print(hdr)
    print("-" * len(hdr))
    convs = {}
    for name, b in BUDGETS.items():
        specs = lm_network_specs(cfg, b)
        try:
            plan = plan_network(specs, b)
            cells = [_cell(plan.site(s.name)) for s in specs]
            convs[name] = plan.site("conv3x3")
        except ValueError:
            # no joint plan: fall back to per-site full-budget selection
            # so the table shows WHICH sites cannot run
            cells = []
            for s in specs:
                try:
                    cells.append(
                        select_ip(s.family, s, budget=b).name.split(".")[-1]
                        + "!")
                except ValueError:
                    cells.append("infeasible")
        print(f"{name:<14s} {cells[0]:<18s} {cells[1]:<20s} "
              f"{cells[2]:<22s} {cells[3]}")
    print("\nNote: 'no_mxu' steers every site to the logic-only (Conv1-"
          "analogue) members; 'int8_parallel' unlocks the packed dual-"
          "stream (Conv3-analogue) members — paper Table I, automated. "
          "A '*' marks sites the precision ladder lowered below native "
          "width (e.g. the FFN dropping to w8a8 under 'vmem_6MiB'); a "
          "'!' marks per-site fallback choices when no joint "
          "whole-network plan exists under the budget.")

    # the conv site through each budget's planned member, on the device
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-128, 128, CONV[0], dtype=np.int8))
    w = torch.from_numpy(rng.integers(-16, 16, CONV[1], dtype=np.int8))
    x, w = x.to(dev), w.to(dev)
    outs = {}
    for name, site in convs.items():
        if site.precision_bits != 8 or site.spec.family != "conv2d":
            continue
        members = site.ip.name
        if "dual" in members or "packed" in members:
            continue   # two-stream members take two inputs
        outs[name] = conv2d(x, w, ip=members)
        print(f"conv3x3 under {name:<14s} ran {members} on {dev}")
    base = next(iter(outs.values()))
    for name, y in outs.items():
        assert torch.equal(y, base), name
    print(f"{len(outs)} budgets' conv members gave IDENTICAL outputs ✓")


if __name__ == "__main__":
    main()
