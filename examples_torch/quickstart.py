"""Quickstart — the paper's own scenario on the PyTorch/CUDA port: a small
CNN whose convolution layers are implemented by resource-adaptive IPs.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

For three deployment budgets (ample / MXU-starved / VMEM-tight) the
selector assigns a conv IP per layer, the network runs int8 inference
through the selected members (their CUDA kernels on the card, their
plain PyTorch versions with ``--device cpu``), and all three deployments
are checked to produce identical outputs — resource adaptation changes
the *implementation*, never the *result* (the paper's central promise).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.resources import ResourceBudget  # noqa: E402
from repro_torch.core.selector import select_conv_ip  # noqa: E402
from repro_torch.kernels.conv2d.ops import conv2d  # noqa: E402
from repro_torch.models.frontends import resolve_device  # noqa: E402

LAYERS = [  # (cin, cout, kernel) — an int8 feature stack big enough
    (16, 32, 3),   # that the MXU IP wins under an ample budget while
    (32, 64, 3),   # the VPU IP takes over when the MXU is spoken for
    (64, 64, 3),
]

BUDGETS = {
    "ample": ResourceBudget(),
    "mxu_starved": ResourceBudget(mxu_available=False),
    "vmem_tight": ResourceBudget(vmem_bytes=1 * 2**20),
}


def relu_pool(x):
    x = torch.clamp_min(x, 0)
    n, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2, :]
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
    x = torch.div(x, 8, rounding_mode="floor")             # requantize
    return torch.clamp(x, -128, 127).to(torch.int8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (their plain "
                         "versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(-128, 128, (2, 48, 48, 16),
                                        dtype=np.int8)).to(dev)
    weights = [torch.from_numpy(rng.integers(-16, 16, (k, k, cin, cout),
                                             dtype=np.int8)).to(dev)
               for cin, cout, k in LAYERS]

    results = {}
    for bname, budget in BUDGETS.items():
        print(f"\n=== budget: {bname} ===")
        x = img
        for li, ((cin, cout, k), w) in enumerate(zip(LAYERS, weights)):
            ip = select_conv_ip(tuple(x.shape), tuple(w.shape), dual=False,
                                dtype=torch.int8, budget=budget)
            fp = ip.footprint(*x.shape, k, k, cout, itemsize=1)
            print(f"  layer {li}: {tuple(x.shape)} -> {ip.name:<22s} "
                  f"vmem={fp.vmem_bytes/1024:8.1f}KiB mxu={fp.mxu_passes:<4d} "
                  f"vpu={fp.vpu_ops:.2e}")
            y = conv2d(x, w, ip=ip.name)
            x = relu_pool(y)
        results[bname] = x.cpu().numpy()
        print(f"  output: {tuple(x.shape)}, sum={int(results[bname].sum())} "
              f"on {x.device}")

    base = results["ample"]
    for bname, out in results.items():
        assert np.array_equal(out, base), bname
    print("\nall budgets produced IDENTICAL outputs — adaptation changed "
          "the implementation, not the math. ✓")


if __name__ == "__main__":
    main()
