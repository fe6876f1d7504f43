"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on one card and prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics untraced, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number the correctness check
compared beside its limit (also the last lines of standard error).

It exits non-zero and prints no result where PyTorch sees fewer CUDA
devices than the cell asks for, or where the process holds ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` once the window has
closed.  The program's kernels are built into ``build/torch_ext``
inside the checkout on first use.
"""
from __future__ import annotations

import time

PROC_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # keep libraries that would load JAX by themselves from doing so
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    cells = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
    chips = next((w["chips"] for w in cells if w["name"] == args.workload),
                 1)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s), PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": the benchmark runs on the card only", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    from perfbench.harness import cell
    out = cell.run(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", PROC_T0,
                   log=lambda m: print(m, file=sys.stderr, flush=True))
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
