"""Readings that set the limits of ``correct``: the program's numbers and
the control's on many seeds of one cell, in one process.

    python3 perfbench/control.py --workload <cell> --seeds 12 \\
        --first-seed 3000000100 --seconds 3

For each seed it runs the cell as the benchmark does (a shorter window)
and judges the same sampled answers twice against the cell's limits: the
program's, and the control's (the reference one rung lower: float32 with
TF32 on, 16-bit rungs at 8 bits, 8-bit rungs at 4 bits).  One JSON line
a seed.  It exits non-zero unless every seed's program is ``correct``
and every seed's control is not.  The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_100)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from perfbench.harness import cell
    held = True
    for i in range(args.seeds):
        seed = args.first_seed + i
        out = cell.run(ROOT, args.workload, seed, args.seconds, False,
                       "cuda", time.perf_counter(),
                       log=lambda m: print(m, file=sys.stderr, flush=True),
                       control=True)
        held &= out["correct"] and not out["control_correct"]
        print(json.dumps({
            "seed": seed, "correct": out["correct"],
            "control_correct": out["control_correct"],
            "program": {k: v["value"] for k, v in out["checks"].items()},
            "control": {k: v["value"] for k, v in out["control"].items()}}),
            flush=True)
    print(f"every program correct and every control failed: {held}",
          file=sys.stderr)
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
