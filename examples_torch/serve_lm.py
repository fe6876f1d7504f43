"""Batched LM serving example on the PyTorch/CUDA port: continuous
batching over 4 slots through ``repro_torch.launch.serve``.

    PYTHONPATH=src python examples_torch/serve_lm.py [--arch llama3.2-1b] \\
        [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.serve import serve  # noqa: E402

REQUESTS, MAX_NEW = 10, 12


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    completed = serve(["--arch", args.arch, "--smoke", "--requests",
                       str(REQUESTS), "--slots", "4", "--prompt-len", "12",
                       "--max-new", str(MAX_NEW), "--max-len", "48",
                       "--device", args.device])
    assert sorted(r.rid for r in completed) == list(range(REQUESTS))
    assert all(len(r.generated) == MAX_NEW for r in completed)
    print(f"{len(completed)} requests served, {MAX_NEW} tokens each ✓")


if __name__ == "__main__":
    main()
