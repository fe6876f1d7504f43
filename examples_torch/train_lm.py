"""End-to-end training example on the PyTorch/CUDA port
(``repro_torch.launch.train``).

Default: a reduced olmo-family model for 60 steps with checkpointing —
the loss visibly drops (asserted).

The ~100M-parameter run:
    PYTHONPATH=src python examples_torch/train_lm.py --full
drives the same launcher with d_model=768, 12 layers (~103M params incl
embeddings) for 300 steps at batch 16 x 512; the launcher is identical.

    PYTHONPATH=src python examples_torch/train_lm.py [--device cpu]
"""
import argparse
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.train import train  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    ckpt = tempfile.mkdtemp(prefix="train_lm_")
    try:
        if args.full:
            losses = train(["--arch", "olmo-1b", "--smoke",
                            "--d-model", "768", "--n-layers", "12",
                            "--steps", "300", "--batch", "16", "--seq",
                            "512", "--lr", "3e-4", "--ckpt-dir", ckpt,
                            "--ckpt-every", "50", "--device", args.device])
        else:
            losses = train(["--arch", "olmo-1b", "--smoke",
                            "--steps", "60", "--batch", "8", "--seq", "64",
                            "--lr", "5e-3", "--ckpt-dir", ckpt,
                            "--ckpt-every", "20", "--device", args.device])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    first, last = float(losses[0]), float(losses[-1])
    assert last < first, (first, last)
    print(f"loss {first:.4f} -> {last:.4f} over {len(losses)} steps ✓")


if __name__ == "__main__":
    main()
