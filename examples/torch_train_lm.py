"""End-to-end training example for the PyTorch port: a Mamba2 (the smoke
config of mamba2-130m) for a few hundred steps, with checkpoint/restart,
the in-step non-finite guard and the ReSiPI lane controller live.

    PYTHONPATH=src python examples/torch_train_lm.py             # the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 60

It drives the same launcher a full run uses (`repro_torch.launch.train`,
the counterpart of `examples/train_lm.py`); checkpoints go to
`build/torch_train_lm/` of the checkout, and a second run resumes from the
last one. On the card drop `--smoke` in the launcher's flags (edit ARGS)
and point `--arch` at stablelm-3b or mamba2-130m to train at full size.
"""
import argparse
from pathlib import Path

from repro_torch.launch.train import main as train_main

CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_train_lm"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    argv = ["--arch", args.arch, "--smoke",
            "--steps", str(args.steps),
            "--batch", "8", "--seq", "256",
            "--lr", "3e-3",
            "--ckpt-dir", str(CKPT_DIR),
            "--ckpt-every", "100",
            "--epoch-steps", "25",
            "--log-every", "25",
            "--resume"]
    if args.device:
        argv += ["--device", args.device]
    losses = train_main(argv)
    if not losses:
        print(f"\nnothing to do: {CKPT_DIR} already holds step {args.steps}")
        return
    first, last = losses[0], sum(losses[-10:]) / len(losses[-10:])
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'OK: learning' if last < first - 0.3 else 'WARN: check'})")


if __name__ == "__main__":
    main()
