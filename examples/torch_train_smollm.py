"""End-to-end run on PyTorch: train a reduced smollm-135m for a few
hundred steps.

The same run as ``examples/train_smollm.py`` through the port's launcher
(``repro_torch.launch.train``): ASURA-placed data shards, AdamW, async
ASURA-replicated checkpoints.  It trains the ~1M-parameter reduction; on
the card drop ``--reduced`` in the launcher for the full config.

Run:  PYTHONPATH=src python examples/torch_train_smollm.py [--steps 200] [--device cpu]
(without ``--device`` it runs on the CUDA card and raises without one).
"""

import argparse
import sys

from repro_torch.launch.train import main as train_main


def main(steps: int = 200, device=None) -> int:
    argv = [
        "--arch", "smollm-135m",
        "--reduced",
        "--steps", str(steps),
        "--batch", "8",
        "--seq", "128",
        "--ckpt-every", "50",
    ]
    if device is not None:
        argv += ["--device", device]
    return train_main(argv)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    sys.exit(main(args.steps, args.device))
