"""Run a cell with the control in the program's place, on several seeds.

    python3 chipbench/control.py --workload <cell> --seeds 11 12 13 [--seconds 0]

For each seed the cell is set up as in a run, its calls into the program
are replaced by the float32 reference (the driver's ``install_control``), a short
window runs (the sampled and last units, at the cell's own sizes) and the
judge's numbers are printed, one JSON line per seed.  Every line has to
read ``"correct": false``: that is what shows the comparison can tell the
control from the program.  The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:1] = [str(ROOT), str(ROOT / "src")]

from chipbench.harness import cells, spec  # noqa: E402


def control_run(name: str, seed: int, seconds: float, dev, sizes: dict | None = None) -> dict:
    """The judge's numbers of one control run of ``name``."""
    c = spec.cell(spec.load_spec(), name)
    config = dict(c["config"], **(sizes or {}).get("config", {}))
    traffic = dict(c["traffic"], **(sizes or {}).get("traffic", {}))
    cell = cells.make(config, traffic, seed, dev, trace=False)
    cell.setup()
    cell.install_control()
    cell.window(seconds)
    cell.release()
    checks = cell.judge()
    return {"workload": name, "seed": seed, "correct": sum(checks.values()) == 0, "checks": checks}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chipbench control: needs a CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        print(json.dumps(control_run(args.workload, seed, args.seconds, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
