"""One run of one cell: set up, measure, judge, print one JSON line.

``run_cell`` does the work on a given device (the tests drive it on the
CPU at small sizes); ``main`` is the command line, which insists on the
cards the cell asks for and on a process free of JAX and the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from chipbench.harness import cells, spec
from chipbench.harness.trace import is_kernel, top, warm_profiler

# whole top-level module names that may not be loaded: JAX, its
# libraries, and the package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, dev, t_start: float,
             sizes: dict | None = None, the_spec: dict | None = None) -> dict:
    """Run the cell ``name`` once and return its result object.

    ``sizes`` overrides entries of the configuration and the traffic mix
    (the tests run the cells at small sizes)."""
    import torch

    cell_spec = spec.cell(the_spec or spec.load_spec(), name)
    config = dict(cell_spec["config"], **(sizes or {}).get("config", {}))
    traffic = dict(cell_spec["traffic"], **(sizes or {}).get("traffic", {}))
    cuda = dev.type == "cuda"
    parts = {"imports": time.perf_counter() - t_start}
    if cuda:
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    parts["device"] = time.perf_counter() - t_start - sum(parts.values())
    if trace:
        warm_profiler(dev)
    driver = cells.make(config, traffic, seed, dev, trace)
    driver.setup()
    setup_s = time.perf_counter() - t_start
    parts["cell"] = setup_s - sum(parts.values())
    driver.window(float(seconds))
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks = driver.judge()
    parts["judge_after_window"] = time.perf_counter() - t_judge
    bad = sum(v for v in checks.values())
    metrics = {}
    if trace:
        for m in cell_spec["per_layer"]:
            value = spec.reader(m["name"])(driver)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(driver.e2e, setup_s=setup_s)
        for m in cell_spec["end_to_end"]:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    result = {"correct": bad == 0, "attempted": int(driver.attempted), "failed": int(bad),
              "metrics": metrics, "device": device}
    if trace and driver.profile is not None:
        p = driver.profile
        device["busy_s"] = p.busy_s
        device["window_s"] = p.window_s
        result["breakdown"] = {
            "device_ops": top((n, t - s) for n, s, t in p.device_ops),
            "idle_gaps": top(p.gaps),
        }
        result["profiled_units"] = driver.profiled
        result["kernels_in_profile"] = sum(1 for n, _, _ in p.device_ops if is_kernel(n))
        if cuda:
            result["card"] = _power_limit()
    result["parts_s"] = parts
    q = statistics.quantiles(driver.unit_s, n=10) if len(driver.unit_s) > 1 else [0.0] * 9
    result["unit_ms"] = {"p10": 1e3 * q[0], "p50": 1e3 * q[4], "p90": 1e3 * q[8],
                         "spans_p50": {k: 1e3 * statistics.median(v) for k, v in driver.spans.items()}}
    result["checks"] = {k: {"value": int(v), "limit": 0} for k, v in checks.items()}
    return result


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    the_spec = spec.load_spec()
    chips = spec.cell(the_spec, args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"chipbench: the cell needs {chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start, the_spec=the_spec)
    loaded = forbidden_modules()
    if loaded:
        print(f"chipbench: the process loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
