"""Offline re-analysis: update dry-run JSON cost fields from dumped op logs
(the reference's ``repro.launch.reanalyze``, over ``launch.op_cost`` logs
where the reference reads HLO dumps).

``launch.dryrun --op-dir DIR`` writes each cell's op records; this tool
re-runs ``op_cost.analyze`` on them, so a change to the counting rules
needs no new dry run.  ``tag`` is "sp" (16x16) or "mp" (2x16x16).

Usage: PYTHONPATH=src python -m repro_torch.launch.reanalyze dryrun_sp.json ops sp
"""

from __future__ import annotations

import json
import sys

from .dryrun import op_log_path
from .op_cost import analyze, load


def main(json_path: str, op_dir: str, tag: str) -> int:
    with open(json_path) as f:
        cells = json.load(f)
    n = 0
    for cell in cells:
        if cell.get("status") != "ok":
            continue
        path = op_log_path(op_dir, cell["arch"], cell["shape"], tag == "mp")
        try:
            records = load(path)
        except OSError:
            print(f"missing {path}", file=sys.stderr)
            continue
        mc = analyze(records)
        cell["flops"] = mc.flops
        cell["hlo_bytes"] = mc.bytes
        cell["collective_bytes_per_device"] = mc.collective_bytes
        cell["collective_by_kind"] = dict(mc.collective_by_kind)
        cell["trip_unknown"] = mc.trip_unknown
        cell["collectives"] = {"bytes": dict(mc.collective_by_kind),
                               "counts": dict(mc.collective_counts),
                               "total_bytes": mc.collective_bytes}
        n += 1
    with open(json_path, "w") as f:
        json.dump(cells, f, indent=2, default=float)
    print(f"reanalyzed {n} cells -> {json_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(*sys.argv[1:4]))
