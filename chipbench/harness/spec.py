"""``BENCHMARK.json`` and the files it names, found by name.

  * a cell is an entry of ``workloads``: a configuration, a traffic mix
    and the chips it needs;
  * a configuration is the JSON file its ``configs`` entry names;
  * a traffic mix is ``chipbench/traffic/<traffic>.json``, a file of
    parameters whose ``driver`` names the general driver that runs it,
    ``chipbench/drivers/<driver>.py``;
  * a configuration's capacity law is ``chipbench/laws/<kind>.py``;
  * a per-layer metric is read by ``chipbench/metrics/<name>.py``.

The metrics a cell reports are the ``end_to_end`` entries (with
``--trace 0``) and the ``per_layer`` entries (with ``--trace 1``) whose
``workloads`` list names the cell, or that have no such list.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # chipbench/
ROOT = HERE.parent


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    """``{"name", "chips", "config": <config file>, "traffic": <mix file>,
    "end_to_end": [...], "per_layer": [...]}`` of the cell ``name``."""
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "name": name,
        "chips": int(w["chips"]),
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
        "per_layer": [m for m in spec["per_layer"] if mine(m)],
    }


_LOADED: dict[tuple[str, str], object] = {}


def load(folder: str, name: str):
    """The module ``chipbench/<folder>/<name>.py``, loaded once."""
    key = (folder, name)
    if key not in _LOADED:
        path = HERE / folder / f"{name}.py"
        mod_name = f"chipbench_{folder}_" + name.replace(".", "__").replace("-", "_")
        mod_spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        _LOADED[key] = module
    return _LOADED[key]


def reader(metric: str):
    """The ``read(run)`` function of ``chipbench/metrics/<metric>.py``."""
    return load("metrics", metric).read
