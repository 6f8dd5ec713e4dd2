"""The harness on the CPU at small sizes: every cell runs and is correct;
the control and each fault the cell can have make it not correct; and
nothing the benchmark loads is JAX or the JAX package.

The runs skip the command line's look for a card and drive the rest of a
run through ``run_cell`` with the program's CPU path (its plain-torch
twins).  ``pytest -m gpu`` runs the card's test on the card.
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chipbench.harness import main as harness
from chipbench.harness import spec

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 4242

SMALL = {
    "flat10000.bulk": {"config": {"population": 1 << 12}},
    "hier81x90.bulk": {"config": {"population": 1 << 12}},
    "flat10000.serve-ycsbc": {"config": {"population": 1 << 12}, "traffic": {"batch": 1 << 11, "pool_batches": 3}},
    "flat10000.scale": {"config": {"population": 1 << 12}, "traffic": {"chunk": 1 << 10, "fuse": 4}},
}
# where the float32 control must show: enough ids that a share of ~5e-4
# of them lands on a different node
CONTROL = {
    "flat10000.bulk": {"config": {"population": 1 << 16}},
    "hier81x90.bulk": {"config": {"population": 1 << 16}},
    "flat10000.serve-ycsbc": {"config": {"population": 1 << 16}, "traffic": {"batch": 1 << 14, "pool_batches": 2}},
    "flat10000.scale": {"config": {"population": 1 << 16}, "traffic": {"chunk": 1 << 14, "fuse": 4}},
}
CELLS = sorted(SMALL)


def _run(name, trace=False, seconds=0.05):
    return harness.run_cell(name, SEED, seconds, trace, CPU, 0.0, sizes=SMALL[name])


def test_every_cell_of_the_benchmark_has_its_files():
    s = spec.load_spec()
    assert sorted(w["name"] for w in s["workloads"]) == CELLS
    for m in s["per_layer"]:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            assert m["moves"] in [e["name"] for e in spec.cell(s, w)["end_to_end"]]


def test_drivers_and_laws_are_found_by_name():
    s = spec.load_spec()
    for w in s["workloads"]:
        c = spec.cell(s, w["name"])
        assert hasattr(spec.load("drivers", c["traffic"]["driver"]).Driver, "install_control")
        law = c["config"]["capacity_law"]
        caps = spec.load("laws", law["kind"]).draw(law, 5, np.random.default_rng(0))
        assert caps.shape == (5,) and (caps > 0).all()


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_and_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    want = [m["name"] for m in spec.cell(spec.load_spec(), name)["end_to_end"]]
    assert sorted(result["metrics"]) == sorted(want)
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"


def test_a_traced_run_reads_its_spans():
    name = "flat10000.serve-ycsbc"
    sizes = {"config": SMALL[name]["config"], "traffic": dict(SMALL[name]["traffic"], profiled=2)}
    result = harness.run_cell(name, SEED, 3.0, True, CPU, 0.0, sizes=sizes)
    assert result["correct"]
    assert "serve.enqueue_ms" in result["metrics"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    import importlib.util

    path = ROOT / "chipbench" / "control.py"
    mod_spec = importlib.util.spec_from_file_location("chipbench_control_cli", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    out = mod.control_run(name, 5, 0.0, CPU, CONTROL[name])
    assert not out["correct"], out


# -- faults planted in the program under the harness ---------------------------


def _bulk_fault(engine_method, fault):
    from repro_torch.core import PlacementEngine

    original = getattr(PlacementEngine, engine_method)

    def broken(self, ids, R, *a, **k):
        out = original(self, ids, R, *a, **k).clone()
        n = out.shape[-1] if out.dim() == 3 else out.shape[0]
        if fault == "half":  # the second half of the batch left out: rows of the first reused
            if out.dim() == 3:
                out[..., n // 2:] = out[..., : n - n // 2]
            else:
                out[n // 2:] = out[: n - n // 2]
        else:  # one answer altered where it is produced
            flat = out.view(-1)
            flat[0] = (flat[0] + 1) % 64
        return out

    return PlacementEngine, engine_method, broken


def _serve_fault(fault):
    from repro_torch.serve import RequestStreamDriver

    original = RequestStreamDriver.route_batch

    def broken(self, ids):
        before = (self.counts, self.queue)
        if fault == "half":
            half = original(self, ids[: ids.shape[0] // 2])
            return torch.cat([half, half])
        chosen = original(self, ids)
        if fault == "unchanged":  # the step returns its state unchanged
            self.counts, self.queue = before
        elif fault == "shifted":  # an unrecorded batch's count moved to another node
            if getattr(self, "_calls", 0) == 1:
                counts = self.counts.clone()
                counts[0] -= 1
                counts[1] += 1
                self.counts = counts
            self._calls = getattr(self, "_calls", 0) + 1
        elif fault == "altered":
            chosen = chosen.clone()
            chosen[0] = (chosen[0] + 1) % 10000
        return chosen

    return RequestStreamDriver, "route_batch", broken


def _scale_fault(fault):
    from repro_torch.migrate import MigrationPlanner

    original = MigrationPlanner.plan_replicas_stream

    def broken(self, *a, **k):
        for i, (ids, moved, src, dst, src_slot) in enumerate(original(self, *a, **k)):
            if fault == "unchanged":
                moved = torch.zeros_like(moved)
            elif fault == "half":
                moved = moved.clone()
                moved[moved.shape[0] // 2:] = False
            elif i == 0:
                dst = dst.clone()
                dst[0, 0] = (dst[0, 0] + 1) % 10000
            yield ids, moved, src, dst, src_slot

    return MigrationPlanner, "plan_replicas_stream", broken


FAULTS = [
    ("flat10000.bulk", lambda f: _bulk_fault("place_replica_nodes_device", f), "half"),
    ("flat10000.bulk", lambda f: _bulk_fault("place_replica_nodes_device", f), "altered"),
    ("hier81x90.bulk", lambda f: _bulk_fault("place_replica_pairs_device", f), "half"),
    ("hier81x90.bulk", lambda f: _bulk_fault("place_replica_pairs_device", f), "altered"),
    ("flat10000.serve-ycsbc", _serve_fault, "unchanged"),
    ("flat10000.serve-ycsbc", _serve_fault, "half"),
    ("flat10000.serve-ycsbc", _serve_fault, "altered"),
    ("flat10000.serve-ycsbc", _serve_fault, "shifted"),
    ("flat10000.scale", _scale_fault, "unchanged"),
    ("flat10000.scale", _scale_fault, "half"),
    ("flat10000.scale", _scale_fault, "altered"),
]


@pytest.mark.parametrize("name,make,fault", FAULTS, ids=[f"{n}-{f}" for n, _, f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, name, make, fault):
    owner, method, broken = make(fault)
    monkeypatch.setattr(owner, method, broken)
    result = _run(name)
    assert not result["correct"], result["checks"]


# -- what the benchmark loads ---------------------------------------------------


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = list((ROOT / "chipbench").rglob("*.py"))
    assert files
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "chipbench" / "reference").rglob("*.py"):
        assert not _imports(path) & {"repro_torch", "repro", "jax"}, path


def test_a_run_loads_no_jax_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import torch\n"
        "from chipbench.harness import main, cells\n"
        "from chipbench.harness.main import run_cell, forbidden_modules\n"
        "r = run_cell('flat10000.bulk', 3, 0.01, False, torch.device('cpu'), 0.0,\n"
        "             sizes={'config': {'population': 1024}})\n"
        "print(forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert harness.forbidden_modules(["jax.numpy", "repro.core", "repro_torch", "flax"]) == [
        "flax", "jax.numpy", "repro.core"]


def test_the_command_needs_the_card_and_its_files(tmp_path):
    # without a card the command prints no result and fails
    env_code = "import torch; print(torch.cuda.is_available())"
    has_card = subprocess.run([sys.executable, "-c", env_code], capture_output=True, text=True)
    cmd = [sys.executable, "chipbench/run.py", "--workload", "flat10000.bulk", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    if has_card.stdout.strip() == "False":
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""
    # a folder with only BENCHMARK.json and the benchmark's files has no program
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_every_cell_is_correct_on_the_card_at_small_sizes(card):
    for name in CELLS:
        result = harness.run_cell(name, SEED, 0.2, False, card, 0.0, sizes=SMALL[name])
        assert result["correct"], (name, json.dumps(result["checks"]))
