"""The consistent-hashing cell ``ch10000.bulk`` on the CPU at small sizes
(the program's plain-torch twins, the full 10^6-point ring): a sound run
reads every check 0; the control and each fault planted in the program
(one owner of the device ring changed, one ring point moved, one answer
altered, half the batch left out) read ``correct`` false; a traced run
finds the program's ring spans and reads no device metric; and on the
card the cell is correct and its two metrics read.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from chipbench.harness import main as harness
from chipbench.harness import spans, spec

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[2]
SEED = 2**33 + 4243
CELL = "ch10000.bulk"
SMALL = {"config": {"population": 1 << 12}}
METRICS = ["ch_fanout_roofline", "ring.fanout_device_ms"]


def _run(trace=False, seconds=0.05, sizes=SMALL):
    return harness.run_cell(CELL, SEED, seconds, trace, CPU, 0.0, sizes=sizes)


def test_the_cell_has_its_files_and_metrics():
    s = spec.load_spec()
    c = spec.cell(s, CELL)
    assert c["chips"] == 1 and c["config"]["algorithm"] == "ch"
    assert c["config"]["virtual_nodes"] * c["config"]["nodes"] == 10**6
    assert hasattr(spec.load("drivers", c["traffic"]["driver"]).Driver, "install_control")
    assert [m["name"] for m in c["end_to_end"]] == ["placed_ids_per_s", "setup_s"]
    assert [m["name"] for m in c["per_layer"]] == METRICS
    for m in c["per_layer"]:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] == "placed_ids_per_s" and m["workloads"] == [CELL]


def test_a_sound_run_reads_every_check_0():
    result = _run()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"tables", "sampled_sets", "last_sets"}
    assert all(v["value"] == 0 for v in result["checks"].values())
    assert sorted(result["metrics"]) == ["placed_ids_per_s", "setup_s"]
    assert all(v["value"] > 0 for v in result["metrics"].values())


def test_the_control_is_not_correct():
    path = ROOT / "chipbench" / "control.py"
    mod_spec = importlib.util.spec_from_file_location("chipbench_control_cli", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    for seed in (1, 2, 3):
        out = mod.control_run(CELL, seed, 0.0, CPU, SMALL)
        assert not out["correct"], out
        assert out["checks"]["tables"] == 0 and out["checks"]["last_sets"] > 0


def _table_fault(fault):
    from repro_torch.core import engine

    original = engine.with_baseline_device_tables

    def broken(art, device):
        art = original(art, device)
        keys, vals = art.keys_dev.clone(), art.vals_dev.clone()
        if fault == "owner":  # one point's owner changed
            vals[500] = (vals[500] + 1) % 10000
        else:  # one point moved up by one
            keys[500] = keys[500].view(torch.int32) + 1
        return dataclasses.replace(art, keys_dev=keys, vals_dev=vals)

    return engine, "with_baseline_device_tables", broken


def _output_fault(fault):
    from repro_torch.core import PlacementEngine

    original = PlacementEngine.place_replica_nodes_device

    def broken(self, ids, R, *a, **k):
        out = original(self, ids, R, *a, **k).clone()
        n = out.shape[0]
        if fault == "half":  # the second half of the batch left out: rows of the first reused
            out[n // 2:] = out[: n - n // 2]
        else:  # one answer altered where it is produced
            out[0, 1] = (out[0, 1] + 1) % 10000
        return out

    return PlacementEngine, "place_replica_nodes_device", broken


FAULTS = [(_table_fault, "owner"), (_table_fault, "point"),
          (_output_fault, "altered"), (_output_fault, "half")]


@pytest.mark.parametrize("make,fault", FAULTS, ids=[f for _, f in FAULTS])
def test_a_planted_fault_is_not_correct(monkeypatch, make, fault):
    owner, name, broken = make(fault)
    monkeypatch.setattr(owner, name, broken)
    result = _run()
    assert not result["correct"], result["checks"]
    if make is _table_fault:
        assert result["checks"]["tables"]["value"] == 1


def test_a_traced_cpu_run_finds_the_ring_spans_but_reads_no_device_metric(monkeypatch):
    from chipbench.harness import cells

    got = {}
    make = cells.make

    def keep(*a, **k):
        got["run"] = make(*a, **k)
        return got["run"]

    monkeypatch.setattr(cells, "make", keep)
    sizes = {"config": SMALL["config"], "traffic": {"profiled": 2}}
    result = _run(trace=True, sizes=sizes)
    assert result["correct"], result["checks"]
    assert not set(METRICS) & set(result["metrics"])  # no device trace on the CPU
    run = got["run"]
    assert "FANOUT" in run.least and run.least["FANOUT"] > 0
    found = spans.summary(run)
    # the table was built in set-up: only the fan-out's span is inside the units
    assert sorted(found) == ["engine.baseline_replicas"]
    assert found["engine.baseline_replicas"]["count"] == 2


@pytest.mark.gpu
def test_the_cell_is_correct_on_the_card_and_reads_its_metrics(card):
    sizes = {"config": {"population": 1 << 20}, "traffic": {"profiled": 2}}
    result = harness.run_cell(CELL, SEED, 0.5, True, card, 0.0, sizes=sizes)
    assert result["correct"], result["checks"]
    assert 0 < result["metrics"]["ch_fanout_roofline"]["value"] <= 105
    assert result["metrics"]["ring.fanout_device_ms"]["value"] > 0
