"""The readers of the program's spans (``harness/spans.py``).

Their arithmetic on constructed ranges and events; a traced CPU run whose
summary finds the program's spans inside the profiled units, while the
device readers, with no device trace there, return None; and on the card
each of the new metrics reads a positive number in its traced cell.
"""

import pytest
import torch

from chipbench.harness import main as harness
from chipbench.harness import spans, spec

CPU = torch.device("cpu")
SEED = 2**31 + 4242
SERVE, SCALE = "flat10000.serve-ycsbc", "flat10000.scale"
SIZES = {
    SERVE: {"config": {"population": 1 << 12},
            "traffic": {"batch": 1 << 11, "pool_batches": 3, "profiled": 2}},
    SCALE: {"config": {"population": 1 << 12},
            "traffic": {"chunk": 1 << 10, "fuse": 4, "profiled": 2}},
}
NEW = {
    SERVE: ["serve.words_device_ms", "serve.select_device_ms", "serve.count_device_ms",
            "serve.dispatch_idle_ms"],
    SCALE: ["scale.table_build_ms", "scale.table_upload_ms", "scale.table_idle_ms",
            "scale.align_device_ms", "scale.plan_idle_ms"],
}


# -- the arithmetic ----------------------------------------------------------------


def test_a_program_span_is_a_dotted_lower_case_name_outside_the_harness():
    assert spans.is_program("serve.words") and spans.is_program("ops.align_replica_sets")
    for name in ("chipbench.unit", "aten::add", "cudaLaunchKernel",
                 "Memcpy HtoD (Pageable -> Device)",
                 "void at::native::vectorized_elementwise_kernel<4>", "serve"):
        assert not spans.is_program(name), name


def test_ranges_outside_every_unit_are_dropped():
    units = [(10.0, 20.0), (30.0, 40.0)]
    ranges = [("a.x", 11.0, 12.0, 1.0), ("a.x", 5.0, 6.0, 1.0), ("a.x", 19.0, 21.0, 1.0),
              ("a.y", 30.0, 40.0, 1.0), ("a.y", 25.0, 26.0, 1.0)]
    assert spans.in_units(ranges, units) == [ranges[0], ranges[3]]


def test_union_merges_overlapping_intervals():
    assert spans.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]


def test_the_innermost_pieces_of_nested_ranges():
    # a [0, 10] holds b [2, 5] and c [6, 8]; d [12, 14] stands alone
    ranges = [("d.d", 12, 14), ("a.a", 0, 10), ("c.c", 6, 8), ("b.b", 2, 5)]
    assert spans.innermost(ranges) == [
        ("a.a", 0, 2), ("b.b", 2, 5), ("a.a", 5, 6), ("c.c", 6, 8), ("a.a", 8, 10), ("d.d", 12, 14)]


def test_idle_goes_to_the_innermost_span():
    ranges = [("serve.route_batch", 0.0, 10.0), ("serve.words", 1.0, 4.0),
              ("serve.count", 6.0, 9.0)]
    busy = [(2.0, 3.0), (2.5, 5.0), (8.0, 12.0)]
    idle = spans.idle_by_span(ranges, busy)
    # words [1, 4]: busy [2, 4] -> 1 idle; count [6, 9]: busy [8, 9] -> 2;
    # route_batch alone [0, 1] + [4, 6] + [9, 10]: busy [4, 5], [9, 10] -> 2
    assert idle == pytest.approx(
        {"serve.words": 1.0, "serve.count": 2.0, "serve.route_batch": 2.0})


def test_totals_sum_host_and_device_time_per_name():
    ranges = [("a.x", 0.0, 2.0, 0.5), ("a.x", 3.0, 4.0, 0.25), ("a.y", 1.0, 1.5, 0.0)]
    assert spans.totals(ranges) == {"a.x": {"count": 2, "host_s": 3.0, "device_s": 0.75},
                                    "a.y": {"count": 1, "host_s": 0.5, "device_s": 0.0}}


def test_a_span_holds_the_device_time_of_what_was_launched_inside_it():
    ranges = [("serve.route_batch", 0.0, 10.0), ("serve.words", 1.0, 4.0),
              ("serve.count", 6.0, 9.0)]
    # (host time of the launch, device seconds): two in words, one between
    # words and count (B2's), one in count, one after the batch
    launches = [(1.5, 0.25), (3.0, 0.5), (5.0, 2.0), (6.0, 0.125), (11.0, 8.0)]
    assert spans.device_by_span(ranges, launches) == [
        ("serve.route_batch", 0.0, 10.0, 2.875), ("serve.words", 1.0, 4.0, 0.75),
        ("serve.count", 6.0, 9.0, 0.125)]
    assert spans.device_by_span(ranges, []) == [(n, s, t, 0.0) for n, s, t in ranges]


# -- the readers on a run ----------------------------------------------------------


def _run(monkeypatch, name, trace):
    """(result, the cell's driver) of one small CPU run of ``name``."""
    from chipbench.harness import cells

    got = {}
    make = cells.make

    def keep(*a, **k):
        got["run"] = make(*a, **k)
        return got["run"]

    monkeypatch.setattr(cells, "make", keep)
    result = harness.run_cell(name, SEED, 0.05, trace, CPU, 0.0, sizes=SIZES[name])
    return result, got["run"]


@pytest.mark.parametrize("name", [SERVE, SCALE])
def test_each_new_reader_returns_none_on_an_untraced_run(monkeypatch, name):
    result, run = _run(monkeypatch, name, False)
    assert result["correct"]
    for metric in NEW[name]:
        assert spec.reader(metric)(run) is None, metric


@pytest.mark.parametrize("name", [SERVE, SCALE])
def test_a_traced_cpu_run_finds_the_spans_but_reads_no_device_metric(monkeypatch, name):
    result, run = _run(monkeypatch, name, True)
    assert result["correct"]
    assert not set(NEW[name]) & set(result["metrics"])  # no device trace on the CPU
    found = spans.summary(run)
    if name == SERVE:
        want, once = ["serve.route_batch", "serve.words", "serve.select", "serve.count"], \
            ["serve.route_batch", "serve.words"]
    else:
        want = ["engine.build_artifact", "engine.tables_host", "engine.tables_upload",
                "planner.block", "ops.align_replica_sets"]
        once = ["engine.tables_host", "planner.block"]  # one block: 4 chunks, fuse 4
    assert sorted(found) == sorted(want)
    # the 2 profiled units' spans only: the primer's fall outside them
    assert [found[span]["count"] for span in once] == [2, 2]
    assert all(d["host_s"] > 0 for d in found.values())


def test_the_benchmark_names_each_new_metric_in_its_cell_only():
    s = spec.load_spec()
    for cell, metrics in NEW.items():
        for m in metrics:
            entry = [e for e in s["per_layer"] if e["name"] == m][0]
            assert entry["workloads"] == [cell] and entry["unit"] == "ms"
            assert entry["source"] == "device_trace" and entry["better"] == "lower"


@pytest.mark.gpu
def test_every_new_metric_reads_a_positive_number_in_its_traced_cell(card):
    for name, metrics in NEW.items():
        result = harness.run_cell(name, SEED, 0.5, True, card, 0.0, sizes=SIZES[name])
        assert result["correct"], (name, result["checks"])
        for m in metrics:
            assert result["metrics"][m]["value"] > 0, (name, m, result["metrics"])
