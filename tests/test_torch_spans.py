"""The port's spans: ``maybe_span`` / ``TraceLedger.span`` as profiler ranges.

  * under ``torch.profiler``, ``route_batch``, ``step()``, a table build and
    a fused ``plan_replicas_stream`` open their layers' ranges
    (``serve.*``, ``engine.tables_host`` / ``engine.tables_upload``,
    ``planner.block``, ``ops.align_replica_sets``), nested and in order;
  * outputs and state are bit-equal with the profiler on and off;
  * with no profiler and no ledger a span calls no ``record_function`` and
    records no ledger event; ledger events keep their shape either way;
  * the engine keeps no count of cache hits;
  * a baseline engine's table build opens ``engine.ring_host`` (CH's ring)
    and ``engine.ring_upload``, its fan-out ``engine.baseline_replicas``;
    off, they call no ``record_function``, and on the card they add no
    launch and no host sync, on or off.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import PlacementEngine, make_cluster
from repro_torch.migrate import MigrationPlanner
from repro_torch.obs import TraceLedger, get_ledger, maybe_span
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import RequestStreamDriver

CAPS = [0.5, 1.5, 1.0, 2.0, 0.75, 1.25, 1.0, 0.6, 1.9, 1.1, 0.8, 1.4]
SPANS = ("serve.route_batch", "serve.words", "serve.select", "serve.count",
         "engine.build_artifact", "engine.tables_host", "engine.tables_upload",
         "planner.block", "ops.align_replica_sets", "test.consumer",
         "engine.ring_host", "engine.ring_upload", "engine.baseline_replicas")
BASELINES = ("ch", "rs", "wrh")


def _engine(algorithm="asura"):
    return PlacementEngine(make_cluster(CAPS, device="cpu"), device="cpu", algorithm=algorithm)


def _driver(policy="pow2"):
    return RequestStreamDriver(_engine(), batch=256, n_replicas=3, policy=policy, seed=7)


def _ranges(prof):
    """(name, start, end) of the program's ranges, in start order (an
    enclosing range before the ranges it holds)."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name in SPANS]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _ranges(prof)


def _ids(n=300, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32))


# -- the spans under the profiler ---------------------------------------------


@pytest.mark.parametrize("policy", ["primary", "pow2"])
def test_route_batch_opens_words_select_count_inside_its_own_range(policy):
    d = _driver(policy)
    _, ranges = _traced(lambda: d.route_batch(_ids()))
    assert [r[0] for r in ranges] == ["serve.route_batch", "serve.words", "serve.select",
                                      "serve.count"]
    outer, *inner = ranges
    assert all(_inside(r, outer) for r in inner)
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))  # one after another


def test_step_opens_words_select_count_in_order():
    d = _driver()
    _, ranges = _traced(lambda: [d.step() for _ in range(2)])
    assert [r[0] for r in ranges] == ["serve.words", "serve.select", "serve.count"] * 2
    assert all(a[2] <= b[1] for a, b in zip(ranges, ranges[1:]))


def test_a_table_build_opens_host_then_upload_inside_build_artifact():
    eng = _engine()
    eng.artifact()
    eng.cluster.add_node(len(CAPS), 1.0)
    _, ranges = _traced(eng.artifact)
    assert [r[0] for r in ranges] == ["engine.build_artifact", "engine.tables_host",
                                      "engine.tables_upload"]
    build, host, upload = ranges
    assert _inside(host, build) and _inside(upload, build)
    assert host[2] <= upload[1]  # siblings: the upload is not inside the host build
    _, again = _traced(eng.artifact)  # a cached version builds nothing
    assert again == []


def test_a_fused_plan_opens_one_block_per_fused_block_and_closes_it_before_yielding():
    eng = _engine()
    planner = MigrationPlanner(eng)
    ids = _ids(900, seed=3)
    v0 = eng.cluster.version
    eng.artifact()
    eng.cluster.add_node(len(CAPS), 1.0)
    v1 = eng.cluster.version
    eng.artifact()
    chunks = [ids[i : i + 128] for i in range(0, 900, 128)]  # 7 of 128, 1 of 4

    def consume():
        from torch.autograd.profiler import record_function

        for _ in planner.plan_replicas_stream(chunks, v0, v1, 3, fuse=4):
            with record_function("test.consumer"):
                pass

    _, ranges = _traced(consume)
    blocks = [r for r in ranges if r[0] == "planner.block"]
    aligns = [r for r in ranges if r[0] == "ops.align_replica_sets"]
    consumers = [r for r in ranges if r[0] == "test.consumer"]
    # 4 + 3 chunks of 128, then the last in its own bucket
    assert len(blocks) == len(aligns) == 3 and len(consumers) == 8
    assert all(_inside(a, b) for a, b in zip(aligns, blocks))
    assert not any(_inside(c, b) for c in consumers for b in blocks)
    assert [r[0] for r in ranges] == (["planner.block", "ops.align_replica_sets"]
                                      + ["test.consumer"] * 4
                                      + ["planner.block", "ops.align_replica_sets"]
                                      + ["test.consumer"] * 3
                                      + ["planner.block", "ops.align_replica_sets",
                                         "test.consumer"])


@pytest.mark.parametrize("algorithm", BASELINES)
def test_a_baseline_table_build_opens_its_ring_spans_inside_build_artifact(algorithm):
    eng = _engine(algorithm)
    _, ranges = _traced(eng.artifact)
    names = ["engine.build_artifact"] + (["engine.ring_host"] if algorithm == "ch" else []) \
        + ["engine.ring_upload"]
    assert [r[0] for r in ranges] == names
    build, *inner = ranges
    assert all(_inside(r, build) for r in inner)
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))  # siblings, in order
    _, again = _traced(eng.artifact)
    assert again == []


@pytest.mark.parametrize("algorithm", BASELINES)
def test_a_baseline_fanout_opens_its_span_once_per_call(algorithm):
    eng = _engine(algorithm)
    eng.artifact()
    ids = _ids()
    _, ranges = _traced(lambda: [eng.place_replica_nodes_device(ids, 3) for _ in range(2)])
    assert [r[0] for r in ranges] == ["engine.baseline_replicas"] * 2
    _, asura = _traced(lambda: _engine().place_replica_nodes_device(ids, 3))
    assert "engine.baseline_replicas" not in [r[0] for r in asura]


# -- the same results with the profiler on and off ------------------------------


def _serve_run(kind):
    d = _driver()
    if kind == "route_batch":
        outs = [d.route_batch(_ids(300, seed=s)) for s in range(3)]
    else:
        outs = [d.step() for _ in range(3)]
    return outs + [d.counts, d.queue, d.qhist, torch.tensor(d._step)]


def _plan_run():
    eng = _engine()
    planner = MigrationPlanner(eng)
    ids = _ids(1000, seed=4)
    v0 = eng.cluster.version
    eng.artifact()
    eng.cluster.remove_node(2)
    v1 = eng.cluster.version
    art = eng.artifact()
    chunks = [ids[i : i + 128] for i in range(0, 1000, 128)]
    outs = [t for tup in planner.plan_replicas_stream(chunks, v0, v1, 3, fuse=4) for t in tup]
    return outs + [art.len32_dev, art.node_of_dev, art.cum_hi_dev, art.cum_lo_dev]


def _ring_run():
    eng = _engine("ch")
    art = eng.artifact()
    outs = [eng.place_replica_nodes_device(_ids(300, seed=s), 3) for s in range(3)]
    return outs + [art.keys_dev, art.vals_dev]


@pytest.mark.parametrize("kind", ["route_batch", "step", "plan", "ring"])
def test_outputs_and_state_are_bit_equal_with_the_profiler_on_and_off(kind):
    runs = {"plan": _plan_run, "ring": _ring_run}
    run = runs.get(kind, lambda: _serve_run(kind))
    off = run()
    on, ranges = _traced(run)
    assert ranges
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- off: nothing but a flag check ----------------------------------------------


def test_with_no_profiler_and_no_ledger_a_span_calls_no_record_function(monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) called with no profiler running")

    monkeypatch.setattr(obs_trace._profiler, "record_function", refuse)
    ledger = get_ledger()
    before = len(ledger.events())
    assert maybe_span(None, "serve.words") is maybe_span(None, "planner.block")
    d = _driver()
    steps = len(d.ledger.events())
    d.route_batch(_ids())
    d.step()
    eng = d.engine
    v0 = eng.cluster.version
    eng.cluster.add_node(len(CAPS), 1.0)
    eng.artifact()
    planner = MigrationPlanner(eng)
    ids = _ids(512, seed=5)
    for _ in planner.plan_replicas_stream([ids[:256], ids[256:]], v0, eng.cluster.version, 3,
                                          fuse=2):
        pass
    assert len(ledger.events()) == before
    assert len(d.ledger.events()) == steps


@pytest.mark.parametrize("algorithm", BASELINES)
def test_with_no_profiler_a_baseline_engine_calls_no_record_function(monkeypatch, algorithm):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) called with no profiler running")

    monkeypatch.setattr(obs_trace._profiler, "record_function", refuse)
    eng = _engine(algorithm)
    eng.place_replica_nodes_device(_ids(), 3)
    eng.cluster.add_node(len(CAPS), 1.0)
    eng.place_replica_nodes_device(_ids(), 3)
    assert eng.uploads == 2


@pytest.mark.gpu
@pytest.mark.parametrize("profiled", [False, True], ids=["off", "profiled"])
def test_on_the_card_the_fanout_span_adds_no_launch_and_no_sync(profiled):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    import contextlib

    from repro_torch.kernels import LAUNCHES

    dev = torch.device("cuda")
    eng = PlacementEngine(make_cluster(CAPS, device=dev), device=dev, algorithm="ch")
    ids = _ids(1 << 16).to(dev)
    eng.place_replica_nodes_device(ids, 3)
    torch.cuda.synchronize()
    before = LAUNCHES["baseline_replicas"]
    ctx = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled \
        else contextlib.nullcontext()
    with ctx:
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                eng.place_replica_nodes_device(ids, 3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert LAUNCHES["baseline_replicas"] == before + 3


# -- the ledger's events keep their shape ----------------------------------------


@pytest.mark.parametrize("profiled", [False, True], ids=["off", "profiled"])
@pytest.mark.parametrize("form", ["ledger.span", "maybe_span"])
def test_ledger_span_events_keep_their_shape(form, profiled):
    ticks = iter(range(100))
    led = TraceLedger(clock=lambda: float(next(ticks)))
    span = led.span if form == "ledger.span" else (lambda *a, **k: maybe_span(led, *a, **k))

    def body():
        with span("checkpoint.save", step=3):
            torch.ones(4).add_(1)

    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            body()
        assert [e.name for e in prof.events()].count("checkpoint.save") == 1
    else:
        body()
    # the clock read at the start, at the end (dur_s) and for the event's ts
    assert led.events() == [
        {"ts": 2.0, "kind": "span", "name": "checkpoint.save", "dur_s": 1.0, "step": 3}]


def test_a_ledger_span_under_the_profiler_is_also_a_range():
    led = TraceLedger()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with led.span("engine.build_artifact", version=1):
            torch.ones(4).add_(1)
    names = [e.name for e in prof.events()]
    assert names.count("engine.build_artifact") == 1
    (ev,) = led.events("span")
    assert sorted(ev) == ["dur_s", "kind", "name", "ts", "version"]


# -- the engine's counters ---------------------------------------------------


def test_the_engine_counts_uploads_and_not_cache_hits():
    eng = _engine()
    for _ in range(5):
        eng.artifact()
    assert eng.ledger.counters == {"engine.uploads": 1}
