"""The ADDITION-NUMBER prefilter of the port's live add windows against the
reference, on the CPU.

``ReplicaRouter.begin_scale_migration`` and
``AsuraCheckpointStore.begin_add_node`` plan an add-only event with
``max_new_seg``, so only ids whose ADDITION NUMBER is at or below the
largest new segment (or unknown, -1) pay the two-version diff.  Each case
runs the same cluster, ids and event through both packages and holds the
plan field for field and the planner's ``planner.prefilter_scanned`` /
``planner.prefilter_kept`` counters, in a ledger and in a metrics
registry, to the reference's.  Both engine backends are compared with
their reference counterparts: the port's ``device`` backend (the trace's
twin, -1 for an unknown lane) with the reference's ``ref`` (its jnp
trace), and ``numpy`` (the exact host trace) with ``numpy``.  A removal,
and an add with a removal, prefilter in neither package.
"""

import numpy as np
import pytest

import repro.migrate as jmigrate
from repro.checkpoint import AsuraCheckpointStore as JStore
from repro.obs import MetricsRegistry as JMetrics
from repro.obs import TraceLedger as JLedger
from repro.serve import Router as JaxRouter
from repro_torch import migrate as tmigrate
from repro_torch.checkpoint import AsuraCheckpointStore
from repro_torch.core import PlacementEngine
from repro_torch.obs import MetricsRegistry, TraceLedger
from repro_torch.serve import Router

PLAN_FIELDS = ("ids", "src", "dst", "index", "slot", "src_slot")
BACKENDS = {"device": "ref", "numpy": "numpy"}  # port backend -> the reference's
COUNTERS = ("planner.prefilter_scanned", "planner.prefilter_kept")


def _ids(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


def _backends(ref_owner, port_owner, backend):
    """Give both owners (a router or a store) engines of matching backends."""
    ref_owner.engine._backend = BACKENDS[backend]
    if backend != "device":
        engine = PlacementEngine(port_owner.cluster, device="cpu", backend=backend)
        port_owner.cluster._engine = port_owner.engine = engine


@pytest.fixture
def observed(monkeypatch):
    """Every planner either package builds records into a ledger and a
    metrics registry of its own package -> {"ref": [...], "port": [...]}
    of (ledger, metrics) pairs."""
    seen = {"ref": [], "port": []}

    def observe(module, key, ledger_cls, metrics_cls):
        base = module.MigrationPlanner

        class Observed(base):
            def __init__(self, engine, *, ledger=None, metrics=None):
                ledger = ledger_cls() if ledger is None else ledger
                metrics = metrics_cls() if metrics is None else metrics
                super().__init__(engine, ledger=ledger, metrics=metrics)
                seen[key].append((ledger, metrics))

        monkeypatch.setattr(module, "MigrationPlanner", Observed)

    observe(jmigrate, "ref", JLedger, JMetrics)
    observe(tmigrate, "port", TraceLedger, lambda: MetricsRegistry(device="cpu"))
    return seen


def _counters(pairs):
    """The prefilter counters of one planner, from its ledger and from its
    metrics snapshot (0 where nothing was counted)."""
    (ledger, metrics), = pairs
    snap = metrics.snapshot()
    return ({k: int(ledger.counter(k)) for k in COUNTERS},
            {k: int(snap.get(k, 0)) for k in COUNTERS})


def _same_plan(got, want):
    assert (got.v_from, got.v_to, got.n_scanned, got.n_replicas) == (
        want.v_from, want.v_to, want.n_scanned, want.n_replicas)
    for f in PLAN_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("event", ["add", "remove", "both"])
@pytest.mark.parametrize("R", [1, 3])
def test_scale_window_prefilter_matches_reference(observed, R, event, backend):
    caps = {i: 0.75 + 0.125 * (i % 5) for i in range(12)}
    jr, tr = JaxRouter(caps), Router(caps, device="cpu")
    _backends(jr, tr, backend)
    sessions = _ids(12_000, seed=30 + R)
    kw = dict(n_replicas=R, egress={n: 50 for n in range(13)})
    if event in ("add", "both"):
        kw["add"] = (12, 1.0)
    if event in ("remove", "both"):
        kw["remove"] = 4
    jm, tm = jr.begin_scale_migration(sessions, **kw), tr.begin_scale_migration(sessions, **kw)
    _same_plan(tm.state.plan, jm.state.plan)
    assert tm.state.plan.n_moves > 0
    (want, want_metrics), (got, got_metrics) = _counters(observed["ref"]), _counters(observed["port"])
    assert got == want and got_metrics == want_metrics == want
    if event == "add":
        assert got["planner.prefilter_scanned"] == len(sessions)
        assert 0 < got["planner.prefilter_kept"] < len(sessions)
        # an add moves rows onto the new replica only
        assert (tm.state.plan.dst == 12).all()
    else:
        assert got == dict.fromkeys(COUNTERS, 0)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_store_add_prefilter_counters_match_reference(backend):
    """``begin_add_node`` with a ledger: the same per-slot plan and the same
    prefilter counters as the reference store's."""
    caps = {i: 1.0 + 0.25 * (i % 3) for i in range(7)}
    js, ts = JStore(caps, n_replicas=3), AsuraCheckpointStore(caps, n_replicas=3, device="cpu")
    _backends(js, ts, backend)
    keys = _ids(3000, seed=40)
    blobs = [bytes([i % 251]) * 8 for i in range(len(keys))]
    js.put_chunks(keys, blobs)
    ts.put_chunks(keys, blobs)
    jl, tl = JLedger(), TraceLedger()
    jm, tm = js.begin_add_node(7, 1.5, ledger=jl), ts.begin_add_node(7, 1.5, ledger=tl)
    for f in ("ids", "src", "dst", "slot", "src_slot"):
        assert np.array_equal(getattr(tm.live.state.plan, f), getattr(jm.live.state.plan, f))
    got = {k: int(tl.counter(k)) for k in COUNTERS}
    assert got == {k: int(jl.counter(k)) for k in COUNTERS}
    assert got["planner.prefilter_scanned"] == len(set(keys.tolist()))
    assert 0 < got["planner.prefilter_kept"] < got["planner.prefilter_scanned"]
