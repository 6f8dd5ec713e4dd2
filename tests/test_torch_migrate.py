"""The port's migration stack against the reference, bit for bit, on the CPU.

Inputs come from a numpy seed; each reference cluster crosses over through
``convert.cluster_from_reference_json``, so both sides hold the same
segment table, free-number heap and version.  The port runs on
``device="cpu"`` (its wrappers take the plain-torch twins there; the twins
are held to the reference's Pallas kernels in ``test_torch_kernels.py``
and the CUDA kernels to the twins on the card in ``test_torch_gpu.py``).
Covered: the section 2.D host oracles, the engine's version-pinned
surface, the planner (``plan``, ``plan_replicas``, the prefilter,
``plan_stream`` / ``plan_replicas_stream`` with ``fuse`` 1 and 4), the
throttled mover (``round``, ``round_block``, ``pump``) and the
dual-version read rule mid-drain and through a rollback.  Exact equality
everywhere: the whole stack is integer math.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from repro.core import PlacementEngine as JaxEngine
from repro.core import asura as jasura
from repro.core import make_cluster
from repro.migrate import MigrationPlanner as JaxPlanner
from repro.migrate import MigrationState as JaxState
from repro.migrate import ThrottledMover as JaxMover
from repro.serve import Router as JaxRouter
from repro_torch.convert import cluster_from_reference_json
from repro_torch.core import PlacementEngine
from repro_torch.core import asura as tasura
from repro_torch.core.engine import CACHE_VERSIONS
from repro_torch.launch.placement_mesh import make_data_mesh
from repro_torch.migrate import (
    LiveMigration,
    MigrationPlan,
    MigrationPlanner,
    MigrationState,
    ThrottledMover,
)
from repro_torch.migrate.mover import _group_ranks
from repro_torch.migrate.planner import pad_pow2
from repro_torch.serve import Router

PLAN_FIELDS = ("ids", "src", "dst", "index", "slot", "src_slot")
BACKENDS = ("device", "numpy")  # port backends; the reference runs "ref" / "numpy"


def _caps(n, seed=0):
    return np.random.default_rng(seed).uniform(0.5, 1.6, n)


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


def _pair(caps, backend="device"):
    """(jax cluster, jax engine, port cluster, port engine), equal tables,
    the current version pinned in both LRUs."""
    jc = make_cluster(caps)
    tc = cluster_from_reference_json(jc.to_json(), device="cpu")
    je = JaxEngine(jc, backend="numpy" if backend == "numpy" else "ref")
    te = PlacementEngine(tc, device="cpu", backend=backend)
    je.artifact()
    te.artifact()
    return jc, je, tc, te


def _apply(event, *clusters):
    """Apply one membership event to every cluster -> the new segments of
    the (last) add, or None."""
    new = None
    for c in clusters:
        if event in ("remove", "both"):
            c.remove_node(3)
        if event in ("add", "both"):
            new = c.add_node(max(c.nodes) + 1, 1.3)
    return new


def _same_plan(a, b):
    assert (a.v_from, a.v_to, a.n_scanned, a.n_replicas) == (
        b.v_from, b.v_to, b.n_scanned, b.n_replicas)
    for f in PLAN_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# section 2.D host oracles
# ---------------------------------------------------------------------------


def _holed_cluster():
    c = make_cluster(_caps(10, seed=4))
    c.remove_node(4)
    c.add_node(20, 0.4)
    return c.seg_lengths(), c.seg_to_node()


@pytest.mark.parametrize("R", [1, 3])
def test_trace_oracles_match_reference(R):
    lengths, nodes = _holed_cluster()
    for i in _ids(40, seed=R).tolist():
        assert tasura.placement_trace(i, lengths, nodes, R) == jasura.placement_trace(
            i, lengths, nodes, R)
        assert tasura.addition_number(i, lengths, nodes, R) == jasura.addition_number(
            i, lengths, nodes, R)
        assert tasura.remove_numbers(i, lengths, nodes, R) == jasura.remove_numbers(
            i, lengths, nodes, R)


@pytest.mark.parametrize("R", [1, 2, 3])
def test_batch_oracles_match_reference(R):
    lengths, nodes = _holed_cluster()
    ids = _ids(3000, seed=R)
    assert np.array_equal(
        tasura.addition_numbers_batch(ids, lengths, nodes, R),
        jasura.addition_numbers_batch(ids, lengths, nodes, R))
    assert np.array_equal(
        tasura.remove_numbers_batch(ids, lengths, nodes, R),
        jasura.remove_numbers_batch(ids, lengths, nodes, R))
    assert np.array_equal(tasura.place_batch(ids, lengths), jasura.place_batch(ids, lengths))


# ---------------------------------------------------------------------------
# the engine's version-pinned surface
# ---------------------------------------------------------------------------


def test_artifact_for_evicted_version_raises():
    _, _, tc, te = _pair(_caps(8))
    v0 = tc.version
    uploads = te.uploads
    for k in range(CACHE_VERSIONS):
        tc.add_node(100 + k, 1.0)
        te.artifact()
    with pytest.raises(KeyError, match=f"version {v0} not cached"):
        te.artifact_for(v0)
    with pytest.raises(KeyError):
        te.place_nodes_at(_ids(10), v0)
    assert te.uploads == uploads + CACHE_VERSIONS  # v0 was not rebuilt


@pytest.mark.parametrize("backend", BACKENDS)
def test_place_at_matches_historic_placement(backend):
    jc, je, tc, te = _pair(_caps(12, seed=1), backend)
    ids = _ids(4000, seed=2)
    v0 = tc.version
    nodes0, reps0 = te.place_nodes(ids), te.place_replica_nodes(ids, 3)
    segs0 = te.place(ids)
    _apply("both", jc, tc)
    assert np.array_equal(te.place_at(ids, v0), segs0)
    assert np.array_equal(te.place_nodes_at(ids, v0), nodes0)
    assert np.array_equal(te.place_replica_nodes_at(ids, v0, 3), reps0)
    assert np.array_equal(te.place_nodes_at(ids, v0), je.place_nodes_at(ids, v0))
    assert np.array_equal(te.place_nodes_device_at(torch.from_numpy(ids), v0).numpy(), nodes0)
    assert np.array_equal(te.place_device_at(torch.from_numpy(ids), v0).numpy(), segs0)
    assert np.array_equal(
        te.place_replica_nodes_device_at(torch.from_numpy(ids), v0, 3).numpy(), reps0)
    assert np.array_equal(te.remove_numbers_batch(ids, 3, version=v0),
                          je.remove_numbers_batch(ids, 3, version=v0))
    assert te.uploads == 1  # every *_at call served v0 from the LRU


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("event", ["add", "remove", "both"])
def test_engine_diffs_match_reference(backend, event):
    jc, je, tc, te = _pair(_caps(12, seed=3), backend)
    v0 = tc.version
    _apply(event, jc, tc)
    v1 = tc.version
    ids = _ids(6000, seed=5)
    for got, want in zip(te.diff_nodes_device(torch.from_numpy(ids), v0, v1),
                         je.diff_nodes_device(ids, v0, v1)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(te.diff_replicas_device(torch.from_numpy(ids), v0, v1, 3),
                         je.diff_replicas_device(ids, v0, v1, 3)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(te.diff_replicas_at(ids, v0, v1, 3),
                         je.diff_replicas_at(ids, v0, v1, 3)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("R", [1, 3])
def test_addition_numbers_device_matches_reference(R):
    jc, je, tc, te = _pair(_caps(16, seed=R))
    ids = _ids(5000, seed=R)
    got = te.addition_numbers_device(torch.from_numpy(ids), n_replicas=R)
    want = np.asarray(je.addition_numbers_device(jnp.asarray(ids), n_replicas=R))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # exact where known: the host batch oracle agrees on every known lane
    art = te.artifact()
    host = tasura.addition_numbers_batch(ids, tc.seg_lengths(), art.node_of, R)
    known = want >= 0
    assert known.mean() > 0.9
    assert np.array_equal(want[known], host[known])


def test_hierarchical_refusals_match_reference():
    """What the reference still refuses in the two-level mode, the port
    refuses too: a live scale window on a hierarchical router
    (``NotImplementedError``) and the ADDITION-NUMBER prefilter on a
    hierarchical engine (``ValueError``)."""
    topo = {d: {10 * d + i: 1.0 for i in range(3)} for d in range(4)}
    ids = _ids(64)
    for router in (JaxRouter(topo), Router(topo, device="cpu")):
        with pytest.raises(NotImplementedError, match="flat-router only"):
            router.begin_scale_migration(ids, add=(0, 99, 1.0), n_replicas=3)
    for make_planner, router in ((JaxPlanner, JaxRouter(topo)),
                                 (MigrationPlanner, Router(topo, device="cpu"))):
        router.engine.hier_artifact()
        v0 = router.cluster.version
        router.cluster.add_node(1, 99, 1.0)
        with pytest.raises(ValueError, match="flat-table semantics"):
            make_planner(router.engine).plan_replicas(
                ids, v0, router.cluster.version, 3, max_new_seg=12
            )
    # the single-owner plan's prefilter reads the flat table: refused
    with pytest.raises(ValueError, match="HierarchicalCluster"):
        MigrationPlanner(router.engine).plan(ids, v0, router.cluster.version, max_new_seg=12)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("event", ["add", "remove", "both"])
def test_plan_matches_reference(backend, event):
    jc, je, tc, te = _pair(_caps(16, seed=6), backend)
    v0 = tc.version
    _apply(event, jc, tc)
    ids = _ids(20_000, seed=7)
    want = JaxPlanner(je).plan(ids, v0, jc.version, chunk=6000)
    got = MigrationPlanner(te).plan(ids, v0, tc.version, chunk=6000)
    _same_plan(got, want)
    assert got.n_moves > 0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("R", [2, 3])
def test_plan_replicas_matches_reference(backend, R):
    jc, je, tc, te = _pair(_caps(16, seed=8), backend)
    v0 = tc.version
    _apply("both", jc, tc)
    ids = _ids(15_000, seed=9)
    want = JaxPlanner(je).plan_replicas(ids, v0, jc.version, R, chunk=4096)
    got = MigrationPlanner(te).plan_replicas(ids, v0, tc.version, R, chunk=4096)
    _same_plan(got, want)
    assert got.n_moves > 0 and (got.slot > 0).any()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("R", [1, 3])
def test_prefiltered_plan_matches_reference(backend, R):
    """The ADDITION-NUMBER prefilter keeps the plan unchanged and equal to
    the reference's, and counts what it scanned and kept."""
    from repro_torch.obs import MetricsRegistry, TraceLedger

    jc, je, tc, te = _pair(_caps(16, seed=10), backend)
    v0 = tc.version
    new = _apply("add", jc, tc)
    ids = _ids(20_000, seed=11)
    ledger, metrics = TraceLedger(), MetricsRegistry(device="cpu")
    planner = MigrationPlanner(te, ledger=ledger, metrics=metrics)
    jp = JaxPlanner(je)
    if R == 1:
        got = planner.plan(ids, v0, tc.version, max_new_seg=max(new))
        want = jp.plan(ids, v0, jc.version, max_new_seg=max(new))
        full = planner.plan(ids, v0, tc.version)
    else:
        got = planner.plan_replicas(ids, v0, tc.version, R, max_new_seg=max(new))
        want = jp.plan_replicas(ids, v0, jc.version, R, max_new_seg=max(new))
        full = planner.plan_replicas(ids, v0, tc.version, R)
    _same_plan(got, want)
    _same_plan(got, full)
    scanned = ledger.counter("planner.prefilter_scanned")
    kept = ledger.counter("planner.prefilter_kept")
    assert scanned == len(ids) and 0 < kept < scanned
    assert metrics.snapshot()["planner.prefilter_kept"] == kept
    assert (got.dst == max(tc.nodes)).all()  # an add moves rows to the new node only


def _stream(planner, ids, v0, v1, R, fuse, chunk):
    chunks = planner.chunked(ids, chunk)
    if R:
        it = planner.plan_replicas_stream(chunks, v0, v1, R, fuse=fuse)
    else:
        it = planner.plan_stream(chunks, v0, v1, fuse=fuse)
    return [tuple(np.asarray(x) for x in part) for part in it]


@pytest.mark.parametrize("R", [None, 3])
@pytest.mark.parametrize("fuse", [1, 4])
def test_plan_stream_matches_reference(fuse, R):
    """Per-chunk device tuples equal the reference's stream (fuse 1), for
    host and device chunks, with a ragged pow2-padded tail whose pad lanes
    never move."""
    jc, je, tc, te = _pair(_caps(16, seed=12))
    v0 = tc.version
    _apply("both", jc, tc)
    ids = _ids(9 * 1024 + 300, seed=13)
    want = _stream(JaxPlanner(je), ids, v0, jc.version, R, 1, 1024)
    planner = MigrationPlanner(te)
    for feed in (ids, torch.from_numpy(ids)):
        got = _stream(planner, feed, v0, tc.version, R, fuse, 1024)
        assert len(got) == len(want) == 10
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert np.array_equal(a, b)
    tail_moved = got[-1][1]
    assert tail_moved.shape[0] == 512 and not tail_moved[300:].any()


def test_plan_stream_fuse_launches_one_diff_per_block(monkeypatch):
    _, _, tc, te = _pair(_caps(10))
    v0 = tc.version
    tc.add_node(50, 1.0)
    planner = MigrationPlanner(te)
    calls = []
    real = te.diff_nodes_device
    monkeypatch.setattr(te, "diff_nodes_device",
                        lambda ids, a, b: calls.append(len(ids)) or real(ids, a, b))
    ids = torch.from_numpy(_ids(10 * 512 + 100))
    parts = list(planner.plan_stream(planner.chunked(ids, 512), v0, tc.version, fuse=4))
    assert len(parts) == 11
    assert calls == [2048, 2048, 1024, 128]  # 4 + 4 + 2 full chunks, then the tail


def test_pad_pow2_and_mesh(tmp_path):
    x = np.arange(5, dtype=np.uint32)
    p, n = pad_pow2(x)
    assert n == 5 and p.tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    t = torch.arange(8, dtype=torch.int64)
    assert pad_pow2(t)[0] is t
    pt, _ = pad_pow2(torch.from_numpy(x))
    assert pt.dtype == torch.uint32 and pt.numpy().tolist() == p.tolist()
    _, _, tc, te = _pair(_caps(4))
    v0 = tc.version
    tc.add_node(4, 1.0)
    planner = MigrationPlanner(te)
    with pytest.raises(ValueError, match="must be 1-D"):
        planner.plan(x, v0, tc.version, mesh=object())
    # a world-size-1 mesh plans as one card does
    ids = _ids(1000)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        mesh = make_data_mesh(device_type="cpu")
        for got, want in ((planner.plan(ids, v0, tc.version, mesh=mesh),
                           planner.plan(ids, v0, tc.version)),
                          (planner.plan_replicas(ids, v0, tc.version, 3, mesh=mesh),
                           planner.plan_replicas(ids, v0, tc.version, 3))):
            assert got.n_moves > 0
            for f in PLAN_FIELDS:
                assert np.array_equal(getattr(got, f), getattr(want, f)), f
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the throttled mover
# ---------------------------------------------------------------------------


def test_group_ranks():
    keys = np.array([7, 3, 7, 7, 2, 3])
    assert _group_ranks(keys).tolist() == [0, 0, 1, 2, 0, 1]
    assert _group_ranks(np.zeros(0, np.int64)).tolist() == []


def _plans(R):
    """(jax plan, port plan) of one add + remove event, R-way."""
    jc, je, tc, te = _pair(_caps(12, seed=14))
    v0 = tc.version
    _apply("both", jc, tc)
    ids = _ids(12_000, seed=15)
    want = JaxPlanner(je).plan_replicas(ids, v0, jc.version, R)
    got = MigrationPlanner(te).plan_replicas(ids, v0, tc.version, R)
    _same_plan(got, want)
    return want, got


BUDGETS = [
    dict(egress=40),
    dict(ingress=35),
    dict(egress={0: 5, 1: 50, 2: 7}, ingress=60),
    dict(),
]


@pytest.mark.parametrize("budget", range(len(BUDGETS)))
@pytest.mark.parametrize("R", [1, 3])
def test_mover_rounds_match_reference(budget, R):
    """Per-round matrices of ``round()`` and of ``round_block(k)`` equal the
    reference mover's under the same egress / ingress budgets, and every
    round respects both budgets."""
    jplan, tplan = _plans(R)
    kw = BUDGETS[budget]
    jm = JaxMover(JaxState(jplan), **kw)
    host = ThrottledMover(MigrationState(tplan, device="cpu"), **kw)
    block = ThrottledMover(MigrationState(tplan, device="cpu"), **kw)
    rounds = 0
    while not jm.done:
        want = jm.round()
        assert host.round() == want
        rounds += 1
        cap = kw.get("egress")
        if isinstance(cap, int):
            for (s, _d), c in want.items():
                assert sum(v for (s2, _), v in want.items() if s2 == s) <= cap
    assert host.done and rounds == len(jm.history)
    while not block.done:
        block.round_block(3)
    assert block.history[:rounds] == jm.history
    assert all(m == {} for m in block.history[rounds:])
    assert block.movement_matrix() == jm.movement_matrix() == host.movement_matrix()
    assert np.array_equal(block.state.landed, host.state.landed)


def test_mover_round_block_matches_reference_block():
    jplan, tplan = _plans(3)
    jm = JaxMover(JaxState(jplan), egress=30, ingress=45)
    tm = ThrottledMover(MigrationState(tplan, device="cpu"), egress=30, ingress=45)
    assert tm.round_block(4) == jm.round_block(4)
    assert tm.round() == jm.round()
    assert np.array_equal(tm.state.landed, jm.state.landed)
    with pytest.raises(ValueError):
        tm.round_block(0)


def test_mover_clock_pacing_matches_reference():
    jplan, tplan = _plans(1)
    t = {"now": 0.0}
    clock = lambda: t["now"]  # noqa: E731
    jm = JaxMover(JaxState(jplan), egress=25, clock=clock, round_seconds=2.0)
    tm = ThrottledMover(MigrationState(tplan, device="cpu"), egress=25, clock=clock,
                        round_seconds=2.0)
    for now in (1.0, 4.5, 5.0, 11.0):
        t["now"] = now
        assert tm.pump() == jm.pump()
    assert tm.round() == jm.round()  # a manual round leaves pacing alone
    t["now"] = 15.0
    assert tm.pump() == jm.pump()
    assert tm.rounds_done == jm.rounds_done


def test_mover_ledger_counts_rounds_rows_and_bytes():
    """A ledger on the mover gets one ``migrate.round`` event per round from
    every verb, with the same counters as the reference mover's."""
    from repro.obs import MetricsRegistry as JaxMetrics
    from repro.obs import TraceLedger as JaxLedger
    from repro_torch.obs import MetricsRegistry, TraceLedger

    jplan, tplan = _plans(3)
    out = []
    for mover_cls, state, ledger, metrics in (
        (JaxMover, JaxState(jplan), JaxLedger(), JaxMetrics()),
        (ThrottledMover, MigrationState(tplan, device="cpu"), TraceLedger(),
         MetricsRegistry(device="cpu")),
    ):
        mover = mover_cls(state, egress=40, ledger=ledger, metrics=metrics, bytes_per_row=64)
        mover.round()
        mover.round_block(2)
        mover.run()
        names = ("migrate.rounds", "migrate.rows_moved", "migrate.bytes_moved")
        out.append(([ledger.counter(n) for n in names],
                    metrics.snapshot()["migrate.bytes_moved"], mover.rounds_done))
    assert out[0] == out[1]
    counters, metric_bytes, rounds = out[1]
    assert counters == [rounds, tplan.n_moves, 64 * tplan.n_moves] and metric_bytes == counters[2]


def test_pending_views_guard_the_sentinel_id():
    """0xFFFFFFFF pads the sorted device views and is itself a valid id:
    the ``pos < n`` guard keeps a padded view from reporting it pending."""
    ids = np.array([5, 2**32 - 1, 9, 7], dtype=np.uint32)
    plan = MigrationPlan(
        v_from=0, v_to=1, ids=ids, src=np.array([1, 2, 3, 1]),
        dst=np.array([4, 4, 4, 4]), index=np.arange(4), n_scanned=4,
    )
    state = MigrationState(plan, device="cpu")
    state.mark_landed(np.array([1, 3]))  # the sentinel id has landed
    sorted_pad, n = state.pending_device()
    assert n == 2 and sorted_pad.tolist() == [5, 9]
    state.mark_landed(np.array([0]))
    sorted_pad, n = state.pending_device()
    assert n == 1 and sorted_pad.tolist() == [9]
    from repro_torch.migrate.live import _member

    q = torch.tensor([2**32 - 1, 9, 5, 0], dtype=torch.int64)
    hit, _ = _member(q, sorted_pad, n)
    assert hit.tolist() == [False, True, False, False]
    assert state.is_pending(q.numpy()).tolist() == hit.tolist()
    state.mark_landed(np.array([2]))
    sorted_pad, n = state.pending_device()
    assert n == 0 and sorted_pad.tolist() == [2**32 - 1]
    assert not _member(q, sorted_pad, n)[0].any()


# ---------------------------------------------------------------------------
# the dual-version read rule and rollback
# ---------------------------------------------------------------------------


def _windows(R, add=True):
    caps = {i: 1.0 for i in range(8)}
    jr, tr = JaxRouter(caps), Router(caps, device="cpu")
    sessions = _ids(15_000, seed=16)
    kw = dict(n_replicas=R, egress={n: 40 for n in range(9)})
    if add:
        kw["add"] = (8, 1.0)
    else:
        kw["remove"] = 2
    return jr, tr, jr.begin_scale_migration(sessions, **kw), tr.begin_scale_migration(sessions, **kw)


def _same_routes(jm, tm, ids, R):
    assert np.array_equal(tm.route(ids), jm.route(ids))
    assert np.array_equal(tm.route_device(torch.from_numpy(ids)).numpy(),
                          np.asarray(jm.route_device(jnp.asarray(ids))))
    if R > 1:
        want = jm.route_replicas(ids)
        assert np.array_equal(tm.route_replicas(ids), want)
        got = tm.route_replicas_device(torch.from_numpy(ids)).numpy()
        assert np.array_equal(got, np.asarray(jm.route_replicas_device(jnp.asarray(ids))))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("add", [True, False])
@pytest.mark.parametrize("R", [1, 3])
def test_window_read_rule_and_rollback_match_reference(R, add):
    """Mid-drain, ``route``, ``route_device``, ``route_replicas`` and
    ``route_replicas_device`` equal the reference's window at every round;
    a half-drained rollback gives the same reverse plan and routes."""
    jr, tr, jm, tm = _windows(R, add)
    _same_plan(tm.state.plan, jm.state.plan)
    ids = np.concatenate([tm.state.plan.ids[:500], _ids(2000, seed=17)])
    half = tm.state.plan.n_moves // 2
    _same_routes(jm, tm, ids, R)
    while tm.state.n_pending > half:
        assert tm.round() == jm.round()
        _same_routes(jm, tm, ids, R)
    assert not tm.done
    uploads = tr.engine.uploads
    jrev, trev = jm.rollback(), tm.rollback()
    with pytest.raises(RuntimeError, match="rolled back"):
        tm.round()
    with pytest.raises(RuntimeError, match="rolled back"):
        tm.route_device(ids)
    _same_plan(trev.state.plan, jrev.state.plan)
    assert trev.mover.egress == tm.mover.ingress and trev.mover.ingress == tm.mover.egress
    _same_routes(jrev, trev, ids, R)
    assert trev.round_block(2) == jrev.round_block(2)
    while not trev.done:
        assert trev.round() == jrev.round()
    _same_routes(jrev, trev, ids, R)
    assert tr.engine.uploads == uploads  # the flap re-uploaded nothing


def test_router_scale_events_match_reference():
    caps = {i: c for i, c in enumerate(_caps(10, seed=18))}
    jr, tr = JaxRouter(caps), Router(caps, device="cpu")
    sessions = _ids(8000, seed=19)
    for kw in (dict(add=(10, 1.2)), dict(remove=4), dict(add=(11, 0.5), remove=10)):
        want, got = jr.plan_scale_event(sessions, **kw), tr.plan_scale_event(sessions, **kw)
        assert got.moved_sessions == want.moved_sessions and got.n_reprefills > 0
    assert np.array_equal(tr.route(sessions), jr.route(sessions))


def test_window_guards():
    """One window at a time; a window whose v table was evicted raises
    instead of re-deriving it; the router's migrating routes are the
    window's."""
    caps = {i: 1.0 for i in range(8)}
    tr = Router(caps, device="cpu")
    sessions = _ids(6000, seed=20)
    mig = tr.begin_scale_migration(sessions, add=(8, 1.0), n_replicas=2, egress=30)
    with pytest.raises(RuntimeError, match="already in flight"):
        tr.begin_scale_migration(sessions, add=(9, 1.0))
    assert np.array_equal(tr.route_migrating(sessions, mig), mig.route(sessions))
    assert torch.equal(tr.route_migrating_device(torch.from_numpy(sessions), mig),
                       mig.route_device(sessions))
    assert np.array_equal(tr.route_replicas_migrating(sessions, mig),
                          mig.route_replicas(sessions))
    assert torch.equal(tr.route_replicas_migrating_device(sessions, mig),
                       mig.route_replicas_device(sessions))
    assert isinstance(mig, LiveMigration)
    for k in range(CACHE_VERSIONS):
        tr.cluster.add_node(100 + k, 1.0)
        tr.engine.artifact()
    with pytest.raises(KeyError, match="not cached"):
        mig.route_device(sessions)
    with pytest.raises(KeyError, match="not cached"):
        mig.route_replicas(sessions)


# ---------------------------------------------------------------------------
# the surface the consumers call: moves_dict, known_src / known_before,
# next_round_at, landed_ids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("R", [1, 3])
def test_known_owners_and_moves_dict_match_reference(backend, R):
    """A caller's own v owners give the same plan (the numpy backend skips
    one sweep; the device diff ignores them), and ``moves_dict`` is the
    reference's."""
    jc, je, tc, te = _pair(_caps(12, seed=10), backend)
    ids = _ids(6000, seed=11)
    known = (te.place_replica_nodes(ids, R) if R > 1 else te.place_nodes(ids))
    v0 = tc.version
    _apply("add", jc, tc)
    if R > 1:
        want = JaxPlanner(je).plan_replicas(ids, v0, jc.version, R, known_before=known)
        got = MigrationPlanner(te).plan_replicas(ids, v0, tc.version, R, known_before=known)
        plain = MigrationPlanner(te).plan_replicas(ids, v0, tc.version, R)
    else:
        want = JaxPlanner(je).plan(ids, v0, jc.version, known_src=known)
        got = MigrationPlanner(te).plan(ids, v0, tc.version, known_src=known)
        plain = MigrationPlanner(te).plan(ids, v0, tc.version)
    _same_plan(got, want)
    _same_plan(got, plain)
    assert got.n_moves > 0
    assert got.moves_dict() == want.moves_dict()
    assert len(got.moves_dict()) == len(np.unique(got.ids))


def test_next_round_at_and_landed_ids_match_reference():
    jplan, tplan = _plans(3)
    t = {"now": 10.0}
    clock = lambda: t["now"]  # noqa: E731
    jm = JaxMover(JaxState(jplan), ingress=40, clock=clock, round_seconds=3.0)
    tm = ThrottledMover(MigrationState(tplan, device="cpu"), ingress=40, clock=clock,
                        round_seconds=3.0)
    while not tm.done:
        assert tm.next_round_at == jm.next_round_at
        t["now"] = tm.next_round_at
        assert tm.pump() == jm.pump()
        assert np.array_equal(tm.state.landed_ids(), jm.state.landed_ids())
    assert jm.done and tm.next_round_at is None is jm.next_round_at
    assert np.array_equal(np.sort(tm.state.landed_ids()), np.sort(tplan.ids))
    assert ThrottledMover(MigrationState(tplan, device="cpu")).next_round_at is None


# ids whose trace on the 4096-node table of seed 0 (top level 12) descends
# at every level up to 2**32 at R = 1: no ADDITION NUMBER in the u32 range
NO_AN_IDS = (760428, 1710092, 4293190)


def test_addition_number_past_the_u32_range_is_unknown():
    """Where the range extension runs out of u32 bits the reference raises
    (a negative shift); the port answers -1, "unknown", which every
    prefilter keeps as a candidate.  Everywhere else both agree, and the
    batch's closed-form extension equals the scalar trace."""
    caps = np.random.default_rng(0).uniform(0.5, 2.0, 4096)
    jc = make_cluster(caps)
    lengths, nodes = jc.seg_lengths(), jc.seg_to_node()
    for i in NO_AN_IDS:
        with pytest.raises(ValueError):
            jasura.addition_number(i, lengths, nodes, 1)
        assert tasura.addition_number(i, lengths, nodes, 1) == -1
    ids = np.concatenate([_ids(4000, seed=12), np.asarray(NO_AN_IDS + (624403,), np.uint32)])
    for R in (1, 3):
        batch = tasura.addition_numbers_batch(ids, lengths, nodes, R)
        scalar = [tasura.addition_number(int(i), lengths, nodes, R) for i in ids]
        assert batch.tolist() == scalar
        ok = ~np.isin(ids, NO_AN_IDS) if R == 1 else np.ones(ids.size, bool)
        assert np.array_equal(batch[ok], jasura.addition_numbers_batch(ids[ok], lengths,
                                                                       nodes, R))
    assert (batch < 0).sum() == 0  # R = 3 finds unused numbers in range
    # the coordinator's prefilter keeps the unknown ids: its plan is exact
    from repro_torch.runtime import ElasticCoordinator

    tc = cluster_from_reference_json(jc.to_json(), device="cpu")
    coord = ElasticCoordinator(tc, ids)
    before = coord.owners()
    plan = coord.add_node(5000, 1.0)
    after = tc.place_nodes(ids)
    moved = np.nonzero(before != after)[0]
    assert plan.moves == {int(ids[i]): (int(before[i]), 5000) for i in moved}
