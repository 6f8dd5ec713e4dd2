"""The port's failure-domain-aware (two-level) placement against the
reference, bit for bit, on the CPU.

Inputs come from a numpy seed.  Each reference ``HierarchicalCluster``
crosses over through ``convert.hier_cluster_from_reference_json`` (the
domain-level table is history-dependent, so it travels as data), or is
built by the same membership calls on both sides.  The port runs on
``device="cpu"``, where the wrapper of kernel B8 takes its plain-torch
twin; the twin is held here to the reference's jnp twin, its Pallas
kernel (interpret mode) and the NumPy oracle, and the CUDA kernel to the
twin on the card in ``test_torch_gpu.py``.  Covered: the twin, the
engine's two-level surface and its LRU, churn, the ``_sync_domain``
regression, the oracle's properties, the router, the serving driver and
the planner.  Exact equality everywhere: the whole stack is integer math.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PlacementEngine as JEngine
from repro.core.hierarchy import HierarchicalCluster as JHier
from repro.kernels.hierarchy import hier_place_replicas_pallas
from repro.kernels.hierarchy import hier_place_replicas_ref as j_hier_ref
from repro.migrate import MigrationPlanner as JPlanner
from repro.obs import MetricsRegistry as JMetrics
from repro.serve import RequestStreamDriver as JDriver
from repro.serve import Router as JRouter
from repro_torch import convert
from repro_torch.core import HierarchicalCluster, PlacementEngine
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.hierarchy import hier_place_replicas_cuda
from repro_torch.kernels.hierarchy_ref import hier_place_replicas_ref
from repro_torch.migrate import MigrationPlanner
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import RequestStreamDriver, Router

PLAN_FIELDS = ("ids", "src", "dst", "index", "slot", "src_slot")


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _build(h, domains=5, nodes_per=4, cap=lambda d, i: 1.0 + 0.25 * i + 0.5 * (d % 2)):
    for d in range(domains):
        for i in range(nodes_per):
            h.add_node(d, 100 + d * nodes_per + i, cap(d, i))
    return h


def _ragged(h, seed=3):
    """1 to 128 nodes per domain (so the domains' top levels differ),
    capacities in [0.5, 2.0), non-contiguous domain ids."""
    rng = np.random.default_rng(seed)
    nid = 0
    for d in range(9):
        for _ in range(int(rng.integers(1, 129)) if d else 1):
            h.add_node(3 * d + 1, nid, float(rng.uniform(0.5, 2.0)))
            nid += 1
    return h


def _pair(make=_build, backend="device", **kw):
    """(reference hierarchy, reference engine, port hierarchy, port engine):
    the port's hierarchy crossed over from the reference's blobs."""
    jh = make(JHier(), **kw)
    th = convert.hier_cluster_from_reference_json(
        jh._top.to_json(), {d: c.to_json() for d, c in jh.domains.items()},
        version=jh.version, device="cpu",
    )
    je = JEngine(jh, backend="numpy" if backend == "numpy" else "ref")
    te = PlacementEngine(th, device="cpu", backend=backend)
    return jh, je, th, te


# ---------------------------------------------------------------------------
# the twin of kernel B8
# ---------------------------------------------------------------------------

TWIN_CASES = [
    ("uniform", 1, 128, False),
    ("uniform", 2, 128, False),
    ("uniform", 3, 128, False),
    ("ragged", 3, 128, False),
    ("ragged", 3, 1, True),
    ("uniform", 1, 1, False),
]


@pytest.mark.parametrize("shape,R,max_draws,pallas", TWIN_CASES)
def test_twin_matches_reference_kernels(shape, R, max_draws, pallas):
    """The twin on the reference artifact's own eight tables equals the
    reference's jnp twin (and, on the ragged forced-tail case, its Pallas
    kernel in interpret mode); max_draws=1 forces the per-domain tail on lanes that
    miss their one draw, and leaves level-1 slots unfilled (-1)."""
    jh = (_ragged if shape == "ragged" else _build)(JHier())
    ja = JEngine(jh, backend="ref").hier_artifact()
    art = convert.hier_artifact_from_arrays(
        [np.asarray(t) for t in ja.tables_dev], *ja.statics, device="cpu"
    )
    assert art.statics == ja.statics and art.n_domains == ja.n_domains
    if shape == "ragged":
        tops = np.asarray(ja.tables_dev[6])[: ja.n_domains]
        assert len(set(tops.tolist())) > 2 and ja.max_top == tops.max()
    ids = _ids(4096, seed=R + max_draws)
    kw = dict(top_level=ja.top_level, max_top=ja.max_top, s_log2=1,
              max_draws=max_draws, s_pad=ja.s_pad, n_replicas=R)
    want = np.asarray(j_hier_ref(jnp.asarray(ids), *ja.tables_dev, **kw))
    got = hier_place_replicas_cuda(_t(ids), *art.tables_dev, **kw)
    assert got.dtype == torch.int32 and got.shape == (2, R, 4096)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(hier_place_replicas_ref(_t(ids), *art.tables_dev, **kw).numpy(), want)
    if pallas:
        pal = hier_place_replicas_pallas(jnp.asarray(ids), *ja.tables_dev, interpret=True, **kw)
        assert np.array_equal(np.asarray(pal), want)
    if max_draws == 128:
        assert (want >= 0).all()
    elif R > 1:
        assert (want[0] < 0).any() and (want[0] >= 0).any()


def test_twin_wide_r_and_too_few_domains():
    """R > 8 (the kernel's scratch-row path) on 12 domains against the
    NumPy oracle, and R = D + 1 on 4 domains against the reference's jnp
    twin: the unfilled slots are -1 in both planes."""
    for domains, R in ((12, 9), (4, 5)):
        jh = _build(JHier(), domains=domains, nodes_per=3)
        ja = JEngine(jh, backend="ref").hier_artifact()
        tabs = tuple(_t(np.asarray(t)) for t in ja.tables_dev)
        ids = _ids(2048, seed=domains)
        kw = dict(top_level=ja.top_level, max_top=ja.max_top, s_log2=1,
                  max_draws=128, s_pad=ja.s_pad, n_replicas=R)
        got = hier_place_replicas_cuda(_t(ids), *tabs, **kw).numpy()
        if R <= domains:
            assert np.array_equal(got.transpose(2, 1, 0), jh.place_replicas(ids, R))
        else:
            want = np.asarray(j_hier_ref(jnp.asarray(ids), *ja.tables_dev, **kw))
            assert np.array_equal(got, want)
            assert (got[:, domains:] == -1).all() and (got[:, :domains] >= 0).all()


def test_wrapper_checks_and_launches_nothing_on_cpu():
    jh = _build(JHier())
    ja = JEngine(jh, backend="ref").hier_artifact()
    tabs = [_t(np.asarray(t)) for t in ja.tables_dev]
    kw = dict(top_level=ja.top_level, max_top=ja.max_top, s_pad=ja.s_pad, n_replicas=2)
    ids = _t(_ids(64))
    before = dict(LAUNCHES)
    assert hier_place_replicas_cuda(ids, *tabs, **kw).shape == (2, 2, 64)
    assert hier_place_replicas_cuda(ids[:0], *tabs, **kw).shape == (2, 2, 0)
    assert LAUNCHES == before
    with pytest.raises(TypeError):
        hier_place_replicas_cuda(ids.to(torch.int64), *tabs, **kw)
    for i, bad in ((1, tabs[1].to(torch.int64)), (4, tabs[4][:-1]), (7, tabs[7][:-1])):
        wrong = list(tabs)
        wrong[i] = bad
        with pytest.raises((TypeError, ValueError)):
            hier_place_replicas_cuda(ids, *wrong, **kw)
    with pytest.raises(ValueError):
        hier_place_replicas_cuda(ids, *tabs, **dict(kw, s_pad=ja.s_pad + 1))
    with pytest.raises(ValueError):
        hier_place_replicas_cuda(ids, *tabs, **dict(kw, n_replicas=0))
    with pytest.raises(ValueError):
        hier_place_replicas_cuda(ids, *tabs, **dict(kw, max_top=31))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["device", "numpy"])
@pytest.mark.parametrize("R", [1, 2, 3])
def test_engine_matches_reference_and_oracle(backend, R):
    jh, je, th, te = _pair(backend=backend)
    ids = _ids(3001, seed=R)
    want = jh.place_replicas(ids, R)
    assert np.array_equal(th.place_replicas(ids, R), want)  # the port's oracle
    got = te.place_replica_pairs(ids, R)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, je.place_replica_pairs(ids, R))
    assert np.array_equal(te.place_replica_nodes(ids, R), want)
    assert np.array_equal(te.place_nodes(ids), want[:, 0, 1])
    assert np.array_equal(te.place_nodes(ids), je.place_nodes(ids))
    dev = te.place_replica_pairs_device(_t(ids), R)
    assert dev.dtype == torch.int32 and dev.shape == (2, R, ids.size)
    assert np.array_equal(dev.numpy().transpose(2, 1, 0), want)
    assert np.array_equal(te.place_nodes_device(ids).numpy(), want[:, 0, 1])
    assert np.array_equal(te.place_replica_nodes_device(ids, R).numpy(), dev.numpy())
    assert np.array_equal(th.place(ids), jh.place(ids))
    assert te.uploads == 1
    je.hier_artifact()
    (ev,), (jev,) = te.ledger.events("engine.upload"), je.ledger.events("engine.upload")
    assert (ev["name"], ev["n_segs"]) == (jev["name"], jev["n_segs"]) == ("hier", 5)
    art = te.hier_artifact()
    assert art.statics == je.hier_artifact().statics
    assert art.node_domain == jh.node_domains()
    for a, b in zip(je.hier_artifact().tables_dev, art.tables_dev):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_ragged_engine_and_direct_build_match_reference():
    """A hierarchy built by the same membership calls on the port (not
    crossed over) has the reference's tables and placements."""
    jh = _ragged(JHier())
    th = _ragged(HierarchicalCluster(device="cpu"))
    assert th.version == jh.version
    ids = _ids(2003, seed=9)
    assert np.array_equal(th.engine.place_replica_pairs(ids, 3), jh.place_replicas(ids, 3))
    for a, b in zip(JEngine(jh, backend="ref").hier_artifact().tables_dev,
                    th.engine.hier_artifact().tables_dev):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_identity_survives_churn():
    jh, _, th, te = _pair(nodes_per=3)
    ids = _ids(3003, seed=1)
    for event in (lambda h: h.add_node(1, 900, 1.7), lambda h: h.remove_node(1, 900),
                  lambda h: h.remove_domain(4)):
        event(jh)
        event(th)
        assert th.version == jh.version
        assert np.array_equal(te.place_replica_pairs(ids, 3), jh.place_replicas(ids, 3))
    assert te.uploads == 3  # one per version placed at


def test_flat_only_methods_reject_hierarchical():
    _, _, th, te = _pair()
    ids = _ids(8)
    for call in (lambda: te.place(ids), lambda: te.place_replicas(ids, 2),
                 lambda: te.place_device(ids), lambda: te.diff_nodes_device(ids, 0, 1),
                 lambda: te.addition_numbers_device(ids)):
        with pytest.raises(ValueError, match="HierarchicalCluster"):
            call()
    with pytest.raises(ValueError, match="ASURA-only"):
        PlacementEngine(th, device="cpu", algorithm="ch")
    flat = Router({0: 1.0, 1: 2.0}, device="cpu").engine
    with pytest.raises(ValueError, match="HierarchicalCluster-bound"):
        flat.place_replica_pairs(ids, 1)


EVENTS = {
    "add": (lambda h: h.add_node(2, 900, 1.0), 2),
    "remove_node": (lambda h: h.remove_node(1, 104), 1),
    "remove_domain": (lambda h: h.remove_domain(3), 3),
}


@pytest.mark.parametrize("event", sorted(EVENTS))
def test_diff_replica_domains_matches_reference(event):
    """The two-level diff equals the reference's, and movement is
    failure-domain-local: an add pulls rows only INTO the grown domain
    (in-domain moves land on the new node), a node removal moves rows only
    out of the shrunk domain, a domain removal moves per row exactly the
    copies the domain held."""
    jh, je, th, te = _pair(nodes_per=3)
    je.hier_artifact()
    te.hier_artifact()
    v0 = jh.version
    apply, dom = EVENTS[event]
    ids = _ids(4096, seed=2)
    before = te.place_replica_pairs(ids, 3)
    for h in (jh, th):
        apply(h)
    v1 = jh.version
    want = je.diff_replica_domains_device(jnp.asarray(ids), v0, v1, 3)
    got = te.diff_replica_domains_device(_t(ids), v0, v1, 3)
    assert len(got) == 6
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    moved, src, dst, src_slot = te.diff_replicas_at(ids, v0, v1, 3)
    for g, w in zip((moved, src, dst, src_slot), je.diff_replicas_at(ids, v0, v1, 3)):
        assert np.array_equal(g, w)
    for g, w in zip(te.diff_replicas_device(ids, v0, v1, 3), got[:4]):
        assert torch.equal(g, w)
    src_dom, dst_dom = got[4].numpy(), got[5].numpy()
    after = te.place_replica_pairs(ids, 3)
    assert (after[:, 0, 0] != after[:, 1, 0]).all() and (after[:, 1, 0] != after[:, 2, 0]).all()
    assert (after[:, 0, 0] != after[:, 2, 0]).all()
    assert moved.any()
    if event == "add":
        assert (dst_dom[moved] == dom).all()
        assert (dst[moved & (src_dom == dom)] == 900).all()
    elif event == "remove_node":
        assert (src_dom[moved] == dom).all()
    else:
        assert np.array_equal(moved.sum(axis=1), (before[:, :, 0] == dom).sum(axis=1))
    assert te.uploads == 2  # one two-level artifact per version, ever
    with pytest.raises(KeyError):
        te.hier_artifact_for(v0 - 1)


def test_sync_domain_exact_after_sub_epsilon_churn():
    """Hundreds of sub-epsilon add / remove cycles leave the domain-level
    capacity EXACTLY equal to the member sum (no tolerance drift)."""
    h = _build(HierarchicalCluster(device="cpu"), domains=4, nodes_per=2)
    jh = _build(JHier(), domains=4, nodes_per=2)
    nid = 10_000
    for _ in range(300):
        for x in (h, jh):
            x.add_node(0, nid, 1e-13)
            x.remove_node(0, nid)
        nid += 1
        assert h._top.nodes[0].capacity == h.domains[0].total_capacity()
    for x in (h, jh):
        x.add_node(0, nid, 1e-13)
    assert h._top.nodes[0].capacity == h.domains[0].total_capacity()
    assert h._top.to_json() == jh._top.to_json()
    ids = _ids(2003, seed=4)
    assert np.array_equal(h.engine.place_replica_pairs(ids, 3), jh.place_replicas(ids, 3))


# ---------------------------------------------------------------------------
# the oracle's properties (the port's copy)
# ---------------------------------------------------------------------------


def test_replicas_on_distinct_domains_and_too_few_raises():
    h = _build(HierarchicalCluster(device="cpu"), domains=5, nodes_per=2)
    reps = h.engine.place_replica_pairs(np.arange(2000), 3)
    assert all(len(set(row[:, 0].tolist())) == 3 for row in reps)
    for victim in range(5):
        assert (reps[:, :, 0] != victim).sum(axis=1).min() >= 2
    small = _build(HierarchicalCluster(device="cpu"), domains=2, nodes_per=4)
    with pytest.raises(RuntimeError):
        small.place_replicas(np.arange(10), 3)
    with pytest.raises(RuntimeError, match="distinct domains"):
        small.engine.place_replica_pairs(np.arange(10), 3)
    with pytest.raises(ValueError, match="globally unique"):
        dup = _build(HierarchicalCluster(device="cpu"), domains=2, nodes_per=1)
        dup.add_node(1, 100, 1.0)  # node 100 already lives in domain 0
        dup.engine.place_replica_pairs(np.arange(10), 1)


def test_node_change_stays_within_its_domain():
    h = _build(HierarchicalCluster(device="cpu"), domains=4, nodes_per=3,
               cap=lambda d, i: 1.0)
    ids = np.arange(20_000)
    before = h.engine.place_nodes(ids), h.place(ids)
    h.add_node(2, 99, 1.0)
    after = h.place(ids)
    assert np.array_equal(h.engine.place_nodes(ids), after[:, 1])
    old = before[1]
    moved = ~(old == after).all(axis=1)
    dom_changed = old[:, 0] != after[:, 0]
    assert np.all(after[dom_changed, 0] == 2)
    assert not moved[(old[:, 0] != 2) & ~dom_changed].any()
    assert np.all(after[moved & (old[:, 0] == 2) & (after[:, 0] == 2), 1] == 99)


# ---------------------------------------------------------------------------
# the router, the serving driver, the planner
# ---------------------------------------------------------------------------

TOPO = {d: {100 + 4 * d + i: 1.0 + 0.25 * i + 0.5 * (d % 2) for i in range(4)}
        for d in range(5)}
CFG = dict(batch=512, n_keys=1000, n_replicas=3, seed=5, policy="pow2")


def test_router_matches_reference():
    jr, tr = JRouter(TOPO), Router(TOPO, device="cpu")
    assert tr.hierarchical and tr.engine.hierarchical
    sessions = _ids(3000, seed=6)
    assert np.array_equal(tr.route(sessions), jr.route(sessions))
    assert np.array_equal(tr.route_device(sessions).numpy(), np.asarray(jr.route_device(sessions)))
    assert np.array_equal(tr.route_replicas(sessions, 3), jr.route_replicas(sessions, 3))
    assert np.array_equal(tr.route_replica_pairs(sessions, 3), jr.route_replica_pairs(sessions, 3))
    assert np.array_equal(tr.route_replicas_device(sessions, 3).numpy(),
                          np.asarray(jr.route_replicas_device(sessions, 3)))
    assert tr.table_uploads == 1
    for add, remove in (((2, 900, 1.5), (1, 104)), (None, (2, 900))):
        want = jr.plan_scale_event(sessions, add=add, remove=remove)
        got = tr.plan_scale_event(sessions, add=add, remove=remove)
        assert got.moved_sessions == want.moved_sessions and got.n_reprefills > 0
    with pytest.raises(ValueError, match="ASURA-only"):
        Router(TOPO, algorithm="ch", device="cpu")
    with pytest.raises(ValueError, match="hierarchical router"):
        Router({0: 1.0, 1: 1.0}, device="cpu").route_replica_pairs(sessions, 1)


def test_driver_step_and_superstep_match_reference():
    jd = JRouter(TOPO).stream_driver(**CFG)
    td = Router(TOPO, device="cpu").stream_driver(**CFG)
    assert td.n_bins == jd.n_bins == 120
    for _ in range(2):
        assert np.array_equal(td.step().numpy(), np.asarray(jd.step()))
    assert np.array_equal(td.superstep(3).numpy(), np.asarray(jd.superstep(3)))
    for name in ("counts", "queue", "qhist"):
        assert np.array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)))
    assert td.step_traces == 1
    assert td.load_skew() == jd.load_skew() and td.queue_p99() == jd.queue_p99()
    # a second driver's superstep equals its own steps (the reference's template)
    a, b = (Router(TOPO, device="cpu").stream_driver(**CFG) for _ in range(2))
    stepped = torch.stack([a.step() for _ in range(4)])
    assert torch.equal(b.superstep(4), stepped)


def test_instrumented_hierarchical_driver_raises():
    engine = Router(TOPO, device="cpu").engine
    with pytest.raises(NotImplementedError, match="stats plane"):
        RequestStreamDriver(engine, metrics=MetricsRegistry(device="cpu"), **CFG).step()
    jd = JDriver(JRouter(TOPO).engine, metrics=JMetrics(), **CFG)
    with pytest.raises(NotImplementedError, match="stats plane"):
        jd.step()


@pytest.mark.parametrize("backend", ["device", "numpy"])
def test_plan_replicas_matches_reference(backend):
    jh, je, th, te = _pair(backend=backend, nodes_per=3)
    je.hier_artifact()
    te.hier_artifact()
    v0 = jh.version
    for h in (jh, th):
        h.add_node(3, 900, 1.2)
    ids = _ids(4096, seed=8)
    want = JPlanner(je).plan_replicas(ids, v0, jh.version, 3, chunk=2048)
    got = MigrationPlanner(te).plan_replicas(ids, v0, th.version, 3, chunk=2048)
    assert got.n_moves == want.n_moves > 0 and got.n_scanned == want.n_scanned
    for f in PLAN_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    planner = MigrationPlanner(te)
    chunks = list(planner.chunked(_t(ids), 1024))
    one = list(planner.plan_replicas_stream(chunks, v0, th.version, 3))
    fused = list(planner.plan_replicas_stream(chunks, v0, th.version, 3, fuse=4))
    for a, b in zip(one, fused):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert sum(int(p[1].sum()) for p in one) == want.n_moves


def test_remaining_refusals_match_reference():
    """What the reference still refuses in this mode, the port refuses:
    live scale windows on a hierarchical router, the ADDITION-NUMBER
    prefilter on a hierarchical engine, and the flat single-owner diff."""
    sessions = _ids(100)
    with pytest.raises(NotImplementedError, match="flat-router only"):
        Router(TOPO, device="cpu").begin_scale_migration(sessions, add=(0, 900, 1.0))
    _, _, th, te = _pair()
    te.hier_artifact()
    v0 = th.version
    th.add_node(0, 900, 1.0)
    with pytest.raises(ValueError, match="flat-table semantics"):
        MigrationPlanner(te).plan_replicas(sessions, v0, th.version, 3, max_new_seg=5)
    with pytest.raises(ValueError, match="HierarchicalCluster"):
        MigrationPlanner(te).plan(sessions, v0, th.version)


# ---------------------------------------------------------------------------
# two-level churn properties (hypothesis), as the reference's property test
# ---------------------------------------------------------------------------


def test_two_level_churn_properties():
    """Property test over add-node / remove-node / remove-domain churn on
    the port (B8's twin), each membership state mirrored on a reference
    hierarchy: placements equal the reference's oracle, replica domains
    stay pairwise distinct, the two-level diff equals the brute-force set
    diff, and movement is failure-domain-local -- a node add pulls data
    only INTO the grown domain (its intra-domain moves land exactly on
    the new node), a node remove sources every move from the shrunk
    domain, and a domain remove moves per row exactly the copies the
    domain held."""
    from hypothesis import given, settings, strategies as st

    ops = st.lists(
        st.tuples(
            st.sampled_from(["add", "remove_node", "remove_domain"]),
            st.floats(0.5, 2.0),
        ),
        min_size=1,
        max_size=3,
    )

    @settings(max_examples=8, deadline=None)
    @given(ops=ops, seed=st.integers(0, 2**16))
    def run(ops, seed):
        rng = np.random.default_rng(seed)
        cap = lambda d, i: 1.0  # noqa: E731
        jh = _build(JHier(), domains=5, nodes_per=3, cap=cap)
        h = _build(HierarchicalCluster(device="cpu"), domains=5, nodes_per=3, cap=cap)
        eng = h.engine
        ids = rng.integers(0, 2**32, 300, dtype=np.uint32)
        R = 3
        next_node = 10_000
        for op, c in ops:
            before = eng.place_replica_pairs(ids, R)
            v_from = h.version
            domains = sorted(h.domains)
            if op == "remove_domain" and len(domains) > R + 1:
                d = domains[int(c * 7) % len(domains)]
                for x in (h, jh):
                    x.remove_domain(d)
                kind = "remove_domain"
            elif op == "remove_node" and any(len(h.domains[x].nodes) > 1 for x in domains):
                d = next(x for x in domains[int(c * 5) % len(domains):] + domains
                         if len(h.domains[x].nodes) > 1)
                victim = sorted(h.domains[d].nodes)[0]
                for x in (h, jh):
                    x.remove_node(d, victim)
                kind = "remove_node"
            else:
                d = domains[int(c * 7) % len(domains)]
                for x in (h, jh):
                    x.add_node(d, next_node, float(c))
                kind = "add"
            after = eng.place_replica_pairs(ids, R)
            assert np.array_equal(after, jh.place_replicas(ids, R))
            for row in after:
                assert len(set(row[:, 0].tolist())) == R
            moved, src, dst, src_slot, src_dom, dst_dom = (
                x.numpy() for x in eng.diff_replica_domains_device(
                    torch.from_numpy(ids), v_from, h.version, R)
            )
            b_node, a_node = before[:, :, 1], after[:, :, 1]
            minimal = ~(a_node[:, :, None] == b_node[:, None, :]).any(axis=2)
            assert int(moved.sum()) == int(minimal.sum())
            assert np.array_equal(dst_dom[moved], after[:, :, 0][moved])
            assert np.array_equal(dst[moved], a_node[moved])
            if kind == "add":
                assert np.all(dst_dom[moved] == d)
                intra = moved & (src_dom == d)
                assert np.all(dst[intra] == next_node)
                next_node += 1
            elif kind == "remove_node":
                assert np.all(src_dom[moved] == d)
            else:
                assert np.all(src_dom[moved] == d)
                held = (before[:, :, 0] == d).sum(axis=1)
                assert np.array_equal(moved.sum(axis=1), held)

    run()
