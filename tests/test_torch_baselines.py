"""The port's comparison baselines (CH, RS, WRH) against the reference's.

The same inputs, made from a seed with numpy, go through the reference
(its jnp bodies, its Pallas kernels in interpret mode, its NumPy oracles,
its engine, router and serving driver) and through the port on the CPU
(the plain-torch twins the wrappers take for CPU tensors), and every
result must be equal: the stack is integer math plus one IEEE f32
multiply per (id, node) pair, so nothing is compared with a tolerance.

Edge ids are made by inverting ``fmix32`` (a bijection), so the hashes
land exactly on 0, 0xFFFFFFFF, ring points (duplicated ones too), ring
points +- 1 and interval starts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PlacementEngine as JEngine
from repro.core import RandomSlicingTable as JRandomSlicingTable
from repro.core import StrawBucket as JStrawBucket
from repro.core import build_ring as j_build_ring
from repro.core import make_cluster as j_make_cluster
from repro.core.wrh import neg_log2_q16_np as j_neg_log2_q16_np
from repro.kernels import baselines as jb
from repro.serve import Router as JRouter
from repro.obs import MetricsRegistry as JMetrics
from repro_torch import convert
from repro_torch.core import (
    ALGORITHMS,
    BaselineArtifact,
    ConsistentHashRing,
    PlacementEngine,
    RandomSlicingTable,
    StrawBucket,
    build_ring,
    ch_place_np,
    make_cluster,
    rs_place_np,
    wrh_place_np,
)
from repro_torch.core.wrh import neg_log2_q16_np
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import baselines as tb
from repro_torch.kernels import baselines_ref as tr
from repro_torch.kernels import ops
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import Router

BASELINES = ("ch", "rs", "wrh")
N_NODES = 48
VNODES = 100  # the paper's CH setting
BATCH = 2048 + 13
M32 = 0xFFFFFFFF


def _caps(n=N_NODES, seed=0):
    return np.random.default_rng(seed).uniform(0.5, 2.0, n)


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unfmix32(h: np.ndarray) -> np.ndarray:
    """The inverse of MurmurHash3's 32-bit finalizer: ids whose hash is h."""
    h = h.astype(np.uint64)
    h ^= h >> 16
    h = (h * pow(0xC2B2AE35, -1, 2**32)) & M32
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * pow(0x85EBCA6B, -1, 2**32)) & M32
    h ^= h >> 16
    return h.astype(np.uint32)


def _edge_ids(points: np.ndarray) -> np.ndarray:
    """Ids hashing to 0, 0xFFFFFFFF, every table point and its neighbours."""
    p = points.astype(np.int64)
    h = np.concatenate([[0, 1, M32 - 1, M32], p, p - 1, p + 1])
    h = np.unique(np.clip(h, 0, M32)).astype(np.uint32)
    return _unfmix32(h)


def _rs_table(caps):
    """A reference random-slicing table with history: build, add, remove."""
    t = JRandomSlicingTable({i: float(c) for i, c in enumerate(caps)})
    t.rebalance({**t.weights, len(caps): 1.0})
    t.rebalance({k: v for k, v in t.weights.items() if k != len(caps) // 2})
    return t


def _dup_ring():
    """A CH ring with duplicated hashes carried by different owners."""
    ring, owners = j_build_ring(range(20), 30)
    ring = np.sort(np.concatenate([ring, ring[::7]]))
    owners = np.random.default_rng(3).integers(0, 20, ring.shape[0]).astype(np.uint32)
    assert np.unique(ring).shape[0] < ring.shape[0]
    return ring, owners


def _tables(alg, caps=None):
    """(canonical keys, vals) of one algorithm, from the reference."""
    caps = _caps() if caps is None else caps
    if alg == "ch":
        return j_build_ring(range(len(caps)), VNODES)
    if alg == "rs":
        return _rs_table(caps).starts_owners()
    return np.arange(len(caps), dtype=np.uint32), np.asarray(caps, dtype=np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins here run thousands of small tensor ops (the WRH fan-out's
    64 tries on tiny blocks); intra-op threads only add hand-offs to them,
    and under a parallel test run they fight the other workers' threads.
    One thread for this module, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_JPREP = {"ch": jb.ch_table_prep, "rs": jb.rs_table_prep, "wrh": jb.wrh_table_prep}
_ORACLE = {"ch": ch_place_np, "rs": rs_place_np, "wrh": wrh_place_np}


# ---------------------------------------------------------------------------
# the twins against the Pallas kernels (interpret mode) and the oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["ch", "ch-dup-ring", "ch-lane-multiple", "rs", "wrh"])
def test_lookup_twin_matches_pallas_and_oracle(case):
    alg = case.split("-")[0]
    if case == "ch-dup-ring":
        keys, vals = _dup_ring()
    elif case == "ch-lane-multiple":
        keys, vals = j_build_ring(range(16), 8)  # 128 points: no padding
        assert keys.shape[0] % tb.LANE == 0
    else:
        keys, vals = _tables(alg)
    ids = _ids(BATCH, seed=len(case))
    if alg != "wrh":
        ids = np.concatenate([ids, _edge_ids(keys)])
    a, b = tb.TABLE_PREP[alg](keys, vals, device="cpu")
    ja, jbb = _JPREP[alg](keys, vals)
    assert np.array_equal(a.numpy().view(np.uint32), np.asarray(ja))
    assert np.array_equal(b.numpy(), np.asarray(jbb))
    got = getattr(tb, f"{alg}_place_cuda")(_t(ids), a, b)
    assert got.dtype == torch.int32 and got.shape == ids.shape
    pallas = jb.baseline_place_on_table_device(alg, ids, ja, jbb, use_pallas=True,
                                               interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(pallas))
    assert np.array_equal(got.numpy().astype(np.int64), _ORACLE[alg](ids, keys, vals))
    # the entry point of ops, on the host and on the device
    assert np.array_equal(ops.baseline_place_on_table(alg, ids, a, b), got.numpy())
    assert torch.equal(ops.baseline_place_on_table_device(alg, _t(ids), a, b), got)


def test_rs_edge_ids_hit_every_start_and_the_last():
    starts, owners = _tables("rs")
    ids = _edge_ids(starts)
    a, b = tb.rs_table_prep(starts, owners, device="cpu")
    got = tb.rs_place_cuda(_t(ids), a, b).numpy()
    assert np.array_equal(got, rs_place_np(ids, starts, owners))
    h = tr.fmix32(tr.as_u32(_t(ids))).numpy()
    assert np.isin(starts.astype(np.int64), h).all()  # every start, the last too


@pytest.mark.parametrize("cut", [1, 5])
def test_rs_lookup_below_the_first_start_matches_reference(cut):
    """A table whose ``starts[0] != 0`` (the first ``cut`` intervals of a
    reference table dropped): a hash below the first start takes the last
    owner in the twin and in B6's wrapper, as the reference's jnp
    ``rs_lookup`` does (its ``take`` at -1 wraps) and as the NumPy oracle
    does (``owners[-1]``); no engine path builds such a table."""
    starts, owners = _tables("rs")
    starts, owners = starts[cut:], owners[cut:]
    assert starts[0] != 0
    below = _unfmix32(np.linspace(0, int(starts[0]) - 1, 257).astype(np.uint32))
    ids = np.concatenate([_ids(BATCH, seed=cut), _edge_ids(starts), below])
    h = tr.fmix32(tr.as_u32(_t(ids))).numpy().astype(np.int64)
    assert (h < int(starts[0])).sum() >= 257  # hashes below the first start
    a, b = tb.rs_table_prep(starts, owners, device="cpu")
    ja, jbb = jb.rs_table_prep(starts, owners)
    want = np.asarray(jb.rs_lookup(jnp.asarray(ids), ja, jbb))
    got = tr.rs_lookup(_t(ids), a, b)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(tb.rs_place_cuda(_t(ids), a, b).numpy(), want)
    assert np.array_equal(want.astype(np.int64), rs_place_np(ids, starts, owners))
    assert (want[h < int(starts[0])] == owners[-1]).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_neg_log2_q16_matches_reference(seed):
    h = _ids(1 << 14, seed=seed)
    h = np.concatenate([h, np.array([0, 1, 511, 512, 2**31, M32 - 511, M32], np.uint32)])
    want = j_neg_log2_q16_np(h)
    got = tr.neg_log2_q16(_t(h))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(jb.neg_log2_q16(jnp.asarray(h))))
    assert np.array_equal(neg_log2_q16_np(h), want)


@pytest.mark.parametrize("block", [1, 7, 4096, 1 << 22])
def test_wrh_twin_blocks_keep_the_first_minimum(block):
    """Any (ids x nodes) block gives the reference's first-minimum winner,
    with zero-weight entries (never win) and repeated nodes (tie on the
    key, the first wins) in the table."""
    nodes = np.array([5, 3, 5, 9, 3, 12, 0, 7], dtype=np.uint32)
    w = np.array([1.0, 0.0, 1.0, 2.5, 0.7, -1.0, 1.25, 0.5], dtype=np.float32)
    ids = _ids(777, seed=block % 5)
    salts, inv_w = tb.wrh_table_prep(nodes, w, device="cpu")
    got = tr.wrh_lookup(_t(ids), salts, inv_w, block=block)
    want = jb.wrh_lookup(jnp.asarray(ids), *jb.wrh_table_prep(nodes, w))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_wrh_without_a_valid_entry_gives_minus_one():
    salts, inv_w = tb.wrh_table_prep(np.array([4, 2], np.uint32),
                                     np.array([0.0, 0.0], np.float32), device="cpu")
    ids = _t(_ids(300))
    assert (tb.wrh_place_cuda(ids, salts, inv_w) == -1).all()
    out, stats = tb.baseline_replicas_cuda("wrh", ids, salts, inv_w, n_replicas=3,
                                           max_tries=8, emit_stats=True)
    want, want_stats = jb.baseline_replicas_lookup(
        jb.wrh_lookup, jnp.asarray(ids.numpy()),
        *jb.wrh_table_prep(np.array([4, 2], np.uint32), np.array([0.0, 0.0], np.float32)),
        n_replicas=3, max_tries=8, emit_stats=True)
    assert (out == -1).all() and np.array_equal(out.numpy(), np.asarray(want))
    assert int(stats.view(torch.int32)) == int(np.asarray(want_stats)[0]) == 300 * 8


@pytest.mark.parametrize("R", [1, 3, 5])
@pytest.mark.parametrize("alg", BASELINES)
def test_fanout_twin_matches_reference(alg, R):
    keys, vals = _tables(alg)
    ids = _ids(BATCH, seed=R)
    a, b = tb.TABLE_PREP[alg](keys, vals, device="cpu")
    got, stats = tb.baseline_replicas_cuda(alg, _t(ids), a, b, n_replicas=R,
                                           emit_stats=True)
    want, want_stats = jb.baseline_replicas_lookup(
        jb._LOOKUP[alg], jnp.asarray(ids), *_JPREP[alg](keys, vals), n_replicas=R,
        emit_stats=True)
    assert got.dtype == torch.int32 and stats.dtype == torch.uint32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(stats.view(torch.int32)) & M32 == int(np.asarray(want_stats)[0])
    assert np.array_equal(got.numpy().astype(np.int64),
                          tb.baseline_place_replicas_np(alg, ids, keys, vals, R))
    assert np.array_equal(got.numpy().astype(np.int64),
                          jb.baseline_place_replicas_np(alg, ids, keys, vals, R))
    plain = tb.baseline_replicas_cuda(alg, _t(ids), a, b, n_replicas=R)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("alg", BASELINES)
def test_fanout_twin_with_more_replicas_than_nodes(alg):
    """R = 6 on 4 nodes: every lane keeps at least 2 slots at -1 (every
    lane runs out its tries, so the budget is cut to 16 on both sides)."""
    keys, vals = _tables(alg, caps=[1.0, 2.0, 0.5, 1.5])
    ids = _ids(513, seed=9)
    a, b = tb.TABLE_PREP[alg](keys, vals, device="cpu")
    got, stats = tb.baseline_replicas_cuda(alg, _t(ids), a, b, n_replicas=6,
                                           max_tries=16, emit_stats=True)
    want, want_stats = jb.baseline_replicas_lookup(
        jb._LOOKUP[alg], jnp.asarray(ids), *_JPREP[alg](keys, vals), n_replicas=6,
        max_tries=16, emit_stats=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(stats.view(torch.int32)) & M32 == int(np.asarray(want_stats)[0])
    assert ((got < 0).sum(dim=1) >= 2).all()  # 4 nodes: at most 4 filled


def test_wrappers_check_their_inputs():
    a, b = tb.ch_table_prep(*j_build_ring(range(4), 8), device="cpu")
    ids = _t(_ids(10))
    with pytest.raises(TypeError):
        tb.ch_place_cuda(ids.to(torch.int64), a, b)
    with pytest.raises(ValueError):
        tb.ch_place_cuda(ids, a, b[:-1])
    with pytest.raises(ValueError):
        tb.ch_place_cuda(ids, a[:0], b[:0])
    with pytest.raises(TypeError):
        tb.wrh_place_cuda(ids, a, b)  # inv_w must be float32
    with pytest.raises(ValueError):
        tb.baseline_replicas_cuda("ch", ids, a, b, n_replicas=0)
    with pytest.raises(ValueError):
        tb.baseline_replicas_cuda("straw", ids, a, b, n_replicas=2)
    before = dict(LAUNCHES)
    tb.ch_place_cuda(ids, a, b)  # the twin: no launch counted on the CPU
    assert LAUNCHES == before


# ---------------------------------------------------------------------------
# the host modules copied from the reference
# ---------------------------------------------------------------------------


def test_core_copies_match_reference():
    ids = _ids(5000, seed=4)
    caps = _caps(20)
    ring = ConsistentHashRing(range(20), virtual_nodes=50)
    assert np.array_equal(ring.ring_hashes, j_build_ring(range(20), 50)[0])
    assert ring.memory_bytes() == 8 * 20 * 50
    assert np.array_equal(build_ring(range(20), 50)[1], j_build_ring(range(20), 50)[1])
    straw, jstraw = StrawBucket(range(20), caps), JStrawBucket(range(20), caps)
    assert np.array_equal(straw.place(ids), jstraw.place(ids))
    assert np.array_equal(straw.place_replicas(ids, 3), jstraw.place_replicas(ids, 3))
    t, jt = RandomSlicingTable(), JRandomSlicingTable()
    for w in ({i: float(c) for i, c in enumerate(caps)}, {**dict(enumerate(caps)), 20: 1.0},
              {i: float(c) for i, c in enumerate(caps) if i != 7}):
        t.rebalance(w)
        jt.rebalance(w)
        assert t._intervals == jt._intervals
        assert np.array_equal(t.place(ids), jt.place(ids))
    assert t.memory_bytes() == jt.memory_bytes()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _engines(alg, backend):
    """(reference engine, port engine on the CPU) over the same cluster."""
    caps = _caps()
    jc = j_make_cluster(caps)
    c = convert.cluster_from_reference_json(jc.to_json(), device="cpu")
    return (jc, JEngine(jc, backend="numpy", algorithm=alg),
            c, PlacementEngine(c, device="cpu", backend=backend, algorithm=alg))


@pytest.mark.parametrize("backend", ["device", "numpy"])
@pytest.mark.parametrize("alg", BASELINES)
def test_engine_matches_reference_across_add_and_remove(alg, backend):
    """The same add / remove sequence on both engines: every version's
    placements equal, old versions re-placed after the cluster moved on
    (RS's history included), one upload per version."""
    jc, je, c, e = _engines(alg, backend)
    ids = _ids(BATCH, seed=11)
    versions, before = [], []
    for event in (None, ("add", 48, 1.0), ("remove", 20), ("add", 49, 0.7)):
        if event is not None:
            for cl in (jc, c):
                getattr(cl, f"{event[0]}_node")(*event[1:])
        versions.append(c.version)
        want = je.place_nodes(ids)
        got = e.place_nodes(ids)
        assert got.dtype == np.int64 and np.array_equal(got, want)
        before.append(want)
        dev = e.place_nodes_device(_t(ids))
        assert dev.dtype == torch.int32 and np.array_equal(dev.numpy(), want)
        assert np.array_equal(e.place_replica_nodes(ids, 3), je.place_replica_nodes(ids, 3))
        assert np.array_equal(e.place_replica_nodes_device(ids, 3).numpy(),
                              je.place_replica_nodes(ids, 3))
    assert e.uploads == je.uploads == 4
    for v, want in zip(versions, before):
        assert np.array_equal(e.place_nodes_at(ids, v), want)
        assert np.array_equal(e.place_nodes_at(ids, v), je.place_nodes_at(ids, v))
        assert np.array_equal(e.place_nodes_device_at(_t(ids), v).numpy(), want)
        assert e.artifact_for(v).memory_bytes() == je.artifact_for(v).memory_bytes()
    assert e.uploads == 4
    art, jart = e.artifact(), je.artifact()
    assert isinstance(art, BaselineArtifact) and art.algorithm == alg
    assert np.array_equal(art.keys, jart.keys) and np.array_equal(art.vals, jart.vals)
    assert art.n_entries == jart.n_entries and art.memory_bytes() == 8 * art.n_entries


def test_engine_lru_is_per_algorithm():
    """ASURA uploads never evict a baseline artifact, nor the reverse;
    ``uploads`` ticks once per (algorithm, version); an evicted version
    raises KeyError and is never rebuilt."""
    c = make_cluster(_caps(), device="cpu")
    e = c.engine
    ids = _ids(64)
    v0 = c.version
    ch0 = e.place_nodes(ids, algorithm="ch")
    art_ch = e.artifact("ch")
    assert e.place_nodes(ids) is not None and e.uploads == 2
    assert e.artifact("asura") is not art_ch and e.uploads == 2
    for i in range(5):  # 5 ASURA versions through a 4-deep LRU
        c.add_node(100 + i, 1.0)
        e.place_nodes(ids)
    assert e.uploads == 7
    assert e.artifact_for(v0, "ch") is art_ch
    assert np.array_equal(e.place_nodes_at(ids, v0, algorithm="ch"), ch0)
    with pytest.raises(KeyError):
        e.artifact_for(v0, "asura")
    v_asura = c.version
    for i in range(5):  # and the reverse: 5 RS versions through its LRU
        e.place_nodes(ids, algorithm="rs")
        c.add_node(200 + i, 1.0)
    assert e.artifact_for(v_asura, "asura").version == v_asura  # still cached
    with pytest.raises(KeyError):
        e.artifact_for(v_asura, "rs")  # RS's own oldest version went
    assert e.uploads == 7 + 5


@pytest.mark.parametrize("method,args", [
    ("place", ([1, 2],)),
    ("place_replicas", ([1, 2], 2)),
    ("place_device", ([1, 2],)),
    ("place_at", ([1, 2], 0)),
    ("place_replicas_at", ([1, 2], 0, 2)),
    ("place_replica_nodes_at", ([1, 2], 0, 2)),
    ("place_device_at", ([1, 2], 0)),
    ("place_replica_nodes_device_at", ([1, 2], 0, 2)),
    ("diff_nodes_device", ([1, 2], 0, 1)),
    ("diff_replicas_device", ([1, 2], 0, 1, 2)),
    ("diff_replicas_at", ([1, 2], 0, 1, 2)),
    ("addition_numbers_device", ([1, 2],)),
    ("remove_numbers_batch", ([1, 2], 2)),
])
def test_asura_only_methods_raise_on_a_baseline_engine(method, args):
    e = PlacementEngine(make_cluster(_caps(8), device="cpu"), device="cpu",
                        algorithm="wrh")
    with pytest.raises(ValueError, match="ASURA-only"):
        getattr(e, method)(*args)
    assert e.uploads == 0


def test_host_fanout_raises_when_a_slot_stays_unfilled():
    c = make_cluster([1.0, 1.0, 1.0], device="cpu")
    for backend in ("device", "numpy"):
        e = PlacementEngine(c, device="cpu", backend=backend, algorithm="ch")
        with pytest.raises(ValueError, match="distinct"):
            e.place_replica_nodes(_ids(50), 4)
        assert (e.place_replica_nodes_device(_ids(50), 4) == -1).any()


# ---------------------------------------------------------------------------
# the router and the serving driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alg", BASELINES)
def test_router_matches_reference(alg):
    caps = {i: float(c) for i, c in enumerate(_caps())}
    jr = JRouter(caps, algorithm=alg)
    r = Router(caps, algorithm=alg, device="cpu")
    assert r.engine.algorithm == alg and r.cluster.engine.algorithm == "asura"
    sessions = _ids(BATCH, seed=12)
    assert np.array_equal(r.route(sessions), jr.route(sessions))
    assert np.array_equal(r.route_device(_t(sessions)).numpy(), jr.route(sessions))
    assert np.array_equal(r.route_replicas(sessions, 3), jr.route_replicas(sessions, 3))
    assert np.array_equal(r.route_replicas_device(sessions, 3).numpy(),
                          np.asarray(jr.route_replicas_device(sessions, 3)))
    assert np.array_equal(r.my_sessions(5, sessions), jr.my_sessions(5, sessions))
    for kw in (dict(add=(48, 1.0)), dict(remove=24)):
        plan, jplan = r.plan_scale_event(sessions, **kw), jr.plan_scale_event(sessions, **kw)
        assert plan.moved_sessions == jplan.moved_sessions and plan.n_reprefills > 0
    assert r.table_uploads == jr.table_uploads == 3
    with pytest.raises(ValueError, match="ASURA"):
        r.begin_scale_migration(sessions[:8], add=(60, 1.0))
    if alg == "rs":
        with pytest.raises(ValueError, match="history-dependent"):
            r.table_blob()
    else:
        assert r.table_blob() == jr.table_blob()


@pytest.mark.parametrize("alg", BASELINES)
def test_driver_step_and_superstep_match_reference(alg):
    caps = {i: float(c) for i, c in enumerate(_caps())}
    cfg = dict(batch=512, n_keys=1000, n_replicas=3, policy="pow2", seed=5)
    jm, tm, tm2 = JMetrics(), MetricsRegistry(device="cpu"), MetricsRegistry(device="cpu")
    jd = JRouter(caps, algorithm=alg).stream_driver(metrics=jm, **cfg)
    td = Router(caps, algorithm=alg, device="cpu").stream_driver(metrics=tm, **cfg)
    sd = Router(caps, algorithm=alg, device="cpu").stream_driver(metrics=tm2, **cfg)
    chosen = []
    for _ in range(3):
        got = td.step()
        assert np.array_equal(got.numpy(), np.asarray(jd.step()))
        chosen.append(got)
    assert torch.equal(sd.superstep(3), torch.stack(chosen))
    for d in (td, sd):
        assert np.array_equal(np.asarray(jd.counts), d.counts.numpy())
        assert np.array_equal(np.asarray(jd.queue), d.queue.numpy())
        assert np.array_equal(np.asarray(jd.qhist), d.qhist.numpy())
    js, ts, ss = jm.snapshot(), tm.snapshot(), tm2.snapshot()
    assert js.keys() == ts.keys() == ss.keys()
    assert "baseline.reprobes" in ts and "asura.ladder_depth" not in ts
    assert int(ts["baseline.reprobes"]) > 0
    for name in js:
        assert np.array_equal(np.asarray(js[name]), np.asarray(ts[name])), name
        assert np.array_equal(np.asarray(ss[name]), np.asarray(ts[name])), name
    assert td.step_traces == 1 and td.engine.uploads == 1


# ---------------------------------------------------------------------------
# carrying the reference's baseline state across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alg", BASELINES)
def test_baseline_artifact_from_arrays(alg):
    jc = j_make_cluster(_caps())
    jart = JEngine(jc, backend="numpy", algorithm=alg).artifact()
    art = convert.baseline_artifact_from_arrays(alg, jart.keys, jart.vals, jart.version,
                                                device="cpu")
    assert art.version == jart.version and art.memory_bytes() == jart.memory_bytes()
    ids = _ids(BATCH, seed=13)
    got = ops.baseline_place_on_table(alg, ids, art.keys_dev, art.vals_dev)
    assert np.array_equal(got, _ORACLE[alg](ids, jart.keys, jart.vals))
    with pytest.raises(ValueError):
        convert.baseline_artifact_from_arrays("asura", jart.keys, jart.vals, 0, device="cpu")


def test_rs_table_from_intervals_continues_the_reference_slicing():
    caps = _caps(30)
    jc = j_make_cluster(caps)
    je = JEngine(jc, backend="numpy", algorithm="rs")
    je.artifact()
    jc.add_node(30, 1.2)
    je.artifact()  # the reference's slicing now has a history
    c = convert.cluster_from_reference_json(jc.to_json(), device="cpu")
    e = PlacementEngine(c, device="cpu", algorithm="rs")
    e._rs_shadow = convert.rs_table_from_intervals(je._rs_shadow._intervals,
                                                   je._rs_shadow.weights)
    ids = _ids(BATCH, seed=14)
    for cl in (jc, c):
        cl.remove_node(3)
        cl.add_node(31, 0.8)
    assert np.array_equal(e.place_nodes(ids), je.place_nodes(ids))
    assert e._rs_shadow._intervals == je._rs_shadow._intervals
    with pytest.raises(ValueError):
        convert.rs_table_from_intervals([(0, 5, 1)], {1: 1.0})


def test_algorithms_and_defaults():
    assert ALGORITHMS == ("asura", "ch", "wrh", "rs")
    e = PlacementEngine(make_cluster(_caps(4), device="cpu"), device="cpu", algorithm="ch")
    assert e.artifact().n_entries == 4 * VNODES
