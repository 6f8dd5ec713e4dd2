"""The port's consumers of placement against the reference, on the CPU.

The data pipeline, the replicated checkpoint store, the elastic
coordinator, failure detection and straggler backups: each reference test
of ``tests/test_runtime.py`` runs here on both packages with the same
seeded inputs, and the port's results must equal the reference's exactly
(owned shards, batches, chunk keys, per-node blobs, ``MovePlan`` moves,
owner tables).  Reference clusters cross over through
``convert.cluster_from_reference_json``; the port runs on
``device="cpu"``, where its wrappers take the plain-torch twins (held to
the reference's kernels in ``test_torch_kernels.py``, and the CUDA
kernels to the twins on the card in ``test_torch_gpu.py``).
"""

import collections

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import AsuraCheckpointStore as JStore
from repro.checkpoint import CheckpointManager as JManager
from repro.core import Cluster as JCluster
from repro.core import PlacementEngine as JEngine
from repro.core import make_uniform_cluster as j_uniform
from repro.data import DataPipeline as JPipeline
from repro.data import ShardedDataset as JDataset
from repro.obs import TraceLedger as JLedger
from repro.runtime import ElasticCoordinator as JCoordinator
from repro.runtime import FailureDetector as JDetector
from repro.runtime import HeartbeatTracker as JTracker
from repro.runtime import MigrationDriver as JDriver
from repro.runtime import StragglerMitigator as JStraggler
from repro_torch import convert
from repro_torch.checkpoint import AsuraCheckpointStore, CheckpointManager
from repro_torch.checkpoint.sharded import CHUNK_BYTES, chunk_id
from repro_torch.core import PlacementEngine
from repro_torch.data import DataPipeline, ShardedDataset
from repro_torch.obs import TraceLedger
from repro_torch.runtime import (
    ElasticCoordinator,
    FailureDetector,
    HeartbeatTracker,
    MigrationDriver,
    StragglerMitigator,
)

BACKENDS = ("device", "numpy")  # port backends (the reference runs numpy)


def _port(jc, backend="device"):
    """The port twin of reference cluster ``jc`` on the CPU."""
    tc = convert.cluster_from_reference_json(jc.to_json(), device="cpu")
    if backend != "device":
        tc._engine = PlacementEngine(tc, device="cpu", backend=backend)
    return tc


def _hetero(caps=(0.5, 1.7, 1.0, 2.3)):
    c = JCluster()
    for i, cap in enumerate(caps):
        c.add_node(i, cap)
    return c


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


class TestDataPipeline:
    def _mk(self, n_hosts=4, n_shards=64, backend="device"):
        jc = j_uniform(n_hosts)
        tc = _port(jc, backend)
        jds = JDataset(n_shards=n_shards, tokens_per_shard=4096, vocab=1000)
        tds = ShardedDataset(n_shards=n_shards, tokens_per_shard=4096, vocab=1000)
        jp = [JPipeline(jds, jc, h, batch_per_host=2, seq_len=128) for h in range(n_hosts)]
        tp = [DataPipeline(tds, tc, h, batch_per_host=2, seq_len=128) for h in range(n_hosts)]
        return jc, tc, jds, tds, jp, tp

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_every_shard_owned_exactly_once(self, backend):
        *_, jp, tp = self._mk(backend=backend)
        owned = np.concatenate([p.owned_shards for p in tp])
        assert sorted(owned.tolist()) == list(range(64))
        for a, b in zip(jp, tp):
            assert np.array_equal(a.owned_shards, b.owned_shards)

    def test_batches_deterministic(self):
        *_, jp, tp = self._mk()
        a = [b.copy() for _, b in zip(range(3), tp[0].batches())]
        b = [b.copy() for _, b in zip(range(3), tp[0].batches())]
        ref = [b.copy() for _, b in zip(range(3), jp[0].batches())]
        for x, y, z in zip(a, b, ref):
            assert np.array_equal(x, y)
            assert np.array_equal(x, z)

    def test_batch_shape_and_range(self):
        *_, jp, tp = self._mk()
        batch = next(iter(tp[0]))
        assert batch.shape == (2, 128) and batch.dtype == np.int32
        assert batch.min() >= 0 and batch.max() < 1000
        assert np.array_equal(batch, next(iter(jp[0])))

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_elastic_membership_minimal_movement(self, backend):
        jc, tc, jds, tds, jp, tp = self._mk(backend=backend)
        jc.add_node(4, 1.0)
        tc.add_node(4, 1.0)
        new_j = JPipeline(jds, jc, 4, batch_per_host=2, seq_len=128)
        new_t = DataPipeline(tds, tc, 4, batch_per_host=2, seq_len=128)
        assert np.array_equal(new_t.owned_shards, new_j.owned_shards)
        gained_total = set(new_t.owned_shards.tolist())
        for a, b in zip(jp, tp):
            gained, lost = b.refresh_membership()
            want_gained, want_lost = a.refresh_membership()
            assert np.array_equal(gained, want_gained) and np.array_equal(lost, want_lost)
            assert gained.size == 0  # existing hosts never gain on addition
            assert set(lost.tolist()) <= gained_total
        owned = set()
        for p in tp + [new_t]:
            owned |= set(p.owned_shards.tolist())
        assert owned == set(range(64))

    def test_epoch_order_varies(self):
        *_, jp, tp = self._mk()
        b0 = next(tp[0].batches(epoch=0))
        b1 = next(tp[0].batches(epoch=1))
        assert not np.array_equal(b0, b1)
        assert np.array_equal(b1, next(jp[0].batches(epoch=1)))

    def test_synthetic_shard_matches_reference(self):
        from repro.data.pipeline import synthetic_shard as j_shard
        from repro_torch.data import synthetic_shard

        for sid in (0, 1, 977, 2**31 + 5):
            assert np.array_equal(
                synthetic_shard(sid, tokens_per_shard=1000, vocab=50),
                j_shard(sid, tokens_per_shard=1000, vocab=50),
            )
        with pytest.raises(IndexError):
            ShardedDataset(n_shards=4, tokens_per_shard=8, vocab=5).shard(4)


def test_pipeline_ownership_via_device_path():
    """The device branch (one placement launch and one bool mask) owns
    what the host branch and the reference's device branch own."""
    ds_t = ShardedDataset(n_shards=64, tokens_per_shard=128, vocab=97)
    ds_j = JDataset(n_shards=64, tokens_per_shard=128, vocab=97)
    jc = j_uniform(4)
    j_dev = JCluster.from_json(jc.to_json())
    j_dev._engine = JEngine(j_dev, backend="ref")
    t_dev, t_host = _port(jc, "device"), _port(jc, "numpy")
    for host in range(4):
        want = JPipeline(ds_j, j_dev, host, batch_per_host=2, seq_len=32).owned_shards
        for tc in (t_dev, t_host):
            got = DataPipeline(ds_t, tc, host, batch_per_host=2, seq_len=32).owned_shards
            assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# checkpoint store
# ---------------------------------------------------------------------------


def _tree(rng):
    return {
        "w": rng.standard_normal((128, 64)).astype(np.float32),
        "b": rng.standard_normal((7,)).astype(np.float32),
        "nested": {"m": rng.standard_normal((33, 5)).astype(np.float32)},
    }


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _stores(caps, R):
    """(reference store, port store) with equal clusters."""
    return JStore(caps, n_replicas=R), AsuraCheckpointStore(caps, n_replicas=R, device="cpu")


def _same_blobs(js, ts):
    assert sorted(js.nodes) == sorted(ts.nodes)
    for nid, node in js.nodes.items():
        assert ts.nodes[nid].blobs == node.blobs, nid
        assert ts.nodes[nid].alive == node.alive


class TestCheckpoint:
    def test_roundtrip(self):
        js, ts = _stores({i: 1.0 for i in range(6)}, 3)
        tree = _tree(np.random.default_rng(0))
        JManager(js).save(10, tree)
        mgr = CheckpointManager(ts)
        mgr.save(10, _torch_tree(tree))
        _same_blobs(js, ts)
        out = mgr.restore(10, _torch_tree(tree))
        assert torch.equal(out["w"], torch.from_numpy(tree["w"]))
        assert torch.equal(out["b"], torch.from_numpy(tree["b"]))
        assert torch.equal(out["nested"]["m"], torch.from_numpy(tree["nested"]["m"]))
        # NumPy leaves restore as NumPy arrays, as in the reference
        out_np = mgr.restore(10, tree)
        assert np.array_equal(out_np["nested"]["m"], tree["nested"]["m"])

    def test_survives_node_failures_below_replication(self):
        _, ts = _stores({i: 1.0 for i in range(6)}, 3)
        mgr = CheckpointManager(ts)
        tree = _torch_tree(_tree(np.random.default_rng(1)))
        mgr.save(1, tree)
        ts.fail_node(0)
        ts.fail_node(3)  # 2 < n_replicas failures
        out = mgr.restore(1, tree)
        assert torch.equal(out["w"], tree["w"])

    def test_repair_moves_only_victims_chunks(self):
        js, ts = _stores({i: 1.0 for i in range(8)}, 3)
        tree = _tree(np.random.default_rng(2))
        JManager(js).save(5, tree)
        mgr = CheckpointManager(ts)
        mgr.save(5, tree)
        victim_chunks = len(ts.nodes[2].blobs)
        moved = ts.remove_node_and_repair(2)
        assert moved == victim_chunks == js.remove_node_and_repair(2)
        _same_blobs(js, ts)
        out = mgr.restore(5, tree)
        assert np.array_equal(out["nested"]["m"], tree["nested"]["m"])
        assert all(node.alive for node in ts.nodes.values())

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_add_node_rebalances_minimally(self, backend):
        js, ts = _stores({i: 1.0 for i in range(4)}, 2)
        if backend != "device":
            ts.engine = ts.cluster._engine = PlacementEngine(
                ts.cluster, device="cpu", backend=backend)
        tree = _tree(np.random.default_rng(3))
        JManager(js).save(7, tree)
        mgr = CheckpointManager(ts)
        mgr.save(7, tree)
        keys = np.fromiter({k for n in ts.nodes.values() for k in n.blobs}, dtype=np.uint32)
        before = ts.replicas_for(keys)
        moved = ts.add_node(9, 1.0)
        after = ts.replicas_for(keys)
        want = sum(len(set(a.tolist()) - set(b.tolist())) for a, b in zip(after, before))
        assert moved == want == js.add_node(9, 1.0)
        _same_blobs(js, ts)
        out = mgr.restore(7, tree)
        assert np.array_equal(out["w"], tree["w"])

    def test_async_save_overlaps(self):
        _, ts = _stores({i: 1.0 for i in range(4)}, 2)
        mgr = CheckpointManager(ts)
        tree = _torch_tree(_tree(np.random.default_rng(4)))
        mgr.save_async(3, tree)
        mgr.wait()
        out = mgr.restore(3, tree)
        assert torch.equal(out["b"], tree["b"])
        assert mgr.saved_steps == [3]


def test_checkpoint_add_node_via_device_path():
    def build(backend):
        store = AsuraCheckpointStore({i: 1.0 for i in range(5)}, n_replicas=2, device="cpu")
        store.engine = store.cluster._engine = PlacementEngine(
            store.cluster, device="cpu", backend=backend)
        keys = np.arange(40, dtype=np.uint32)
        store.put_chunks(keys, [bytes([k % 251]) * 8 for k in keys])
        return store, store.add_node(9, 1.0)

    host_store, host_moved = build("numpy")
    dev_store, dev_moved = build("device")
    ref = JStore({i: 1.0 for i in range(5)}, n_replicas=2)
    ref.put_chunks(np.arange(40, dtype=np.uint32), [bytes([k % 251]) * 8 for k in range(40)])
    assert dev_moved == host_moved == ref.add_node(9, 1.0)
    _same_blobs(ref, dev_store)
    _same_blobs(ref, host_store)


def test_checkpoint_save_restore_spans():
    store = AsuraCheckpointStore({i: 1.0 for i in range(6)}, n_replicas=2, device="cpu")
    led = TraceLedger()
    mgr = CheckpointManager(store, ledger=led)
    tree = {"w": torch.arange(1000, dtype=torch.float32)}
    mgr.save(3, tree)
    out = mgr.restore(3, tree)
    assert torch.equal(out["w"], tree["w"])
    names = [e["name"] for e in led.events("span")]
    assert "checkpoint.save" in names and "checkpoint.restore" in names
    save_ev = [e for e in led.events("span") if e["name"] == "checkpoint.save"][0]
    assert save_ev["n_bytes"] == 4000 and save_ev["n_chunks"] >= 1
    assert led.counter("checkpoint.bytes_read") == 4000
    # the reference's ledger sees the same spans and counts
    jled = JLedger()
    jmgr = JManager(JStore({i: 1.0 for i in range(6)}, n_replicas=2), ledger=jled)
    jmgr.save(3, {"w": np.arange(1000, dtype=np.float32)})
    jmgr.restore(3, {"w": np.arange(1000, dtype=np.float32)})
    j_ev = [e for e in jled.events("span") if e["name"] == "checkpoint.save"][0]
    assert (j_ev["n_bytes"], j_ev["n_chunks"]) == (save_ev["n_bytes"], save_ev["n_chunks"])
    assert jled.counter("checkpoint.chunks_read") == led.counter("checkpoint.chunks_read")


# -- the three traps of carrying the store to torch -------------------------


def _nested(rng):
    """Leaf order differs from insertion order: plain dicts sort their
    keys, an OrderedDict (a state_dict) keeps them, None is dropped."""
    t = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "zeta": [t(3), None, (t(2, 2), t(5))],
        "alpha": collections.OrderedDict([("w", t(4, 3)), ("b", t(1))]),
        "mid": {"y": t(2), "x": None, "a": (t(6),)},
        "big": t(300_000),  # two chunks
    }


def _as_torch(tree):
    if tree is None:
        return None
    if isinstance(tree, collections.OrderedDict):
        return collections.OrderedDict((k, _as_torch(v)) for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return torch.from_numpy(tree.copy())


def test_leaf_order_and_chunk_keys_match_jax_tree_leaves():
    tree = _nested(np.random.default_rng(5))
    leaves = jax.tree.leaves(tree)
    js, ts = _stores({i: 1.0 for i in range(5)}, 2)
    JManager(js).save(11, tree)
    mgr = CheckpointManager(ts)
    mgr.save(11, _as_torch(tree))
    keys_of = lambda s: sorted({k for n in s.nodes.values() for k in n.blobs})  # noqa: E731
    assert keys_of(ts) == keys_of(js)
    want = {chunk_id(11, li, ci) for li, leaf in enumerate(leaves)
            for ci in range(max(1, -(-leaf.nbytes // CHUNK_BYTES)))}
    assert set(keys_of(ts)) == want
    _same_blobs(js, ts)
    out = mgr.restore(11, _as_torch(tree))
    assert isinstance(out["alpha"], collections.OrderedDict)
    assert list(out["alpha"]) == ["w", "b"] and list(out["mid"]) == ["y", "x", "a"]
    assert out["zeta"][1] is None and isinstance(out["zeta"][2], tuple)
    got = [x for x in (out["big"], *out["alpha"].values(), out["mid"]["a"][0],
                       out["mid"]["y"], out["zeta"][0], *out["zeta"][2])]
    want_t = [tree["big"], tree["alpha"]["w"], tree["alpha"]["b"], tree["mid"]["a"][0],
              tree["mid"]["y"], tree["zeta"][0], *tree["zeta"][2]]
    for g, w in zip(got, want_t):
        assert torch.equal(g, torch.from_numpy(w))


def test_save_async_snapshots_at_call_time():
    _, ts = _stores({i: 1.0 for i in range(4)}, 2)
    mgr = CheckpointManager(ts)
    state = {"w": torch.arange(400_000, dtype=torch.float32), "b": torch.ones(3)}
    old = {k: v.clone() for k, v in state.items()}
    mgr.save_async(1, state)
    state["w"].add_(1.0)  # an optimizer step right after the call
    state["b"].zero_()
    mgr.wait()
    out = mgr.restore(1, state)
    assert torch.equal(out["w"], old["w"]) and torch.equal(out["b"], old["b"])
    assert not torch.equal(out["w"], state["w"])


def test_bfloat16_round_trip_and_reference_bytes():
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((257, 33)).astype(np.float32))
    tree = {"bf": w.to(torch.bfloat16), "i8": torch.arange(-5, 5, dtype=torch.int8),
            "scalar": torch.tensor(3.5, dtype=torch.float64)}
    js, ts = _stores({i: 1.0 for i in range(4)}, 2)
    mgr = CheckpointManager(ts)
    mgr.save(2, tree)
    out = mgr.restore(2, tree)
    for k, v in tree.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape and torch.equal(out[k], v)
    # the reference writes bfloat16 through ml_dtypes: the same bytes
    jtree = {"bf": jnp.asarray(w.numpy(), dtype=jnp.bfloat16),
             "i8": np.arange(-5, 5, dtype=np.int8), "scalar": np.float64(3.5)}
    JManager(js).save(2, jtree)
    _same_blobs(js, ts)
    back = JManager(js).restore(2, jtree)
    assert np.array_equal(np.asarray(back["bf"]).view(np.uint16),
                          tree["bf"].view(torch.int16).numpy().view(np.uint16))
    assert np.asarray(back["bf"]).dtype == ml_dtypes.bfloat16


def test_reference_store_restores_through_the_port():
    js = JStore({i: 1.0 + 0.25 * (i % 3) for i in range(7)}, n_replicas=3)
    tree = _nested(np.random.default_rng(7))
    jm = JManager(js)
    jm.save(4, tree)
    js.fail_node(5)
    ts = convert.checkpoint_store_from_reference(
        js.cluster.to_json(), {nid: n.blobs for nid, n in js.nodes.items()}, 3,
        alive={nid: n.alive for nid, n in js.nodes.items()}, device="cpu",
    )
    _same_blobs(js, ts)
    out = CheckpointManager(ts).restore(4, _as_torch(tree))
    for got, want in zip(jax.tree.leaves(_flatten_torch(out)), jax.tree.leaves(tree)):
        assert np.array_equal(got, want)
    # and the store lives on: a repair there equals the reference's
    assert ts.remove_node_and_repair(5) == js.remove_node_and_repair(5)
    _same_blobs(js, ts)


def _flatten_torch(tree):
    """``tree`` with tensors as NumPy arrays (jax.tree.leaves then walks it)."""
    if isinstance(tree, collections.OrderedDict):
        return collections.OrderedDict((k, _flatten_torch(v)) for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: _flatten_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten_torch(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("event", ["add", "remove"])
def test_live_store_migration_matches_reference(event):
    """A throttled live add / removal: the same plan, the same landing
    copies round by round, restores exact mid-drain."""
    caps = {i: 1.0 for i in range(6)}
    js, ts = _stores(caps, 3)
    tree = _tree(np.random.default_rng(8))
    JManager(js).save(1, tree)
    mgr = CheckpointManager(ts)
    mgr.save(1, tree)
    clock = {"now": 0.0}
    kw = dict(ingress=4, clock=lambda: clock["now"], round_seconds=1.0)
    if event == "add":
        jm, tm = js.begin_add_node(6, 1.5, **kw), ts.begin_add_node(6, 1.5, **kw)
    else:
        jm, tm = js.begin_remove_node(2, **kw), ts.begin_remove_node(2, **kw)
    for f in ("ids", "src", "dst", "slot", "src_slot"):
        assert np.array_equal(getattr(tm.live.state.plan, f), getattr(jm.live.state.plan, f))
    while not tm.done:
        clock["now"] += 1.0
        assert tm.pump() == jm.pump()
        _same_blobs(js, ts)
        out = mgr.restore(1, tree)
        assert np.array_equal(out["w"], tree["w"])
    assert jm.done and tm.copies_moved == jm.copies_moved
    assert ts._migration is None


# ---------------------------------------------------------------------------
# elastic coordinator
# ---------------------------------------------------------------------------


def _coords(jc, ids, backend="device", **kw):
    tc = _port(jc, backend)
    return JCoordinator(jc, ids, **kw), ElasticCoordinator(tc, ids, **kw), tc


def _same_event(jcoord, tcoord, jfn, tfn):
    want, got = jfn(jcoord), tfn(tcoord)
    assert got.moves == want.moves
    assert np.array_equal(tcoord.owners(), jcoord.owners())
    return got


class TestElasticCoordinator:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_add_plan_matches_bruteforce(self, backend):
        ids = np.arange(3000, dtype=np.uint32)
        jcoord, coord, tc = _coords(j_uniform(6), ids, backend)
        brute_before = tc.place_nodes(ids)
        plan = _same_event(jcoord, coord, lambda c: c.add_node(6, 1.0),
                           lambda c: c.add_node(6, 1.0))
        brute_after = tc.place_nodes(ids)
        moved = np.nonzero(brute_before != brute_after)[0]
        assert set(plan.moves) == {int(ids[i]) for i in moved}
        assert all(dst == 6 for _, dst in plan.moves.values())
        assert np.array_equal(coord.owners(), brute_after)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_remove_plan_matches_bruteforce(self, backend):
        ids = np.arange(3000, dtype=np.uint32)
        jcoord, coord, tc = _coords(j_uniform(6), ids, backend)
        brute_before = tc.place_nodes(ids)
        plan = _same_event(jcoord, coord, lambda c: c.remove_node(2),
                           lambda c: c.remove_node(2))
        brute_after = tc.place_nodes(ids)
        moved = np.nonzero(brute_before != brute_after)[0]
        assert set(plan.moves) == {int(ids[i]) for i in moved}
        assert all(src == 2 for src, _ in plan.moves.values())
        assert np.array_equal(coord.owners(), brute_after)

    def test_heterogeneous_capacity_add(self):
        ids = np.arange(2000, dtype=np.uint32)
        jcoord, coord, tc = _coords(_hetero(), ids)
        before = tc.place_nodes(ids)
        plan = _same_event(jcoord, coord, lambda c: c.add_node(10, 1.4),
                           lambda c: c.add_node(10, 1.4))
        after = tc.place_nodes(ids)
        moved = np.nonzero(before != after)[0]
        assert set(plan.moves) == {int(ids[i]) for i in moved}

    def test_sequence_of_events(self):
        ids = np.arange(1500, dtype=np.uint32)
        jcoord, coord, tc = _coords(j_uniform(5), ids)
        for event in [("add", 5, 1.0), ("rm", 1, None), ("add", 6, 0.5), ("rm", 5, None)]:
            if event[0] == "add":
                _same_event(jcoord, coord, lambda c: c.add_node(event[1], event[2]),
                            lambda c: c.add_node(event[1], event[2]))
            else:
                _same_event(jcoord, coord, lambda c: c.remove_node(event[1]),
                            lambda c: c.remove_node(event[1]))
            assert np.array_equal(coord.owners(), tc.place_nodes(ids))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("event", ["add", "remove"])
def test_replica_coordinator_matches_reference(event, backend):
    ids = np.random.default_rng(9).integers(0, 2**32, 2500, dtype=np.uint32)
    jcoord, coord, tc = _coords(_hetero((1.0, 0.6, 1.3, 2.0, 0.9, 1.1)), ids, backend,
                                n_replicas=3)
    assert np.array_equal(coord.owners(), jcoord.owners())
    if event == "add":
        _same_event(jcoord, coord, lambda c: c.add_node(9, 1.2), lambda c: c.add_node(9, 1.2))
    else:
        _same_event(jcoord, coord, lambda c: c.remove_node(3), lambda c: c.remove_node(3))
    assert np.array_equal(coord.owners(), tc.place_replicas(ids, 3))
    for i in (0, 17, 2499):
        assert coord.remove_numbers_for(int(ids[i]), 3) == jcoord.remove_numbers_for(
            int(ids[i]), 3)
    assert np.array_equal(coord.remove_numbers_batch(ids[:300], 3),
                          jcoord.remove_numbers_batch(ids[:300], 3))


@pytest.mark.parametrize("algorithm", ["ch", "rs", "wrh"])
def test_baseline_coordinator_matches_reference(algorithm):
    ids = np.random.default_rng(10).integers(0, 2**32, 3000, dtype=np.uint32)
    jcoord, coord, _ = _coords(_hetero((1.0, 0.6, 1.3, 2.0, 0.9)), ids, algorithm=algorithm)
    assert np.array_equal(coord.owners(), jcoord.owners())
    add = _same_event(jcoord, coord, lambda c: c.add_node(7, 1.5), lambda c: c.add_node(7, 1.5))
    assert add.n_moves > 0
    _same_event(jcoord, coord, lambda c: c.remove_node(1), lambda c: c.remove_node(1))
    with pytest.raises(ValueError, match="live"):
        coord.add_node_live(8, 1.0)
    with pytest.raises(ValueError, match="replica-set"):
        ElasticCoordinator(_port(j_uniform(4)), ids, algorithm=algorithm, n_replicas=3)


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("event", ["add", "remove"])
def test_live_events_and_rollback_match_reference(event, R):
    ids = np.random.default_rng(11).integers(0, 2**32, 2000, dtype=np.uint32)
    jcoord, coord, tc = _coords(_hetero((1.0, 0.6, 1.3, 2.0, 0.9, 1.1)), ids, n_replicas=R)
    if event == "add":
        jm, tm = jcoord.add_node_live(9, 1.4, ingress=40), coord.add_node_live(9, 1.4, ingress=40)
    else:
        jm, tm = jcoord.remove_node_live(2, ingress=40), coord.remove_node_live(2, ingress=40)
    for f in ("ids", "src", "dst", "slot", "src_slot"):
        assert np.array_equal(getattr(tm.state.plan, f), getattr(jm.state.plan, f))
    assert np.array_equal(coord.owners(), jcoord.owners())
    with pytest.raises(RuntimeError, match="already in flight"):
        coord.add_node(20, 1.0)
    assert tm.round() == jm.round()
    probe = ids[:400]
    route = (lambda m: m.route_replicas(probe)) if R > 1 else (lambda m: m.route(probe))
    assert np.array_equal(route(tm), route(jm))
    if event == "remove":
        with pytest.raises(ValueError, match="only add-node"):
            coord.rollback_live(tm)
        assert tm.run() == jm.run()
        return
    with pytest.raises(RuntimeError, match="rollback_live"):
        tm.rollback()  # a bare reversal would desync the coordinator
    rj, rt = jcoord.rollback_live(jm), coord.rollback_live(tm)
    assert np.array_equal(coord.owners(), jcoord.owners())
    assert sorted(tc.nodes) == sorted(jcoord.cluster.nodes)
    assert rt.run() == rj.run()
    assert np.array_equal(coord.owners(), (tc.place_replicas(ids, R) if R > 1
                                           else tc.place_nodes(ids)))
    with pytest.raises(ValueError, match="in-flight"):
        coord.rollback_live(tm)


# ---------------------------------------------------------------------------
# failure detection, repair driving, stragglers
# ---------------------------------------------------------------------------


class TestFailureDetection:
    def test_heartbeat_timeout(self):
        for tracker_cls in (HeartbeatTracker, JTracker):
            t = {"now": 0.0}
            tracker = tracker_cls(timeout=5.0, clock=lambda: t["now"])
            tracker.beat(0)
            tracker.beat(1)
            t["now"] = 4.0
            tracker.beat(1)
            t["now"] = 7.0
            assert tracker.dead_nodes() == [0]

    def test_detector_fires_once(self):
        t = {"now": 0.0}
        tracker = HeartbeatTracker(timeout=1.0, clock=lambda: t["now"])
        tracker.beat(0)
        fired = []
        det = FailureDetector(tracker, on_failure=fired.append)
        t["now"] = 3.0
        assert det.poll() == [0]
        assert det.poll() == []
        assert fired == [0]
        det.clear(0)  # recovered: a later failure fires again
        assert det.poll() == [0]

    def test_end_to_end_failure_recovery(self):
        """Heartbeat loss -> store repair -> restore still works, and the
        store holds what the reference's holds after the same repair."""
        js, ts = _stores({i: 1.0 for i in range(6)}, 3)
        tree = {"w": np.arange(100, dtype=np.float32)}
        JManager(js).save(1, tree)
        mgr = CheckpointManager(ts)
        mgr.save(1, {"w": torch.from_numpy(tree["w"].copy())})
        t = {"now": 0.0}
        tracker = HeartbeatTracker(timeout=2.0, clock=lambda: t["now"])
        for nid in ts.nodes:
            tracker.beat(nid)
        det = FailureDetector(tracker, on_failure=ts.remove_node_and_repair)
        t["now"] = 3.0
        for nid in list(ts.nodes):
            if nid != 4:
                tracker.beat(nid)
        t["now"] = 4.0  # node 4 last seen at 0 -> dead; others at 3 -> alive
        assert det.poll() == [4]
        js.remove_node_and_repair(4)
        _same_blobs(js, ts)
        out = mgr.restore(1, tree)
        assert np.array_equal(out["w"], tree["w"])


def test_migration_driver_repairs_match_reference():
    """Two deaths -> two serialized throttled replica repairs through the
    coordinator, paced by the clock that declared them dead."""
    ids = np.random.default_rng(12).integers(0, 2**32, 1500, dtype=np.uint32)
    jcoord, coord, _ = _coords(j_uniform(8), ids, n_replicas=3)
    drivers = []
    for c, tracker_cls, driver_cls in ((jcoord, JTracker, JDriver),
                                       (coord, HeartbeatTracker, MigrationDriver)):
        t = {"now": 0.0}
        tracker = tracker_cls(timeout=2.0, clock=lambda t=t: t["now"])
        for nid in range(8):
            tracker.beat(nid)
        start = (lambda c, t: lambda nid: c.remove_node_live(
            nid, ingress=30, clock=lambda: t["now"], round_seconds=1.0))(c, t)
        drivers.append((driver_cls(tracker, start), tracker, t))
    history = []
    for d, tracker, t in drivers:
        t["now"] = 3.0
        for nid in range(8):
            if nid not in (1, 6):
                tracker.beat(nid)
        out = [d.poll()]
        while not d.done:
            t["now"] += 1.0
            out.append(d.pump())
        out.append(len(d.completed))
        history.append(out)
    assert history[0] == history[1]
    assert history[1][0] == [1, 6] and history[1][-1] == 2
    assert np.array_equal(coord.owners(), jcoord.owners())


class TestStraggler:
    def test_backup_dispatch(self):
        out = []
        for cls in (StragglerMitigator, JStraggler):
            t = {"now": 0.0}
            mit = cls(clock=lambda: t["now"], threshold=2.0)
            for sid, host in [(0, 0), (1, 1), (2, 2)]:
                mit.start(sid, host)
            t["now"] = 1.0
            mit.complete(0)
            mit.complete(1)
            t["now"] = 5.0  # shard 2 is now > 2x median (1.0)
            backups = mit.dispatch_backups([0, 1, 2, 3], load={})
            assert backups and backups[0][0] == 2
            assert backups[0][1] != 2
            out.append(backups)
        assert out[0] == out[1]

    def test_no_duplicate_backups(self):
        t = {"now": 0.0}
        mit = StragglerMitigator(clock=lambda: t["now"], threshold=2.0)
        mit.start(0, 0)
        mit.start(1, 1)
        t["now"] = 1.0
        mit.complete(0)
        t["now"] = 10.0
        first = mit.dispatch_backups([0, 1], load={})
        second = mit.dispatch_backups([0, 1], load={})
        assert len(first) == 1 and second == []
