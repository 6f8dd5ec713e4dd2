"""The port's PlacementEngine, cluster and ops against the reference's.

A reference cluster (mutated, so the table has holes and a free-segment
heap) is carried across with ``convert.cluster_from_reference_json``; every
ported engine method must then give the reference engine's answer bit for
bit, on the port's ``device`` backend (twins on ``device="cpu"``) and its
``numpy`` backend.  Also: one table upload per version, the 4-deep LRU,
and the card-by-default contract.
"""

import numpy as np
import pytest
import torch

from repro.core import PlacementEngine as JEngine
from repro.core import make_cluster as j_make_cluster
from repro.core import make_uniform_cluster as j_make_uniform
from repro.core.asura import AsuraParams, place_batch
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import Cluster, PlacementEngine, make_cluster
from repro_torch.core.engine import CACHE_VERSIONS
from repro_torch.kernels import ops

CAPS = [0.3, 1.7, 2.0, 0.9, 1.0, 0.5, 1.25, 0.75, 3.0, 0.6]


def _reference_cluster():
    c = j_make_cluster(CAPS)
    c.remove_node(3)
    c.add_node(42, 1.4)
    c.resize_node(1, 2.6)
    return c


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


def test_cluster_carries_across_in_the_same_blob():
    ref_c = _reference_cluster()
    c = convert.cluster_from_reference_json(ref_c.to_json(), device="cpu")
    assert isinstance(c, Cluster)
    assert c.to_json() == ref_c.to_json()
    assert c.version == ref_c.version
    assert np.array_equal(c.seg_lengths(), ref_c.seg_lengths())
    assert np.array_equal(c.seg_to_node(), ref_c.seg_to_node())
    # STEP-1 mutations keep agreeing after the carry-over
    ref_c.add_node(77, 0.8)
    c.add_node(77, 0.8)
    assert c.to_json() == ref_c.to_json()


@pytest.mark.parametrize("backend", ["device", "numpy"])
def test_host_methods_match_reference(backend):
    ref_c = _reference_cluster()
    c = convert.cluster_from_reference_json(ref_c.to_json())
    eng = PlacementEngine(c, device="cpu", backend=backend)
    ref_eng = JEngine(ref_c, backend="numpy")
    ids = _ids(3000)
    assert np.array_equal(eng.place(ids), ref_eng.place(ids))
    assert np.array_equal(eng.place_nodes(ids), ref_eng.place_nodes(ids))
    assert np.array_equal(eng.place_replicas(ids, 3), ref_eng.place_replicas(ids, 3))
    assert np.array_equal(
        eng.place_replica_nodes(ids, 3), ref_eng.place_replica_nodes(ids, 3)
    )
    assert eng.uploads == 1


@pytest.mark.parametrize("backend", ["device", "numpy"])
def test_device_methods_match_reference(backend):
    ref_c = _reference_cluster()
    c = convert.cluster_from_reference_json(ref_c.to_json())
    eng = PlacementEngine(c, device="cpu", backend=backend)
    ref_eng = JEngine(ref_c, backend="ref")
    ids = _ids(2500, seed=1)
    out = eng.place_device(ids)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    assert np.array_equal(out.numpy(), np.asarray(ref_eng.place_device(ids)))
    assert np.array_equal(eng.place_nodes_device(torch.from_numpy(ids)).numpy(),
                          np.asarray(ref_eng.place_nodes_device(ids)))
    for R in (1, 2, 3):
        assert np.array_equal(
            eng.place_replica_nodes_device(ids, R).numpy(),
            np.asarray(ref_eng.place_replica_nodes_device(ids, R)),
        )
    assert eng.uploads == 1  # device tables ride the same materialization


def test_forced_tail_through_the_engine():
    params = AsuraParams(max_draws=0)
    ref_c = j_make_uniform(100, params=params)
    c = convert.cluster_from_reference_json(ref_c.to_json(), device="cpu")
    ids = np.arange(20_000, dtype=np.uint32)
    want = place_batch(ids, ref_c.seg_lengths(), params)
    assert np.array_equal(c.engine.place_device(ids).numpy(), want)
    assert np.array_equal(c.engine.place_nodes(ids), ref_c.seg_to_node()[want])


def test_one_upload_per_version_and_lru():
    c = make_cluster(CAPS, device="cpu")
    eng = c.engine
    ids = _ids(64)
    for _ in range(5):
        eng.place_nodes(ids)
        eng.place_nodes_device(ids)
        eng.place_replica_nodes_device(ids, 2)
    assert eng.uploads == 1
    versions = [c.version]
    for i in range(CACHE_VERSIONS):
        c.add_node(100 + i, 1.0)
        eng.place_nodes(ids)
        versions.append(c.version)
    assert eng.uploads == 1 + CACHE_VERSIONS
    assert [e["version"] for e in eng.ledger.events("engine.upload")] == versions
    # 5 versions, 4 kept: the oldest is evicted, once
    assert eng.ledger.counter("engine.lru_evictions") == 1
    assert [e["version"] for e in eng.ledger.events("engine.lru_evict")] == versions[:1]


def test_artifact_from_reference_arrays():
    ref_c = _reference_cluster()
    ref_art = JEngine(ref_c, backend="numpy").artifact()
    art = convert.artifact_from_arrays(
        ref_art.len32, ref_art.node_of, ref_art.top_level, ref_art.version,
        device="cpu",
    )
    eng = PlacementEngine(convert.cluster_from_reference_json(ref_c.to_json()),
                          device="cpu")
    mine = eng.artifact()
    assert (art.version, art.n_segs, art.top_level) == (
        mine.version, mine.n_segs, mine.top_level)
    for name in ("len32_dev", "cum_hi_dev", "cum_lo_dev", "node_of_dev"):
        assert torch.equal(getattr(art, name), getattr(mine, name)), name
    ids = _ids(1000, seed=3)
    got = ops.place_nodes_on_table_device(
        ids, art.len32_dev, art.cum_hi_dev, art.cum_lo_dev, art.node_of_dev,
        top_level=art.top_level,
    )
    assert np.array_equal(got.numpy(), ref_c.seg_to_node()[place_batch(ids, ref_c.seg_lengths())])


@pytest.mark.parametrize("batch", [0, 2049])
def test_ops_entry_points_match_reference(batch):
    ref_c = _reference_cluster()
    ids = _ids(batch, seed=batch)
    lengths, nodes = ref_c.seg_lengths(), ref_c.seg_to_node()
    want = np.asarray(jops.asura_place(ids, lengths, use_pallas=False))
    got = ops.asura_place(ids, lengths, device="cpu")
    assert np.array_equal(got.numpy(), want)
    got_n = ops.asura_place_nodes(ids, lengths, nodes, device="cpu")
    assert np.array_equal(got_n.numpy(), np.asarray(
        jops.asura_place_nodes(ids, lengths, nodes, use_pallas=False)))
    len32, top = ops.table_prep(lengths, device="cpu")
    assert np.array_equal(ops.place_on_table(ids, len32, top_level=top), want)
    if batch:
        got_r = ops.asura_place_replicas(ids, lengths, nodes, 3, device="cpu")
        assert np.array_equal(got_r.numpy(), np.asarray(
            jops.asura_place_replicas(ids, lengths, nodes, 3, use_pallas=False)))


def test_replicas_raise_without_enough_nodes():
    c = make_cluster([1.0, 1.0], params=AsuraParams(max_draws=8), device="cpu")
    with pytest.raises(RuntimeError):
        c.engine.place_replicas(_ids(100), 3)
    out = c.engine.place_replica_nodes_device(_ids(100), 3)  # documented -1
    assert (out[:, 2] == -1).all() and (out[:, :2] >= 0).all()


def test_default_device_is_the_card():
    """Without a card the default engine raises instead of running the
    twins on the host; with one it places on it."""
    c = make_cluster(CAPS)
    if torch.cuda.is_available():
        assert PlacementEngine(c).device.type == "cuda"
        assert c.engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PlacementEngine(c)
        with pytest.raises(RuntimeError, match="CUDA"):
            c.engine
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.asura_place(_ids(4), c.seg_lengths())


def test_unported_paths_raise():
    c = make_cluster(CAPS, device="cpu")
    with pytest.raises(ValueError, match="algorithm must be one of"):
        PlacementEngine(c, device="cpu", algorithm="straw")
    with pytest.raises(ValueError, match="algorithm must be one of"):
        c.engine.place_nodes(_ids(4), algorithm="hrw")

    with pytest.raises(ValueError):
        PlacementEngine(c, device="cpu", backend="pallas")


# ---------------------------------------------------------------------------
# the small surface: invalidate, place_nodes_batch, the core re-exports,
# the rng helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ["asura", "ch", "rs"])
def test_invalidate_rebuilds_like_the_reference(algorithm):
    ref_c = _reference_cluster()
    c = convert.cluster_from_reference_json(ref_c.to_json(), device="cpu")
    eng = PlacementEngine(c, device="cpu", algorithm=algorithm)
    ref_eng = JEngine(ref_c, backend="numpy", algorithm=algorithm)
    ids = _ids(2000, seed=4)
    for e in (eng, ref_eng):
        e.place_nodes(ids)
        e.invalidate()
        assert e.uploads == 1
    assert np.array_equal(eng.place_nodes(ids), ref_eng.place_nodes(ids))
    assert eng.uploads == ref_eng.uploads == 2
    v = c.version
    c.add_node(99, 1.0)
    eng.invalidate()
    with pytest.raises(KeyError):
        eng.artifact_for(v)


def test_place_nodes_batch_and_core_exports_match_reference():
    import repro.core as jcore
    import repro_torch.core as tcore
    from repro_torch.core.asura import place_nodes_batch

    ref_c = _reference_cluster()
    ids = _ids(3000, seed=5)
    got = place_nodes_batch(ids, ref_c.seg_lengths(), ref_c.seg_to_node())
    want = jcore.place_nodes_batch(ids, ref_c.seg_lengths(), ref_c.seg_to_node())
    assert np.array_equal(got, want)
    # every host oracle the reference's core exports, the port's exports too
    assert set(jcore.__all__) <= set(tcore.__all__)
    lengths, nodes = ref_c.seg_lengths(), ref_c.seg_to_node()
    for name in ("place_batch", "resolve_tail_np", "tail_cumsum_halves"):
        assert getattr(tcore, name) is not None
    assert np.array_equal(tcore.place_batch(ids, lengths), jcore.place_batch(ids, lengths))
    assert np.array_equal(tcore.place_replicas_batch(ids, lengths, nodes, 3),
                          jcore.place_replicas_batch(ids, lengths, nodes, 3))
    for a, b in zip(tcore.tail_cumsum_halves(np.arange(7, dtype=np.uint32) * 2**30),
                    jcore.tail_cumsum_halves(np.arange(7, dtype=np.uint32) * 2**30)):
        assert np.array_equal(a, b)


def test_rng_helpers_match_reference():
    from repro.core import rng as jrng
    from repro_torch.core import rng as trng

    ids = _ids(1000, seed=6)
    for lvl, ctr in ((0, 0), (5, 17)):
        assert np.array_equal(trng.draw_u01_np(ids, lvl, ctr), jrng.draw_u01_np(ids, lvl, ctr))
        for i in ids[:20].tolist():
            assert trng.draw_u01_scalar(i, lvl, ctr) == jrng.draw_u01_scalar(i, lvl, ctr)
    for s in ("", "node-7", "rack/α/12", "x" * 300):
        assert trng.hash_str_to_u32(s) == jrng.hash_str_to_u32(s)
