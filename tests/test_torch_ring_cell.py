"""The consistent-hashing cell's yardstick against the port and the JAX
reference, on the CPU.

``chipbench/reference/ring.py`` is the plain reference that the benchmark
cell ``ch10000.bulk`` holds the port's CH fan-out to, and
``chipbench/harness/ring_bounds.py`` the operation count of its roofline
share.  Here:

  * the port's ``PlacementEngine(cluster, algorithm="ch",
    virtual_nodes=100)`` on its CPU twin path gives the reference's ring
    and its replica sets, set for set, on a 200-node and on the paper's
    10,000-node cluster (10^6 points, duplicated points among them), for
    seeded ids and for ids whose hash lands on a point or beside it;
  * the reference's ring and sets are the JAX reference's;
  * the bound's operation count is the hand-worked one.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from chipbench.harness import bounds, ring_bounds  # noqa: E402
from chipbench.reference.ring import Counts, ring, ring_sets  # noqa: E402
from repro_torch.core import PlacementEngine, make_cluster  # noqa: E402

M32 = 0xFFFFFFFF
V = 100  # the paper's CH setting
BATCH = (1 << 12) + 13
CLUSTERS = (200, 10_000)


@functools.cache
def _shared(n_nodes):
    """One CH engine on ``n_nodes`` equal nodes and the reference's ring."""
    cluster = make_cluster([1.0] * n_nodes, device="cpu")
    eng = PlacementEngine(cluster, device="cpu", algorithm="ch", virtual_nodes=V)
    return eng, ring(range(n_nodes), V)


def _ids(n=BATCH, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32))


def _unfmix32(h: np.ndarray) -> np.ndarray:
    """Ids whose ``fmix32`` is ``h`` (the finalizer is a bijection)."""
    h = h.astype(np.uint64)
    h ^= h >> 16
    h = (h * pow(0xC2B2AE35, -1, 2**32)) & M32
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * pow(0x85EBCA6B, -1, 2**32)) & M32
    h ^= h >> 16
    return h.astype(np.uint32)


def _edge_ids(points: torch.Tensor, seed=0) -> torch.Tensor:
    """Ids hashing to 0, 0xFFFFFFFF, the duplicated points and a sample of
    the others, and their neighbours."""
    p = points.numpy()
    dup = p[1:][p[1:] == p[:-1]]
    some = np.random.default_rng(seed).choice(p, 2000, replace=False)
    h = np.concatenate([[0, 1, M32 - 1, M32, int(p[0]), int(p[-1])], dup, some])
    h = np.concatenate([h, h - 1, h + 1])
    h = np.unique(np.clip(h, 0, M32)).astype(np.uint32)
    return torch.from_numpy(_unfmix32(h))


# -- the ring ----------------------------------------------------------------------


@pytest.mark.parametrize("n_nodes", CLUSTERS)
def test_the_engines_ring_is_the_references(n_nodes):
    eng, (points, owners) = _shared(n_nodes)
    art = eng.artifact()
    assert art.n_entries == n_nodes * V == points.shape[0]
    assert np.array_equal(art.keys.astype(np.int64), points.numpy())
    assert np.array_equal(art.vals.astype(np.int64), owners.numpy())
    n = points.shape[0]
    assert torch.equal(art.keys_dev[:n].to(torch.int64) & M32, points)
    assert torch.equal(art.vals_dev[:n].to(torch.int64), owners)


def test_the_papers_ring_holds_duplicated_points_in_node_order():
    _, (points, owners) = _shared(10_000)
    same = torch.nonzero(points[1:] == points[:-1]).flatten()
    assert same.numel() > 0  # ~116 expected among 10^6 u32 points
    assert bool((owners[same] <= owners[same + 1]).all())


def test_the_references_ring_is_the_jax_references():
    from repro.core import build_ring as j_build_ring

    keys, vals = j_build_ring(range(200), V)
    points, owners = ring(range(200), V)
    assert np.array_equal(keys.astype(np.int64), points.numpy())
    assert np.array_equal(vals.astype(np.int64), owners.numpy())


# -- the replica sets ----------------------------------------------------------------


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("n_nodes", CLUSTERS)
@pytest.mark.parametrize("ids", ["seeded", "edges"])
def test_the_engines_sets_are_the_references(n_nodes, R, ids):
    eng, (points, owners) = _shared(n_nodes)
    x = _ids(seed=n_nodes + R) if ids == "seeded" else _edge_ids(points, seed=R)
    got = eng.place_replica_nodes_device(x, R)
    want = ring_sets(x, points, owners, R)
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], R)
    assert torch.equal(got.to(torch.int64), want)
    if R == 3:
        assert bool((want >= 0).all())
        assert bool((want[:, 0] != want[:, 1]).all() & (want[:, 0] != want[:, 2]).all()
                    & (want[:, 1] != want[:, 2]).all())


def test_the_references_sets_are_the_jax_references():
    from repro.kernels.baselines import baseline_place_replicas_np as j_fanout

    points, owners = ring(range(200), V)
    x = _ids(seed=9)
    want = j_fanout("ch", x.numpy(), points.numpy().astype(np.uint32),
                    owners.numpy().astype(np.int32), 3)
    assert np.array_equal(ring_sets(x, points, owners, 3).numpy(), want)


def test_the_float32_control_changes_answers_on_the_papers_ring():
    _, (points, owners) = _shared(10_000)
    x = _ids(seed=5)
    exact = ring_sets(x, points, owners, 3)
    control = ring_sets(x, points, owners, 3, number="float32")
    assert int((exact != control).sum()) > 0.005 * exact.numel()


# -- the bound ---------------------------------------------------------------------


@pytest.mark.parametrize("n_points,steps", [(1, 1), (2, 1), (3, 2), (1000, 10), (1024, 10),
                                            (1025, 11), (10**6, 20)])
def test_search_steps_are_ceil_log2(n_points, steps):
    assert ring_bounds.search_steps(n_points) == steps


def test_the_fanout_bound_on_a_hand_worked_case():
    # 4 ids, R = 3, a ring of 1000 points: 10 search steps, a lookup
    # 8 + 6 * 10 + 3 = 71; 9 lookups, 5 of them re-lookups at 8 + 2 + 3 =
    # 13 more each, 4 seeds of 9
    c = {"lookups": 9, "relookups": 5, "seeded": 4}
    nbytes, ops = ring_bounds.fanout(4, 3, 1000, c)
    assert nbytes == 4 * 4 + 4 * 3 * 4 + 8 * 1000
    assert ops == 71 * 9 + 13 * 5 + 9 * 4 == 740
    assert bounds.least_seconds(nbytes, ops) == max(8064 / bounds.HBM_BYTES_PER_S,
                                                    740 / bounds.INT32_OPS_PER_S)


def test_the_reference_counts_its_lookups():
    points, owners = ring(range(3), V)
    x = _ids(64, seed=3)
    c = Counts()
    out = ring_sets(x, points, owners, 3, counts=c)
    assert bool((out >= 0).all())
    # every id re-looks up until its third node: at least twice
    assert c["seeded"] == 64 and c["relookups"] >= 128
    assert c["lookups"] == 64 + c["relookups"]
    one = Counts()
    ring_sets(x, points, owners, 1, counts=one)
    assert dict(one) == {"lookups": 64, "relookups": 0, "seeded": 0}
