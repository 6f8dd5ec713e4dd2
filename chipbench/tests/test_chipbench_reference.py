"""The benchmark's reference and input generators, on the CPU.

The reference is written from the algorithm, not imported from the
program; these tests hold it to the program's semantics at small sizes
(the program's CPU path is its plain-torch twin), to published test
vectors, and to the arithmetic of the sources it copies.
"""

import numpy as np
import pytest
import torch

from chipbench.harness import inputs
from chipbench.harness.ycsb import fnvhash64_mod, zipfian_values
from chipbench.reference.asura import Counts
from chipbench.reference.placement import align, flat_sets, rack_sets
from chipbench.reference.tables import HierarchyModel, TableModel
from chipbench.reference.threefry import M32, fold_in, lane_words, stream_key, threefry2x32

CPU = torch.device("cpu")


def test_threefry_known_answers():
    # Random123's kat_vectors: threefry2x32, 20 rounds: counter, key -> output
    for ctr, key, want in (
        ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
        ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
        ((0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344), (0xC4923A9C, 0x483DF7A0)),
    ):
        assert threefry2x32(key[0], key[1], ctr[0], ctr[1]) == want


@pytest.mark.parametrize("seed,step", [(0, 0), (2**31 - 1, 917), (-7, 2**31 + 5)])
def test_lane_words_are_the_cipher_per_lane(seed, step):
    # the int32 cipher of lane_words against the int64 one, lanes over 2**31 included
    lanes = torch.cat([torch.arange(4096), torch.arange(2**32 - 4096, 2**32)])
    key = stream_key(seed)
    k0, k1 = fold_in(fold_in(key, step), lanes & M32)
    want = torch.stack([a ^ b for a, b in (threefry2x32(k0, k1, 0, j) for j in range(2))], dim=1)
    assert torch.equal(lane_words(key, step, lanes, 2), want)


def _java_fnv_mod(v: int, m: int) -> int:
    """YCSB's Utils.fnvhash64 in Java's signed 64-bit arithmetic, then % m."""
    h = 0xCBF29CE484222325
    for _ in range(8):
        h ^= v & 0xFF
        v >>= 8
        h = (h * 1099511628211) & (2**64 - 1)
    signed = h - 2**64 if h >= 2**63 else h
    return abs(signed) % m


def test_fnvhash64_is_ycsbs():
    vals = [0, 1, 2, 255, 256, 12345, 10**10, 2**33 + 7] + list(range(1000, 1100))
    got = fnvhash64_mod(torch.tensor(vals, dtype=torch.int64), 1 << 24)
    assert got.tolist() == [_java_fnv_mod(v, 1 << 24) for v in vals]
    got = fnvhash64_mod(torch.tensor(vals, dtype=torch.int64), 1_000_003)
    assert got.tolist() == [_java_fnv_mod(v, 1_000_003) for v in vals]


def test_zipfian_is_ycsbs_formula():
    items, theta, zetan = 10**10 + 1, 0.99, 26.46902820178302
    zeta2 = 1 + 0.5**theta
    eta = (1 - (2.0 / items) ** (1 - theta)) / (1 - zeta2 / zetan)
    us = [0.0, 0.01, 0.0377, 0.05, 0.3, 0.5, 0.9, 0.999999]
    want = []
    for u in us:
        if u * zetan < 1:
            want.append(0)
        elif u * zetan < 1 + 0.5**theta:
            want.append(1)
        else:
            want.append(int(items * (eta * u - eta + 1) ** (1 / (1 - theta))))
    got = zipfian_values(torch.tensor(us, dtype=torch.float64), items=items, theta=theta, zetan=zetan)
    assert got.tolist() == want


def test_population_is_distinct_and_seeded():
    a = inputs.population(1 << 16, 2**31 + 77, CPU)
    b = inputs.population(1 << 16, 2**31 + 77, CPU)
    c = inputs.population(1 << 16, 5, CPU)
    assert a.dtype == torch.uint32 and torch.equal(a, b) and not torch.equal(a, c)
    assert torch.unique(a.view(torch.int32)).numel() == 1 << 16


def _capacities(n, seed):
    """Varied capacities, so that segments of every length are tested."""
    return np.random.default_rng(seed).uniform(0.5, 2.0, n)


def _history(rng, model, cluster, steps=300):
    alive = {}
    nid = 0
    for _ in range(steps):
        op = rng.integers(0, 4) if alive else 0
        if op <= 1:
            cap = float(rng.uniform(0.05, 3.5))
            model.add(nid, cap)
            cluster.add_node(nid, cap)
            alive[nid] = cap
            nid += 1
        elif op == 2:
            node = int(rng.choice(sorted(alive)))
            model.remove(node)
            cluster.remove_node(node)
            del alive[node]
        else:
            node = int(rng.choice(sorted(alive)))
            cap = float(rng.uniform(0.05, 3.5))
            model.resize(node, cap)
            cluster.resize_node(node, cap)
            alive[node] = cap
        if alive:
            len32, owner, top = model.arrays()
            art = cluster.engine.artifact()
            assert np.array_equal(len32, art.len32)
            assert np.array_equal(owner, art.node_of) and top == art.top_level


def test_table_model_follows_the_programs_cluster():
    from repro_torch.core import Cluster

    _history(np.random.default_rng(3), TableModel(1), Cluster(device="cpu"))


def test_hierarchy_model_follows_the_programs_racks():
    from repro_torch.core import HierarchicalCluster

    rng = np.random.default_rng(4)
    model, h = HierarchyModel(1), HierarchicalCluster(device="cpu")
    for node in range(200):
        rack, cap = int(rng.integers(0, 7)), float(rng.uniform(0.5, 2.0))
        model.add(rack, node, cap)
        h.add_node(rack, node, cap)
    for node in (3, 50, 120):
        rack = h.node_domains()[node]
        model.remove(rack, node)
        h.remove_node(rack, node)
    len32, owner, top = model.racks.arrays()
    assert np.array_equal(len32, h._top.engine.artifact().len32)
    assert np.array_equal(owner, h._top.seg_to_node())
    for rack in model.rack_ids():
        assert np.array_equal(model.nodes[rack].arrays()[0], h.domains[rack].engine.artifact().len32)


def _flat(n_nodes, seed):
    from repro_torch.core import make_cluster

    caps = _capacities(n_nodes, seed)
    model = TableModel(1)
    for i, c in enumerate(caps):
        model.add(i, float(c))
    return model, make_cluster(caps.tolist(), device="cpu")


@pytest.mark.parametrize("n_nodes,R", [(4096, 3), (10, 3), (40, 1), (4, 6)])
def test_flat_sets_are_the_programs(n_nodes, R):
    from repro_torch.kernels.asura_place import place_replicas_cuda

    model, cluster = _flat(n_nodes, 9)
    ids = inputs.population(1 << 13, 9, CPU)
    counts = Counts()
    want = flat_sets(ids, model, R, device=CPU, counts=counts)
    got = cluster.engine.place_replica_nodes_device(ids, R)
    assert torch.equal(got.to(torch.int64), want)
    art = cluster.engine.artifact()
    _, stats = place_replicas_cuda(ids, art.len32_dev, art.node_of_dev, top_level=art.top_level,
                                   s_log2=1, max_draws=128, n_replicas=R, emit_nodes=True,
                                   emit_stats=True)
    hist = stats[:-1].to(torch.int64)
    depth = torch.arange(hist.shape[0])
    assert counts["draws"] == int(hist.sum()) and counts["consults"] == int((hist * depth).sum())


def test_rack_sets_are_the_programs():
    from repro_torch.core import HierarchicalCluster

    caps = _capacities(1024, 11)
    model, h = HierarchyModel(1), HierarchicalCluster(device="cpu")
    for node, cap in enumerate(caps):
        model.add(node // 64, node, float(cap))
        h.add_node(node // 64, node, float(cap))
    ids = inputs.population(1 << 12, 11, CPU)
    want = rack_sets(ids, model, 3, device=CPU, counts=(Counts(), Counts()))
    assert torch.equal(h.engine.place_replica_pairs_device(ids, 3).to(torch.int64), want)


def test_align_is_the_programs():
    from repro_torch.kernels.ops import align_replica_sets

    rng = np.random.default_rng(2)
    before = torch.from_numpy(np.stack([rng.permutation(9)[:3] for _ in range(4000)]))
    after = torch.from_numpy(np.stack([rng.permutation(9)[:3] for _ in range(4000)]))
    for got, want in zip(align_replica_sets(before, after), align(before, after)):
        assert torch.equal(got.to(torch.int64), want.to(torch.int64))


def test_the_float32_number_changes_answers():
    model, _ = _flat(4096, 5)
    ids = inputs.population(1 << 16, 5, CPU)
    exact = flat_sets(ids, model, 3, device=CPU)
    f32 = flat_sets(ids, model, 3, device=CPU, number="float32")
    assert int((exact != f32).any(dim=1).sum()) > 0
