"""The hand-written CUDA kernels on the card, held to their plain-torch twins.

Every test here needs a CUDA card and nvcc (the kernels have no CPU mode),
is marked ``gpu`` and skips without a card.  The file imports only torch,
numpy and the port, so it also runs on a card's host that has no jax:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Exact equality throughout the placement stack, which is integer math; the
language model's float logits are held to an fp32 run (see its section).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from repro_torch.core import PlacementEngine, make_cluster, make_uniform_cluster
from repro_torch.core.asura import AsuraParams
from repro_torch.kernels import LAUNCHES, ref
from repro_torch.kernels.asura_place import place_fused_cuda, place_replicas_cuda
from repro_torch.kernels.ops import addition_numbers_top
from repro_torch.kernels.u32 import as_u32
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import RequestStreamDriver

CAPS = [0.3, 1.7, 2.0, 0.9, 1.0, 0.5, 1.25, 0.75, 3.0, 0.6]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _ids(n, device, seed=0):
    ids = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)
    return torch.from_numpy(ids).to(device)


def _artifact(caps, device, params=AsuraParams()):
    return PlacementEngine(make_cluster(caps, params), device=device)._device_artifact()


# Tables of every ladder shape the ASURA kernels meet: one node (top level
# 0), 10 and 64 nodes (tops below the kernels' register levels) and the
# 4096- and 10,000-node clusters of chip_smoke.py (tops 12 and 14, deeper
# than any register ladder, so their counters reach the local array).
LADDERS = {
    "10 nodes": CAPS,
    "1 node": [1.0],
    "64 nodes": [1.0] * 64,
    "4096 nodes": np.random.default_rng(0).uniform(0.5, 2.0, 4096).tolist(),
    "10000 nodes": np.random.default_rng(1).uniform(0.5, 2.0, 10_000).tolist(),
}


@pytest.mark.parametrize("ladder", ["10 nodes", "1 node", "4096 nodes", "10000 nodes"])
@pytest.mark.parametrize("max_draws", [128, 1, 0])
def test_place_fused_kernel_matches_twin(cuda_device, max_draws, ladder):
    art = _artifact(LADDERS[ladder], cuda_device, AsuraParams(max_draws=max_draws))
    tabs = (art.len32_dev, art.cum_hi_dev, art.cum_lo_dev, art.node_of_dev)
    ids = _ids(100_003, cuda_device, seed=max_draws)
    before = LAUNCHES["place_fused"]
    for emit in (False, True):
        kw = dict(top_level=art.top_level, s_log2=1, max_draws=max_draws, emit_nodes=emit)
        assert torch.equal(place_fused_cuda(ids, *tabs, **kw),
                           ref.place_fused_ref(ids, *tabs, **kw))
    assert LAUNCHES["place_fused"] == before + 2


@pytest.mark.parametrize("ladder,max_draws", [
    ("64 nodes", 128), ("1 node", 128), ("4096 nodes", 128), ("10000 nodes", 128),
    ("4096 nodes", 1), ("1 node", 0),
])
@pytest.mark.parametrize("R", [1, 3, 12])
def test_place_replicas_kernel_matches_twin(cuda_device, R, ladder, max_draws):
    """B2 and its stats vector on a ragged batch (100,003 ids: the last
    block's tail lanes take part in the warp sums with zeros); R = 3 runs
    the three-slot instantiation, R = 12 the scratch rows."""
    art = _artifact(LADDERS[ladder], cuda_device, AsuraParams(max_draws=max_draws))
    ids = _ids(100_003, cuda_device, seed=R)
    before = LAUNCHES["place_replicas"]
    for emit in (False, True):
        kw = dict(top_level=art.top_level, s_log2=1, max_draws=max_draws, n_replicas=R,
                  emit_nodes=emit, emit_stats=True)
        got, stats = place_replicas_cuda(ids, art.len32_dev, art.node_of_dev, **kw)
        want, want_stats = ref.place_replicas_fused_ref(
            ids, art.len32_dev, art.node_of_dev, **kw)
        assert torch.equal(got, want)
        assert torch.equal(as_u32(stats), as_u32(want_stats))
    assert LAUNCHES["place_replicas"] == before + 2


@pytest.mark.parametrize("n", [1, 31, 33, 255, 257, 4097])
def test_place_replicas_stats_on_ragged_batches(cuda_device, n):
    """The warp-summed stats vector for batches that end inside a warp or
    a block, R = 2 and 3, on the 4096-node ladder."""
    art = _artifact(LADDERS["4096 nodes"], cuda_device)
    ids = _ids(n, cuda_device, seed=n)
    for R in (2, 3):
        kw = dict(top_level=art.top_level, s_log2=1, max_draws=128, n_replicas=R,
                  emit_nodes=True, emit_stats=True)
        got, stats = place_replicas_cuda(ids, art.len32_dev, art.node_of_dev, **kw)
        want, want_stats = ref.place_replicas_fused_ref(
            ids, art.len32_dev, art.node_of_dev, **kw)
        assert torch.equal(got, want)
        assert torch.equal(as_u32(stats), as_u32(want_stats))


def test_ladder_kernels_build_without_a_full_counter_frame(cuda_device):
    """B1, B9 and every B2 instantiation (RMAX = 3 among them) keep their
    top counters in registers: a stack frame below the 128 B of a counter
    per level, and no spills."""
    from repro_torch.kernels import build

    report = build.ptxas_report("asura_place")
    names = {"place_fused": "18place_fused_kernelE", "place": "12place_kernelE",
             "place_replicas": "21place_replicas_kernelI"}
    for label, pattern in names.items():
        found = {k: v for k, v in report.items() if pattern in k}
        assert found, label
        for sym, x in found.items():
            assert x["stack"] < 128 and x["spill_stores"] == x["spill_loads"] == 0, (sym, x)
    assert any("21place_replicas_kernelILi3EE" in k for k in report)


def test_kernels_handle_empty_and_ragged_batches(cuda_device):
    art = _artifact(CAPS, cuda_device)
    tabs = (art.len32_dev, art.cum_hi_dev, art.cum_lo_dev, art.node_of_dev)
    for n in (0, 1, 255, 257):
        ids = _ids(n, cuda_device, seed=n)
        got = place_fused_cuda(ids, *tabs, top_level=art.top_level)
        assert torch.equal(got, ref.place_fused_ref(
            ids, *tabs, top_level=art.top_level, s_log2=1, max_draws=128,
            emit_nodes=False))
        got_r = place_replicas_cuda(ids, art.len32_dev, art.node_of_dev,
                                    top_level=art.top_level, n_replicas=2)
        assert got_r.shape == (n, 2)


def test_engine_on_card_matches_cpu_without_host_sync(cuda_device):
    eng = PlacementEngine(make_cluster(CAPS), device=cuda_device)
    eng.artifact()  # the one upload, outside the guard
    ids = _ids(100_000, cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nodes = eng.place_nodes_device(ids)
        segs = eng.place_device(ids)
        reps = eng.place_replica_nodes_device(ids, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cpu = PlacementEngine(make_cluster(CAPS), device="cpu")
    host_ids = ids.cpu()
    assert torch.equal(nodes.cpu(), cpu.place_nodes_device(host_ids))
    assert torch.equal(segs.cpu(), cpu.place_device(host_ids))
    assert torch.equal(reps.cpu(), cpu.place_replica_nodes_device(host_ids, 3))
    assert eng.uploads == 1


def test_step_on_card_has_no_host_sync_and_matches_cpu(cuda_device):
    cfg = dict(policy="pow2", law="zipf", batch=4096, n_keys=10_000, seed=1)
    gpu = RequestStreamDriver(
        PlacementEngine(make_uniform_cluster(24), device=cuda_device),
        metrics=MetricsRegistry(device=cuda_device), **cfg,
    )
    cpu = RequestStreamDriver(
        PlacementEngine(make_uniform_cluster(24), device="cpu"),
        metrics=MetricsRegistry(device="cpu"), **cfg,
    )
    before = LAUNCHES["place_replicas"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chosen = [gpu.step() for _ in range(4)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert LAUNCHES["place_replicas"] == before + 4
    for c in chosen:
        assert torch.equal(c.cpu(), cpu.step())
    assert torch.equal(gpu.qhist.cpu(), cpu.qhist)
    a, b = gpu.metrics.snapshot(), cpu.metrics.snapshot()
    for name in a:
        assert np.array_equal(np.asarray(a[name]), np.asarray(b[name])), name


# ---------------------------------------------------------------------------
# the selection-word kernel (TW): Threefry-2x32 words of the serving driver
# ---------------------------------------------------------------------------

from repro_torch.kernels.traffic import lane_words_cuda  # noqa: E402
from repro_torch.serve.traffic import TrafficModel, fold_in, prng_key  # noqa: E402

EDGE_LANES = [0, 1, 511, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1]


@pytest.mark.parametrize("n_words", [1, 2])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, -5])
@pytest.mark.parametrize("step", [0, 1, 1000])
def test_lane_words_kernel_equals_its_twin(cuda_device, seed, step, n_words):
    ragged = torch.arange((1 << 20) + 3, dtype=torch.int64) * 4099 + 2**31 - 2**20
    for lanes in (torch.tensor(EDGE_LANES, dtype=torch.int64), ragged,
                  torch.empty(0, dtype=torch.int64)):
        want = TrafficModel.lane_words(prng_key(seed), step, lanes, n_words)
        before = LAUNCHES["lane_words"]
        got = TrafficModel.lane_words(prng_key(seed), step, lanes.to(cuda_device), n_words)
        assert LAUNCHES["lane_words"] == before + (1 if lanes.numel() else 0)
        assert got.dtype == torch.int64 and got.shape == (lanes.shape[0], n_words)
        assert torch.equal(got.cpu(), want)
        direct = lane_words_cuda(fold_in(prng_key(seed), step), lanes.to(cuda_device), n_words)
        assert torch.equal(direct.cpu(), want)


def test_lane_words_kernel_launches_once_per_route_batch_and_step(cuda_device):
    cfg = dict(policy="pow2", law="zipf", batch=4096, n_keys=10_000, seed=3)
    gpu = RequestStreamDriver(PlacementEngine(make_uniform_cluster(24), device=cuda_device),
                              **cfg)
    cpu = RequestStreamDriver(PlacementEngine(make_uniform_cluster(24), device="cpu"), **cfg)
    ids = _ids(3000, cuda_device, seed=5)
    for serve in (lambda d, x: d.route_batch(x), lambda d, x: d.step()):
        before = LAUNCHES["lane_words"]
        got = serve(gpu, ids)
        assert LAUNCHES["lane_words"] == before + 1
        assert torch.equal(got.cpu(), serve(cpu, ids.cpu()))
    assert torch.equal(gpu.counts.cpu(), cpu.counts)


# ---------------------------------------------------------------------------
# the select-and-count kernel (SC) and the bin update
# ---------------------------------------------------------------------------

from repro_torch.kernels.serve import count_update_cuda, select_count_cuda  # noqa: E402
from repro_torch.serve.stream import (  # noqa: E402
    POLICIES,
    count_update_twin,
    select_count_twin,
)

SC_LANES = (1 << 18) + 13
SC_CASES = ["dense", "holes", "pad", "strided words", "transposed owners", "global bins",
            "zipf hot", "empty"]
PLANE_BINS = 232_448 // 4  # an H100 block's shared memory holds this many int32 bins


def _sc_operands(case, R, seed):
    """(owners, sel, counts, hist, n_valid) on the CPU for one SC case."""
    rng = np.random.default_rng(seed)
    n = 0 if case == "empty" else SC_LANES
    n_bins = PLANE_BINS + 11_843 if case == "global bins" else 10_001
    owners = rng.integers(0, n_bins, (n, R)).astype(np.int32)
    if case in ("holes", "pad"):
        owners[rng.random((n, R)) < 0.15] = -1  # unfilled slots
        owners[rng.random(n) < 0.02] = -1  # fully invalid rows
    if case == "zipf hot":  # >= 25 % of the lanes ask for one record
        hot = rng.random(n) < 0.3
        owners[hot] = owners[0]
    sel = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32).astype(np.int64))
    counts = rng.integers(0, 50, n_bins).astype(np.int32)
    counts[rng.random(n_bins) < 0.2] = 7  # ties between the two candidates
    hist = rng.integers(0, 5, n_bins).astype(np.int32)  # SC adds into it
    n_valid = n - 1000 if case == "pad" else n
    return torch.from_numpy(owners), sel, torch.from_numpy(counts), torch.from_numpy(hist), \
        n_valid


@pytest.mark.parametrize("case", SC_CASES)
@pytest.mark.parametrize("R", [1, 2, 3, 5])
@pytest.mark.parametrize("policy", POLICIES)
def test_select_count_kernel_equals_its_twin(cuda_device, policy, R, case):
    owners, sel, counts, hist, n_valid = _sc_operands(case, R, seed=R + len(case))
    kw = dict(policy=policy, n_replicas=R, n_valid=n_valid)
    want_hist = hist.clone()
    want = select_count_twin(owners, sel, counts, want_hist, **kw)
    d_owners = owners.to(cuda_device)
    if case == "transposed owners":  # the hierarchical kernel's (R, n) node plane
        d_owners = owners.T.contiguous().to(cuda_device).T
    d_sel = sel.to(cuda_device)
    if case == "strided words":  # a generated batch's word 1 of its (n, 2) words
        d_sel = torch.stack([torch.zeros_like(sel), sel], 1).to(cuda_device)[:, 1]
        assert d_sel.stride(0) == 2
    d_hist = hist.to(cuda_device)
    before = LAUNCHES["select_count"]
    got = select_count_cuda(d_owners, d_sel, counts.to(cuda_device), d_hist, **kw)
    assert LAUNCHES["select_count"] == before + (1 if owners.shape[0] else 0)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got.cpu(), want)
    assert torch.equal(d_hist.cpu(), want_hist)
    if case == "zipf hot":
        assert (owners == owners[0]).all(1).float().mean() >= 0.25


def test_count_update_kernel_equals_its_twin(cuda_device):
    rng = np.random.default_rng(11)
    n_bins = 10_001
    hist = rng.integers(0, 1000, n_bins).astype(np.int32)
    counts = rng.integers(0, 2**31 - 1, n_bins).astype(np.int32)  # the sum wraps
    queue = rng.integers(0, 400, n_bins).astype(np.int32)
    queue[:5] = 2**31 - 10  # the queue's sum wraps
    service = np.full(n_bins, 420, dtype=np.int32)
    cpu = [torch.from_numpy(a.copy()) for a in (hist, counts, queue, service)]
    qhist = torch.zeros((4, n_bins), dtype=torch.int32)
    want = count_update_twin(*cpu, qhist[2])
    card = [torch.from_numpy(a).to(cuda_device) for a in (hist, counts, queue, service)]
    d_qhist = torch.zeros((4, n_bins), dtype=torch.int32, device=cuda_device)
    before = LAUNCHES["count_update"]
    got = count_update_cuda(*card, d_qhist[2])
    assert LAUNCHES["count_update"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(d_qhist.cpu(), qhist)
    assert not card[0].any() and not cpu[0].any()  # handed back zeroed
    assert got[0].data_ptr() != card[1].data_ptr() and got[1].data_ptr() != card[2].data_ptr()


def _serve_on(device, instrumented, path):
    """A driver on ``device`` after ``path``'s batches -> (results, driver,
    registry)."""
    reg = MetricsRegistry(device=device) if instrumented else None
    if path == "serve_migrating":
        router, mig, drv = _window(device, 3)
        drv = router.stream_driver(batch=1024, n_keys=1 << 14, n_replicas=3, policy="pow2",
                                   seed=5, n_bins=9, metrics=reg)
        mig.round()
        out = [x for _ in range(2) for x in drv.serve_migrating(mig)]
        out += list(drv.superstep_migrating(mig, 2))
        return out, drv, reg
    engine = PlacementEngine(make_uniform_cluster(24), device=device)
    drv = RequestStreamDriver(engine, policy="pow2", law="zipf", batch=4096, n_keys=10_000,
                              seed=7, metrics=reg)
    if path == "route_batch":
        out = [drv.route_batch(_ids(n, device, seed=n)) for n in (3000, 4096, 1)]
    elif path == "step":
        out = [drv.step() for _ in range(3)]
    else:
        out = [drv.superstep(3)]
    return out, drv, reg


@pytest.mark.parametrize("instrumented", [False, True])
@pytest.mark.parametrize("path", ["route_batch", "step", "superstep", "serve_migrating"])
def test_serving_paths_on_card_equal_the_cpu_driver(cuda_device, path, instrumented):
    before = LAUNCHES["select_count"]
    got, gd, greg = _serve_on(cuda_device, instrumented, path)
    assert LAUNCHES["select_count"] == before + gd.steps_done
    want, cd, creg = _serve_on(torch.device("cpu"), instrumented, path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    for name in ("counts", "queue", "qhist"):
        assert torch.equal(getattr(gd, name).cpu(), getattr(cd, name)), name
    if instrumented:
        a, b = greg.snapshot(), creg.snapshot()
        assert a.keys() == b.keys()
        for name in a:
            assert np.array_equal(np.asarray(a[name]), np.asarray(b[name])), name


def test_route_batch_launches_select_count_once(cuda_device):
    drv = RequestStreamDriver(PlacementEngine(make_uniform_cluster(24), device=cuda_device),
                              batch=4096, n_keys=10_000, seed=3)
    ids = _ids(3000, cuda_device, seed=5)
    drv.route_batch(ids)
    before = dict(LAUNCHES)
    drv.route_batch(ids)
    assert LAUNCHES["select_count"] == before["select_count"] + 1
    assert LAUNCHES["count_update"] == before["count_update"] + 1


def test_counts_and_queue_held_on_card_are_unchanged_by_the_next_batch(cuda_device):
    drv = RequestStreamDriver(PlacementEngine(make_uniform_cluster(24), device=cuda_device),
                              batch=4096, n_keys=10_000, seed=3)
    ids = _ids(4096, cuda_device, seed=6)
    drv.route_batch(ids)
    held = (drv.counts, drv.queue)
    copies = [t.clone() for t in held]
    drv.route_batch(ids)
    drv.step()
    for t, c in zip(held, copies):
        assert torch.equal(t, c)
    assert not torch.equal(drv.counts, held[0])


# ---------------------------------------------------------------------------
# the two-version diff kernels (B3, B4) and the migration path on the card
# ---------------------------------------------------------------------------

from repro_torch.kernels.asura_place import diff_nodes_cuda, diff_replicas_cuda  # noqa: E402
from repro_torch.migrate import MigrationPlanner  # noqa: E402
from repro_torch.serve import Router  # noqa: E402

DIFF_CASES = ("add", "holes", "reuse", "top", "top+2", "top down", "same")
TOP_SHIFT = {"top": 1, "top+2": 2, "top down": -1}


def _diff_event(case, device, params=AsuraParams()):
    """(engine, v0, v1) around one membership event on a 14-node cluster
    (one fractional segment per node, top level 3): an appended segment,
    a length-0 hole, a reused hole, an add that lifts the top level by one
    or by two, the first of these with the versions swapped (the top goes
    down), or no event (both tables one version)."""
    caps = np.random.default_rng(7).uniform(0.5, 0.99, 14)
    cluster = make_cluster(caps, params, device=device)
    if case == "reuse":
        cluster.remove_node(5)
    eng = cluster.engine
    eng.artifact()
    v0 = cluster.version
    if case == "holes":
        cluster.remove_node(5)
    elif case != "same":
        cap = {"add": 1.0, "reuse": 0.7, "top": 3.0, "top+2": 19.0, "top down": 3.0}[case]
        cluster.add_node(14, cap)
    if case == "top down":
        return eng, cluster.version, v0
    return eng, v0, cluster.version


@pytest.mark.parametrize("case,max_draws", [(c, 128) for c in DIFF_CASES] + [("add", 1)])
def test_diff_nodes_kernel_matches_twin(cuda_device, case, max_draws):
    eng, v0, v1 = _diff_event(case, cuda_device, AsuraParams(max_draws=max_draws))
    a, b = eng._device_artifact_for(v0), eng._device_artifact_for(v1)
    assert b.top_level - a.top_level == TOP_SHIFT.get(case, 0)
    tabs = (a.len32_dev, a.cum_hi_dev, a.cum_lo_dev, a.node_of_dev,
            b.len32_dev, b.cum_hi_dev, b.cum_lo_dev, b.node_of_dev)
    kw = dict(top_a=a.top_level, top_b=b.top_level, s_log2=1, max_draws=max_draws)
    ids = _ids(100_003, cuda_device, seed=max_draws)
    before = LAUNCHES["diff_nodes"]
    got = diff_nodes_cuda(ids, *tabs, **kw)
    assert LAUNCHES["diff_nodes"] == before + 1
    assert torch.equal(got, ref.diff_fused_ref(ids, *tabs, **kw))


@pytest.mark.parametrize("R", [1, 3, 9, 12])
@pytest.mark.parametrize("case", DIFF_CASES)
def test_diff_replicas_kernel_matches_twin(cuda_device, case, R):
    eng, v0, v1 = _diff_event(case, cuda_device)
    a, b = eng._device_artifact_for(v0), eng._device_artifact_for(v1)
    tabs = (a.len32_dev, a.node_of_dev, b.len32_dev, b.node_of_dev)
    kw = dict(top_a=a.top_level, top_b=b.top_level, s_log2=1, max_draws=128,
              n_replicas=R)
    ids = _ids(100_003, cuda_device, seed=R)
    before = LAUNCHES["diff_replicas"]
    got = diff_replicas_cuda(ids, *tabs, **kw)
    assert LAUNCHES["diff_replicas"] == before + 1
    assert torch.equal(got, ref.diff_replicas_fused_ref(ids, *tabs, **kw))


from repro_torch.kernels.asura_place import diff_replicas_aligned_cuda  # noqa: E402
from repro_torch.kernels.ops import align_replica_sets  # noqa: E402


@pytest.mark.parametrize("R", [1, 3, 9, 12])
@pytest.mark.parametrize("case,max_draws",
                         [(c, 128) for c in DIFF_CASES] + [("add", 1), ("top", 1)])
def test_diff_replicas_aligned_kernel_matches_the_two_step(cuda_device, case, max_draws, R):
    """B4 with its alignment epilogue equals B4 then ``ops.align_replica_sets``
    on the card and the plain version on the CPU, bit for bit, in one launch
    of its own; max_draws=1 leaves -1 slots and new slots with no
    rank-matched lost slot."""
    eng, v0, v1 = _diff_event(case, cuda_device, AsuraParams(max_draws=max_draws))
    a, b = eng._device_artifact_for(v0), eng._device_artifact_for(v1)
    tabs = (a.len32_dev, a.node_of_dev, b.len32_dev, b.node_of_dev)
    kw = dict(top_a=a.top_level, top_b=b.top_level, s_log2=1, max_draws=max_draws,
              n_replicas=R)
    ids = _ids(100_003, cuda_device, seed=R + max_draws)
    before = dict(LAUNCHES)
    got = diff_replicas_aligned_cuda(ids, *tabs, **kw)
    assert LAUNCHES["diff_replicas_aligned"] == before["diff_replicas_aligned"] + 1
    assert LAUNCHES["diff_replicas"] == before["diff_replicas"]
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    assert all(t.is_contiguous() and t.shape == (ids.shape[0], R) for t in got)
    sets = diff_replicas_cuda(ids, *tabs, **kw)
    host = diff_replicas_aligned_cuda(ids.cpu(), *(t.cpu() for t in tabs), **kw)
    for g, c, h in zip(got, align_replica_sets(sets[0], sets[1]), host):
        assert torch.equal(g, c) and torch.equal(g.cpu(), h)
    if max_draws == 1 and R > 1:
        lost = ~(sets[0][:, :, None] == sets[1][:, None, :]).any(dim=2)
        assert (sets < 0).any()
        assert (got[0].sum(dim=1) > lost.sum(dim=1)).any()


def test_diff_replicas_aligned_kernel_takes_an_empty_id_vector(cuda_device):
    eng, v0, v1 = _diff_event("add", cuda_device)
    a, b = eng._device_artifact_for(v0), eng._device_artifact_for(v1)
    before = dict(LAUNCHES)
    got = diff_replicas_aligned_cuda(
        _ids(0, cuda_device), a.len32_dev, a.node_of_dev, b.len32_dev, b.node_of_dev,
        top_a=a.top_level, top_b=b.top_level, n_replicas=3)
    assert [t.shape for t in got] == [(0, 3)] * 4 and got[0].dtype == torch.bool
    assert all(t.device.type == "cuda" for t in got) and LAUNCHES == before


def test_fused_replica_plan_on_card_aligns_inside_b4_with_no_host_sync(cuda_device):
    """A fused ``plan_replicas_stream`` on the card opens ``planner.block``
    with no ``ops.align_replica_sets`` inside, makes one aligned B4 launch
    a block and no host sync, and yields the CPU plan's tuples."""
    from torch.profiler import ProfilerActivity, profile

    eng, v0, v1 = _diff_event("add", cuda_device)
    planner = MigrationPlanner(eng)
    ids = _ids(900, cuda_device, seed=3)
    chunks = [ids[i : i + 128] for i in range(0, 900, 128)]  # 7 of 128, 1 of 4
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        list(planner.plan_replicas_stream(chunks, v0, v1, 3, fuse=4))
    names = [e.name for e in prof.events()]
    assert names.count("planner.block") == 3 and "ops.align_replica_sets" not in names
    before = dict(LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = list(planner.plan_replicas_stream(chunks, v0, v1, 3, fuse=4))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert LAUNCHES["diff_replicas_aligned"] == before["diff_replicas_aligned"] + 3
    assert LAUNCHES["diff_replicas"] == before["diff_replicas"]
    host_eng, h0, h1 = _diff_event("add", torch.device("cpu"))
    want = list(MigrationPlanner(host_eng).plan_replicas_stream(
        [c.cpu() for c in chunks], h0, h1, 3, fuse=4))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert torch.equal(x.cpu(), y)


def _window(device, R):
    router = Router({i: 1.0 for i in range(8)}, device=device)
    sessions = np.arange(20_000, dtype=np.uint32)
    mig = router.begin_scale_migration(
        sessions, add=(8, 1.0), n_replicas=R, egress={n: 60 for n in range(9)}
    )
    driver = router.stream_driver(batch=1024, n_keys=1 << 14, n_replicas=R,
                                  policy="pow2", seed=5, n_bins=9)
    return router, mig, driver


def test_migration_paths_on_card_have_no_host_sync_and_match_cpu(cuda_device):
    """route_device, route_replicas_device, serve_migrating,
    superstep_migrating and plan_stream run under sync-debug "error" after
    the per-round view refresh, and equal the CPU run (the twins)."""
    ids = _ids(50_000, cuda_device, seed=9)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        _, m1, _ = _window(dev, 1)
        _, m3, drv = _window(dev, 3)
        m1.round()
        m3.round()
        planner = MigrationPlanner(m1.engine)
        m1.state.pending_device()  # the per-round uploads, outside the guard
        m3.state.pending_replicas_device()
        chunks = list(MigrationPlanner.chunked(ids.to(dev), 1 << 14))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            res = [m1.route_device(ids.to(dev)), m3.route_replicas_device(ids.to(dev))]
            res += list(drv.serve_migrating(m3)) + list(drv.superstep_migrating(m3, 2))
            for fuse in (1, 4):
                for part in planner.plan_stream(chunks, m1.v_from, m1.v_to, fuse=fuse):
                    res += list(part[1:])
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        res += [drv.counts, drv.queue, drv.qhist]
        out[dev.type] = [r.cpu() for r in res]
    assert len(out["cuda"]) == len(out["cpu"])
    for g, c in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g, c)


# ---------------------------------------------------------------------------
# the ADDITION-NUMBER trace's kernel on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ladder,max_draws", [
    ("10 nodes", 128), ("1 node", 128), ("64 nodes", 128), ("4096 nodes", 128),
    ("10000 nodes", 128), ("4096 nodes", 2), ("4096 nodes", 1), ("10 nodes", 0),
])
@pytest.mark.parametrize("R", [1, 3, 9])
def test_addition_numbers_kernel_matches_twin(cuda_device, R, ladder, max_draws):
    """The kernel equals its twin lane for lane on the extended ladder,
    -1 lanes included: a small ``max_draws`` forces unconverged lanes;
    R = 3 runs the three-slot instantiation, R = 9 the scratch rows."""
    from repro_torch.kernels.asura_place import addition_numbers_cuda

    art = _artifact(LADDERS[ladder], cuda_device)
    ids = _ids(50_003, cuda_device, seed=R + max_draws)
    kw = dict(top_level=addition_numbers_top(art.top_level), s_log2=1, max_draws=max_draws,
              n_replicas=R)
    before = LAUNCHES["addition_numbers"]
    got = addition_numbers_cuda(ids, art.len32_dev, art.node_of_dev, **kw)
    assert LAUNCHES["addition_numbers"] == before + 1
    want = ref.addition_numbers_ref(ids, art.len32_dev, art.node_of_dev, **kw)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if max_draws <= 2 and R > 1:
        assert (got < 0).any()


@pytest.mark.parametrize("top_level,max_draws", [(18, 4096), (26, 64), (30, 16)])
def test_addition_numbers_kernel_on_a_deep_extended_ladder(cuda_device, top_level, max_draws):
    """Tops far above the 4096-node table's own (12): every counter below
    the register levels lives in the lane's local array, up to level 30,
    the deepest a 31-bit segment space allows; the deeper tops leave most
    or all lanes unconverged (-1)."""
    from repro_torch.kernels.asura_place import addition_numbers_cuda

    art = _artifact(LADDERS["4096 nodes"], cuda_device)
    ids = _ids(20_011, cuda_device, seed=top_level)
    for R in (1, 3, 8, 9):
        kw = dict(top_level=top_level, s_log2=1, max_draws=max_draws, n_replicas=R)
        got = addition_numbers_cuda(ids, art.len32_dev, art.node_of_dev, **kw)
        assert torch.equal(got, ref.addition_numbers_ref(
            ids, art.len32_dev, art.node_of_dev, **kw))
    if top_level == 18:
        assert (got >= 0).any()


@pytest.mark.parametrize("ladder", ["10 nodes", "4096 nodes", "10000 nodes"])
@pytest.mark.parametrize("above", [0, 1, 2])
@pytest.mark.parametrize("R", [1, 3, 9])
def test_addition_numbers_kernel_with_fewer_high_levels(cuda_device, R, above, ladder):
    """Traces that start at the table's top or one or two levels above it:
    the launcher runs 0, 1 or 2 levels level-major (the main path's four
    extra levels always give it its most, 3), so the kernel's paths for a
    ladder with no high level and for the back-trace over one and two stop
    masks in the round that ends the trace run, held exactly to the twin
    at ``max_draws`` 128 and 2."""
    from repro_torch.kernels.asura_place import addition_numbers_cuda
    from test_torch_launch import high_levels

    art = _artifact(LADDERS[ladder], cuda_device)
    top = art.top_level + above
    assert high_levels(art.n_segs, top, 3) == above
    ids = _ids(20_011, cuda_device, seed=above + R)
    for max_draws in (128, 2):
        kw = dict(top_level=top, s_log2=1, max_draws=max_draws, n_replicas=R)
        got = addition_numbers_cuda(ids, art.len32_dev, art.node_of_dev, **kw)
        want = ref.addition_numbers_ref(ids, art.len32_dev, art.node_of_dev, **kw)
        assert got.dtype == torch.int32 and torch.equal(got, want)
        if max_draws == 128:
            assert (got >= 0).any()


@pytest.mark.parametrize("n", [1, 31, 257, (1 << 16) + 13])
@pytest.mark.parametrize("R", [1, 3, 8, 9])
def test_addition_numbers_kernel_refill_tails_match_twin(cuda_device, R, n):
    """The kernel's warps own runs of ids and a lane whose trace is done
    takes the warp's next id: batches that leave one lane, part of a warp,
    a ragged last warp and long runs per lane, at every instantiation (R =
    1, 3, 8 in registers, 9 in scratch rows), held exactly to the twin;
    ``max_draws`` = 2 forces -1 lanes between converged ones."""
    from repro_torch.kernels.asura_place import addition_numbers_cuda

    art = _artifact(LADDERS["4096 nodes"], cuda_device)
    ids = _ids(n, cuda_device, seed=n + R)
    for max_draws in (128, 2):
        kw = dict(top_level=addition_numbers_top(art.top_level), s_log2=1,
                  max_draws=max_draws, n_replicas=R)
        got = addition_numbers_cuda(ids, art.len32_dev, art.node_of_dev, **kw)
        want = ref.addition_numbers_ref(ids, art.len32_dev, art.node_of_dev, **kw)
        assert got.dtype == torch.int32 and torch.equal(got, want)
        if max_draws == 2 and R > 1:
            assert (got < 0).any()
        if max_draws == 128 and n > 31:
            assert (got >= 0).any()


@pytest.mark.parametrize("R", [1, 3, 9])
def test_addition_numbers_kernel_with_repeated_ids(cuda_device, R):
    """Ids that repeat (a run of one id, the batch again reversed) give
    each copy the same number, the twin's."""
    from repro_torch.kernels.asura_place import addition_numbers_cuda

    art = _artifact(LADDERS["4096 nodes"], cuda_device)
    base = _ids(5_003, cuda_device, seed=R)
    ids = torch.cat([base, base[:1].repeat(1_000), base.flip(0)])
    kw = dict(top_level=addition_numbers_top(art.top_level), s_log2=1, max_draws=128,
              n_replicas=R)
    got = addition_numbers_cuda(ids, art.len32_dev, art.node_of_dev, **kw)
    assert torch.equal(got, ref.addition_numbers_ref(ids, art.len32_dev, art.node_of_dev, **kw))
    n = base.shape[0]
    assert torch.equal(got[n:n + 1_000], got[:1].repeat(1_000))
    assert torch.equal(got[n + 1_000:], got[:n].flip(0))


def test_addition_numbers_kernel_empty_batch_and_bad_inputs(cuda_device):
    from repro_torch.kernels.asura_place import addition_numbers_cuda

    art = _artifact(CAPS, cuda_device)
    before = LAUNCHES["addition_numbers"]
    out = addition_numbers_cuda(_ids(0, cuda_device), art.len32_dev, art.node_of_dev,
                                top_level=art.top_level, n_replicas=3)
    assert out.shape == (0,) and out.dtype == torch.int32
    assert LAUNCHES["addition_numbers"] == before
    ids = _ids(10, cuda_device)
    with pytest.raises(ValueError, match="n_replicas"):
        addition_numbers_cuda(ids, art.len32_dev, art.node_of_dev, top_level=3, n_replicas=0)
    with pytest.raises(ValueError, match="< 2\\*\\*31"):
        addition_numbers_cuda(ids, art.len32_dev, art.node_of_dev, top_level=3,
                              max_draws=2**28, n_replicas=8)
    with pytest.raises(ValueError, match="s_log2 \\+ top_level"):
        addition_numbers_cuda(ids, art.len32_dev, art.node_of_dev, top_level=31)
    with pytest.raises(ValueError, match="is on"):
        addition_numbers_cuda(ids, art.len32_dev.cpu(), art.node_of_dev, top_level=3)


def test_addition_numbers_device_has_no_host_sync_and_matches_cpu(cuda_device):
    """The engine's trace on the card: one launch, no host sync, equal to
    the CPU engine's (the twin)."""
    eng = PlacementEngine(make_cluster(LADDERS["4096 nodes"]), device=cuda_device)
    eng.artifact()
    ids = _ids(200_000, cuda_device, seed=3)
    got = {}
    torch.cuda.synchronize()
    before = LAUNCHES["addition_numbers"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for R in (1, 3):
            got[R] = eng.addition_numbers_device(ids, n_replicas=R)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert LAUNCHES["addition_numbers"] == before + 2
    cpu = PlacementEngine(make_cluster(LADDERS["4096 nodes"]), device="cpu")
    for R, an in got.items():
        assert torch.equal(an.cpu(), cpu.addition_numbers_device(ids.cpu(), n_replicas=R))


def test_prefiltered_window_on_card_matches_cpu(cuda_device):
    """An add-only window prefilters on the card as on the CPU: the same
    plan and the same scanned / kept counters, fewer ids diffed than
    scanned."""
    from repro_torch.obs import TraceLedger

    sessions = np.arange(20_000, dtype=np.uint32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        for R in (1, 3):
            router, ledger = Router({i: 1.0 for i in range(8)}, device=dev), TraceLedger()
            mig = router.begin_scale_migration(sessions, add=(8, 1.0), n_replicas=R,
                                               ledger=ledger)
            counts = tuple(ledger.counter(k) for k in (
                "planner.prefilter_scanned", "planner.prefilter_kept"))
            out[dev.type, R] = (mig.state.plan, counts)
    for R in (1, 3):
        (g, gc), (c, cc) = out["cuda", R], out["cpu", R]
        for f in ("ids", "src", "dst", "index", "slot", "src_slot"):
            assert np.array_equal(getattr(g, f), getattr(c, f)), f
        assert gc == cc and gc[0] == len(sessions) and 0 < gc[1] < gc[0]


# ---------------------------------------------------------------------------
# the baseline kernels (B5 ch, B6 rs, B7 wrh, the fan-out) on the card
# ---------------------------------------------------------------------------

from repro_torch.core import build_ring  # noqa: E402
from repro_torch.core.random_slicing import RandomSlicingTable  # noqa: E402
from repro_torch.kernels import baselines as tb  # noqa: E402
from repro_torch.kernels import baselines_ref as tr  # noqa: E402

BASE_CAPS = np.random.default_rng(2).uniform(0.5, 2.0, 64)


def _unfmix32(h: np.ndarray) -> np.ndarray:
    """Ids whose MurmurHash3 finalizer is ``h`` (the finalizer inverted)."""
    h = h.astype(np.uint64)
    h ^= h >> 16
    h = (h * pow(0xC2B2AE35, -1, 2**32)) & 0xFFFFFFFF
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * pow(0x85EBCA6B, -1, 2**32)) & 0xFFFFFFFF
    h ^= h >> 16
    return h.astype(np.uint32)


def _baseline_tables(alg, caps, device):
    """(canonical keys, vals) -> the prepped device tables, and the
    canonical keys (whose neighbours make the edge ids)."""
    if alg == "ch":
        keys, vals = build_ring(range(len(caps)), 100)
        keys = np.sort(np.concatenate([keys, keys[::5]]))  # duplicated points
        vals = np.random.default_rng(1).integers(0, len(caps), keys.shape[0])
    elif alg == "rs":
        t = RandomSlicingTable({i: float(c) for i, c in enumerate(caps)})
        t.rebalance({**t.weights, len(caps): 1.0})
        t.rebalance({k: v for k, v in t.weights.items() if k != 3})
        keys, vals = t.starts_owners()
    else:
        keys = np.arange(len(caps), dtype=np.uint32)
        vals = np.asarray(caps, dtype=np.float32)
    return tb.TABLE_PREP[alg](keys, vals, device=device), keys


@pytest.mark.parametrize("n", [0, 1, 255, 257, 100_003])
@pytest.mark.parametrize("alg", ["ch", "rs", "wrh"])
def test_baseline_lookup_kernel_matches_twin(cuda_device, alg, n):
    (a, b), keys = _baseline_tables(alg, BASE_CAPS, cuda_device)
    ids = _ids(n, cuda_device, seed=n)
    if alg != "wrh" and n > 1000:  # hashes on, and next to, every table point
        p = keys.astype(np.int64)
        h = np.unique(np.clip(np.concatenate([[0, 2**32 - 1], p - 1, p, p + 1]),
                              0, 2**32 - 1)).astype(np.uint32)
        ids = torch.cat([ids, torch.from_numpy(_unfmix32(h)).to(cuda_device)])
    place = getattr(tb, f"{alg}_place_cuda")
    before = LAUNCHES[f"{alg}_place"]
    got = place(ids, a, b)
    assert LAUNCHES[f"{alg}_place"] == before + (1 if ids.shape[0] else 0)
    assert torch.equal(got, tr.LOOKUPS[alg](ids, a, b))


@pytest.mark.parametrize("cut", [1, 5])
def test_rs_kernel_below_the_first_start_matches_twin(cuda_device, cut):
    """B6 on a table whose ``starts[0] != 0``: a hash below the first start
    takes the last owner, as the twin (and the reference's jnp lookup)."""
    t = RandomSlicingTable({i: float(c) for i, c in enumerate(BASE_CAPS)})
    t.rebalance({**t.weights, len(BASE_CAPS): 1.0})
    keys, vals = t.starts_owners()
    keys, vals = keys[cut:], vals[cut:]
    assert keys[0] != 0
    below = _unfmix32(np.linspace(0, int(keys[0]) - 1, 1025).astype(np.uint32))
    ids = torch.cat([_ids(100_003, cuda_device, seed=cut),
                     torch.from_numpy(np.concatenate([_unfmix32(keys), below])).to(cuda_device)])
    a, b = tb.TABLE_PREP["rs"](keys, vals, device=cuda_device)
    got = tb.rs_place_cuda(ids, a, b)
    assert torch.equal(got, tr.rs_lookup(ids, a, b))
    h = tr.fmix32(tr.as_u32(ids)).to(torch.int64)
    assert bool((got[h < int(keys[0])] == int(vals[-1])).all())


def test_wrh_kernel_walks_several_shared_tiles(cuda_device):
    """9,000 nodes (three 4096-entry tiles) with zero weights and a
    padding tail: the staged kernel equals the twin."""
    w = np.random.default_rng(4).uniform(0.5, 2.0, 9000).astype(np.float32)
    w[::97] = 0.0
    salts, inv_w = tb.wrh_table_prep(np.arange(9000, dtype=np.uint32), w,
                                     device=cuda_device)
    assert salts.shape[0] % 128 == 0 and salts.shape[0] > 9000
    ids = _ids(4099, cuda_device, seed=4)
    assert torch.equal(tb.wrh_place_cuda(ids, salts, inv_w),
                       tr.wrh_lookup(ids, salts, inv_w))


@pytest.mark.parametrize("R", [1, 3, 5, 12])
@pytest.mark.parametrize("alg", ["ch", "rs", "wrh"])
def test_baseline_replicas_kernel_matches_twin(cuda_device, alg, R):
    (a, b), _ = _baseline_tables(alg, BASE_CAPS, cuda_device)
    ids = _ids(20_011, cuda_device, seed=R)
    before = LAUNCHES["baseline_replicas"]
    got, stats = tb.baseline_replicas_cuda(alg, ids, a, b, n_replicas=R, emit_stats=True)
    assert LAUNCHES["baseline_replicas"] == before + 1
    want, want_stats = tr.baseline_replicas_lookup(alg, ids, a, b, n_replicas=R,
                                                   emit_stats=True)
    assert torch.equal(got, want)
    assert torch.equal(as_u32(stats), as_u32(want_stats))


@pytest.mark.parametrize("alg", ["ch", "rs", "wrh"])
def test_baseline_replicas_kernel_leaves_short_slots_empty(cuda_device, alg):
    """R = 6 on 4 nodes: at least two slots per lane stay -1, as in the twin."""
    (a, b), _ = _baseline_tables(alg, [1.0, 2.0, 0.5, 1.5], cuda_device)
    ids = _ids(5003, cuda_device, seed=6)
    got, stats = tb.baseline_replicas_cuda(alg, ids, a, b, n_replicas=6, emit_stats=True)
    want, want_stats = tr.baseline_replicas_lookup(alg, ids, a, b, n_replicas=6,
                                                   emit_stats=True)
    assert torch.equal(got, want) and torch.equal(as_u32(stats), as_u32(want_stats))
    assert bool(((got < 0).sum(dim=1) >= 2).all())  # 4 nodes: at most 4 filled


@pytest.mark.parametrize("alg", ["ch", "rs", "wrh"])
def test_baseline_paths_on_card_have_no_host_sync_and_match_cpu(cuda_device, alg):
    """The engine's device variants and the serving driver under a
    baseline run under sync-debug "error" and equal the CPU run."""
    caps = {i: float(c) for i, c in enumerate(BASE_CAPS)}
    cfg = dict(policy="pow2", law="zipf", batch=4096, n_keys=10_000, seed=1)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        router = Router(caps, algorithm=alg, device=dev)
        driver = router.stream_driver(metrics=MetricsRegistry(device=dev), **cfg)
        ids = _ids(30_000, dev, seed=3)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            res = [router.route_device(ids), router.route_replicas_device(ids, 3)]
            res += [driver.step() for _ in range(2)] + [driver.superstep(2)]
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        res += [driver.counts, driver.queue, driver.qhist]
        snap = driver.metrics.snapshot()
        assert "baseline.reprobes" in snap
        out[dev.type] = ([r.cpu() for r in res], snap, router.engine.uploads)
    for g, c in zip(out["cuda"][0], out["cpu"][0]):
        assert torch.equal(g, c)
    for name, v in out["cuda"][1].items():
        assert np.array_equal(np.asarray(v), np.asarray(out["cpu"][1][name])), name
    assert out["cuda"][2] == out["cpu"][2] == 1


# ---------------------------------------------------------------------------
# the bounded placement kernel (B9) and the two-level kernel (B8)
# ---------------------------------------------------------------------------

from repro_torch.core import HierarchicalCluster  # noqa: E402
from repro_torch.kernels.asura_place import place_cuda  # noqa: E402
from repro_torch.kernels.hierarchy import hier_place_replicas_cuda  # noqa: E402
from repro_torch.kernels.hierarchy_ref import hier_place_replicas_ref  # noqa: E402


@pytest.mark.parametrize("ladder", ["10 nodes", "1 node", "4096 nodes", "10000 nodes"])
@pytest.mark.parametrize("max_draws", [128, 1, 0])
def test_place_kernel_matches_twin(cuda_device, max_draws, ladder):
    art = _artifact(LADDERS[ladder], cuda_device, AsuraParams(max_draws=max_draws))
    ids = _ids(100_003, cuda_device, seed=max_draws)
    kw = dict(top_level=art.top_level, s_log2=1, max_draws=max_draws)
    before = LAUNCHES["place"]
    got = place_cuda(ids, art.len32_dev, **kw)
    assert LAUNCHES["place"] == before + 1
    want = ref.place_ref(ids, art.len32_dev, **kw)
    assert torch.equal(got, want)
    assert bool((got < 0).any()) == (max_draws <= 1)


def _hierarchy(device, shape):
    """``uniform``: 6 domains of 5 nodes; ``ragged``: 1 to 128 nodes per
    domain (several per-domain top levels); ``few``: 4 domains."""
    h = HierarchicalCluster(device=device)
    rng = np.random.default_rng(len(shape))
    sizes = {"uniform": [5] * 6, "few": [3] * 4,
             "ragged": [1] + [int(x) for x in rng.integers(1, 129, 8)]}[shape]
    nid = 0
    for d, size in enumerate(sizes):
        for _ in range(size):
            h.add_node(2 * d + 1, nid, float(rng.uniform(0.5, 2.0)))
            nid += 1
    return h


@pytest.mark.parametrize("shape,R,max_draws", [
    ("uniform", 1, 128), ("uniform", 3, 128), ("ragged", 3, 128), ("ragged", 5, 128),
    ("ragged", 3, 1), ("uniform", 9, 128), ("few", 5, 128),
])
def test_hier_kernel_matches_twin(cuda_device, shape, R, max_draws):
    """B8 against its twin: R in 1..9 (R > 8 takes the scratch rows), the
    ragged hierarchy's per-lane top levels, the forced tail (max_draws=1)
    and R = D + 1 (the last slot stays -1)."""
    art = _hierarchy(cuda_device, shape).engine.hier_artifact()
    ids = _ids(65_537, cuda_device, seed=R)
    kw = dict(top_level=art.top_level, max_top=art.max_top, s_pad=art.s_pad,
              s_log2=1, max_draws=max_draws, n_replicas=R)
    before = LAUNCHES["hier_replicas"]
    got = hier_place_replicas_cuda(ids, *art.tables_dev, **kw)
    assert LAUNCHES["hier_replicas"] == before + 1
    assert torch.equal(got, hier_place_replicas_ref(ids, *art.tables_dev, **kw))
    if shape == "few":
        assert bool((got[:, 4:] == -1).all()) and bool((got[:, :4] >= 0).all())


def test_hier_wrapper_rejects_bad_cuda_inputs(cuda_device):
    art = _hierarchy(cuda_device, "uniform").engine.hier_artifact()
    tabs = list(art.tables_dev)
    kw = dict(top_level=art.top_level, max_top=art.max_top, s_pad=art.s_pad, n_replicas=2)
    ids = _ids(1024, cuda_device)
    before = dict(LAUNCHES)
    with pytest.raises(TypeError):
        hier_place_replicas_cuda(ids.to(torch.int64), *tabs, **kw)
    for i, bad in ((3, tabs[3].to(torch.int64)), (5, tabs[5][:-1]), (6, tabs[6].cpu())):
        wrong = list(tabs)
        wrong[i] = bad
        with pytest.raises((TypeError, ValueError)):
            hier_place_replicas_cuda(ids, *wrong, **kw)
    with pytest.raises(TypeError):
        place_cuda(ids.to(torch.int32), art.tables_dev[0], top_level=art.top_level)
    with pytest.raises(ValueError):
        place_cuda(ids, art.tables_dev[0][None], top_level=art.top_level)
    assert LAUNCHES == before


def test_hier_paths_on_card_have_no_host_sync_and_match_cpu(cuda_device):
    """``place_replica_pairs_device`` and the hierarchical serving driver
    under ``set_sync_debug_mode("error")``, equal to the CPU run."""
    topo = {d: {10 * d + i: 1.0 + 0.1 * i for i in range(6)} for d in range(7)}
    cfg = dict(policy="pow2", law="zipf", batch=4096, n_keys=10_000, seed=2, n_replicas=3)
    gpu_router, cpu_router = Router(topo, device=cuda_device), Router(topo, device="cpu")
    gpu, cpu = (r.stream_driver(**cfg) for r in (gpu_router, cpu_router))
    ids = _ids(50_001, cuda_device, seed=3)
    gpu_router.engine.hier_artifact()
    before = LAUNCHES["hier_replicas"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pairs = gpu_router.engine.place_replica_pairs_device(ids, 3)
        chosen = [gpu.step() for _ in range(3)] + list(gpu.superstep(2))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert LAUNCHES["hier_replicas"] == before + 6
    assert torch.equal(pairs.cpu(), cpu_router.engine.place_replica_pairs_device(ids.cpu(), 3))
    want = [cpu.step() for _ in range(3)] + list(cpu.superstep(2))
    for c, w in zip(chosen, want):
        assert torch.equal(c.cpu(), w)
    for name in ("counts", "queue", "qhist"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name))


# ---------------------------------------------------------------------------
# the staged searches (B5, B6, the fan-out) and B8's ladder counters
# ---------------------------------------------------------------------------

from repro_torch.kernels import launch  # noqa: E402


def _search_table(n, seed, *, runs=0):
    """A sorted u32 table of ``n`` keys (random owners): with ``runs``,
    runs of equal keys cross every index bucket boundary of the stride
    the launcher picks for ``n``, and the last keys are 0xFFFFFFFF."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))
    if runs:
        S = 1 << launch.index_shift(n)
        for b in range(max(S, 2), n - runs, S):
            keys[b - runs // 2: b + runs - runs // 2] = keys[b - runs // 2]
        keys[-runs:] = np.uint32(0xFFFFFFFF)
        keys = np.sort(keys)
    return keys, rng.integers(0, 4096, n).astype(np.int32)


def _index_edge_ids(keys, rng, extra=50_000):
    """Ids hashing to every index key of the stride the launcher picks,
    one above and one below each, 0 and 0xFFFFFFFF, plus random ids."""
    idx = keys[:: 1 << launch.index_shift(keys.shape[0])].astype(np.int64)
    h = np.unique(np.clip(np.concatenate([[0, 2**32 - 1], idx - 1, idx, idx + 1]),
                          0, 2**32 - 1)).astype(np.uint32)
    return np.concatenate([_unfmix32(h), rng.integers(0, 2**32, extra, dtype=np.uint32)])


@pytest.mark.parametrize("n,runs,offset", [
    (409_600, 6, 0),  # the 4096-node ring, S = 16, duplicates across buckets
    (409_603, 0, 0),  # not a multiple of S: a last bucket of 3 keys
    (1_000_064, 5, 0),  # the 10,000-node ring, S = 64
    (1_000_003, 0, 1),  # unaligned keys (a view one key in): scalar bucket loads
    (launch.INDEX_BUDGET // 4, 0, 0),  # the largest table staged whole
    (launch.INDEX_BUDGET // 4 + 1, 2, 0),  # S = 2
    (4 * (launch.INDEX_BUDGET // 4) + 5, 3, 0),  # S = 8, a ragged last bucket
])
@pytest.mark.parametrize("alg", ["ch", "rs"])
def test_staged_search_matches_twin_at_bucket_edges(cuda_device, alg, n, runs, offset):
    """B5 / B6 and the fan-out against the twins on tables that take each
    index stride: ids on, above and below every index key, equal keys
    straddling bucket boundaries, padding, ragged and unaligned tables."""
    keys, owners = _search_table(n + offset, seed=n, runs=runs)
    if alg == "rs":
        keys[0] = 0  # random slicing's first interval starts at 0
    k = torch.from_numpy(keys).to(cuda_device)[offset:]
    v = torch.from_numpy(owners).to(cuda_device)[offset:]
    ids = torch.from_numpy(_index_edge_ids(keys[offset:], np.random.default_rng(n))).to(
        cuda_device)
    place = getattr(tb, f"{alg}_place_cuda")
    assert torch.equal(place(ids, k, v), tr.LOOKUPS[alg](ids, k, v))
    got, st = tb.baseline_replicas_cuda(alg, ids, k, v, n_replicas=3, emit_stats=True)
    want, st_t = tr.baseline_replicas_lookup(alg, ids, k, v, n_replicas=3, emit_stats=True)
    assert torch.equal(got, want) and torch.equal(as_u32(st), as_u32(st_t))


@pytest.mark.parametrize("n_keys", [1, 4096, 12_288, 28_672, 28_673, 409_600, 1_000_064])
@pytest.mark.parametrize("alg,R", [
    ("ch", 0), ("ch", 1), ("ch", 3), ("ch", 12), ("rs", 0), ("rs", 1), ("rs", 3), ("rs", 12),
    ("wrh", 1), ("wrh", 3), ("wrh", 12),  # B7 has a kernel of its own: the fan-out only
])
def test_baseline_launch_plan_matches_its_statement(cuda_device, alg, R, n_keys):
    """The launcher's own plan (R = 0: B5 / B6's kernel, else the
    fan-out's) equals ``launch.baseline_plan`` on the launcher's SM count
    and occupancy."""
    keys = torch.zeros(n_keys, dtype=torch.uint32, device=cuda_device)
    for n in (1, 65_536 * 3, 2**24):
        got = tb.launch_plan(alg, keys, n, n_replicas=R)
        assert got == launch.baseline_plan(alg, n, n_keys, got["sms"], got["blocks_per_sm"])
        if alg != "wrh":
            props = torch.cuda.get_device_properties(cuda_device)
            assert got["sms"] == props.multi_processor_count and got["blocks_per_sm"] >= 1


def _racks(device, n_nodes, rack=64, seed=0):
    h = HierarchicalCluster(device=device)
    caps = np.random.default_rng(seed).uniform(0.5, 2.0, n_nodes)
    for n, c in enumerate(caps):
        h.add_node(n // rack, n, float(c))
    return h


@pytest.mark.parametrize("n_nodes", [4096, 10_000])
@pytest.mark.parametrize("R,max_draws,extra_levels", [
    (1, 128, 0), (3, 128, 0), (9, 128, 0), (3, 1, 0), (3, 128, 4),
])
def test_hier_kernel_matches_twin_at_full_width(cuda_device, n_nodes, R, max_draws,
                                                extra_levels):
    """B8 on 64 racks of 64 and on 157 racks of up to 64 (10,000 nodes)
    at R = 1, 3, 9, with the per-domain tail forced (max_draws=1), and
    with 4 levels more on the domain table's ladder: the counters below
    the register-held top levels in use on every draw that descends."""
    art = _racks(cuda_device, n_nodes).engine.hier_artifact()
    ids = _ids(70_001, cuda_device, seed=R + max_draws)
    kw = dict(top_level=art.top_level + extra_levels, max_top=art.max_top,
              s_pad=art.s_pad, s_log2=1, max_draws=max_draws, n_replicas=R)
    assert torch.equal(hier_place_replicas_cuda(ids, *art.tables_dev, **kw),
                       hier_place_replicas_ref(ids, *art.tables_dev, **kw))


# ---------------------------------------------------------------------------
# the consumers of placement on the card, against the same calls on the CPU
# ---------------------------------------------------------------------------


def test_pipeline_on_card_matches_cpu(cuda_device):
    from repro_torch.data import DataPipeline, ShardedDataset

    caps = LADDERS["64 nodes"]
    ds = ShardedDataset(n_shards=1 << 16, tokens_per_shard=256, vocab=997)
    clusters = {d: make_cluster(caps, device=d) for d in (cuda_device, "cpu")}
    before = LAUNCHES["place_fused"]
    pipes = {d: [DataPipeline(ds, c, h, batch_per_host=4, seq_len=64) for h in range(8)]
             for d, c in clusters.items()}
    assert LAUNCHES["place_fused"] == before + 8
    for a, b in zip(*pipes.values()):
        assert np.array_equal(a.owned_shards, b.owned_shards)
    for c in clusters.values():
        c.add_node(64, 1.5)
        c.remove_node(3)
    for a, b in zip(*pipes.values()):
        for x, y in zip(a.refresh_membership(), b.refresh_membership()):
            assert np.array_equal(x, y)
        for x, y in zip(a.batches(epoch=2), b.batches(epoch=2)):
            assert np.array_equal(x, y)
            break


@pytest.mark.parametrize("algorithm,R", [("asura", 1), ("asura", 3), ("ch", 1), ("rs", 1),
                                         ("wrh", 1)])
def test_coordinator_on_card_matches_cpu(cuda_device, algorithm, R):
    from repro_torch.runtime import ElasticCoordinator

    ids = np.random.default_rng(R).integers(0, 2**32, 50_000, dtype=np.uint32)
    coords = [ElasticCoordinator(make_cluster(LADDERS["64 nodes"], device=d), ids,
                                 algorithm=algorithm, n_replicas=R)
              for d in (cuda_device, "cpu")]
    for event in (lambda c: c.add_node(100, 1.3), lambda c: c.remove_node(7)):
        a, b = (event(c) for c in coords)
        assert a.moves == b.moves and a.n_moves > 0
        assert np.array_equal(coords[0].owners(), coords[1].owners())
    if algorithm != "asura":
        return
    live = [c.add_node_live(101, 0.8, ingress=500) for c in coords]
    assert live[0].round() == live[1].round()
    reverse = [c.rollback_live(m) for c, m in zip(coords, live)]
    assert reverse[0].run() == reverse[1].run()
    assert np.array_equal(coords[0].owners(), coords[1].owners())


def test_checkpoint_store_on_card_matches_cpu(cuda_device):
    from repro_torch.checkpoint import AsuraCheckpointStore, CheckpointManager

    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((700, 1024)).astype(np.float32))
    states = {cuda_device: {"w": w.to(cuda_device), "bf": w[:5].to(cuda_device, torch.bfloat16)},
              "cpu": {"w": w.clone(), "bf": w[:5].to(torch.bfloat16)}}
    caps = {i: float(c) for i, c in enumerate(LADDERS["64 nodes"])}
    stores = {d: AsuraCheckpointStore(caps, n_replicas=3, device=d) for d in states}
    mgrs = {d: CheckpointManager(s) for d, s in stores.items()}
    for d, m in mgrs.items():
        m.save_async(1, states[d])
        states[d]["w"].add_(1.0)  # in place, right after the call
        m.wait()
    moved = {d: s.add_node(64, 2.0) for d, s in stores.items()}
    assert moved[cuda_device] == moved["cpu"] > 0
    live = {d: s.begin_add_node(65, 1.0, ingress=16) for d, s in stores.items()}
    for m in live.values():
        m.run()
    for nid, node in stores["cpu"].nodes.items():
        assert stores[cuda_device].nodes[nid].blobs == node.blobs
    out = mgrs[cuda_device].restore(1, states[cuda_device])
    assert out["w"].device.type == "cuda" and out["bf"].dtype == torch.bfloat16
    assert torch.equal(out["w"].cpu(), w) and torch.equal(out["bf"].cpu(), states["cpu"]["bf"])


def test_durability_on_card_matches_cpu(cuda_device):
    from repro_torch.runtime.durability import compare_policies, movement_on_node_add

    topo = {d: {d * 4 + i: 1.0 for i in range(4)} for d in range(6)}
    kw = dict(n_objects=20_000, n_replicas=3, years=10.0, mttf_node_years=3.0,
              mttf_domain_years=15.0, seed=7)
    before = dict(LAUNCHES)
    card = compare_policies(topo, device=cuda_device, **kw)
    assert LAUNCHES["place_replicas"] > before["place_replicas"]
    assert LAUNCHES["hier_replicas"] > before["hier_replicas"]
    assert card == compare_policies(topo, device="cpu", **kw)
    assert movement_on_node_add(topo, n_objects=20_000, device=cuda_device) == \
        movement_on_node_add(topo, n_objects=20_000, device="cpu")


# ---------------------------------------------------------------------------
# the multi-card sweep at world size 1 on the card (NCCL), and the host
# staging a gloo group gives card tensors
# ---------------------------------------------------------------------------

import torch.distributed as dist  # noqa: E402

from repro_torch.launch.placement_mesh import ShardedSweep, make_data_mesh  # noqa: E402

MESH_FIELDS = ("ids", "src", "dst", "index", "slot", "src_slot")
OWNER_KERNEL = {"asura": "place_fused", "ch": "ch_place", "rs": "rs_place", "wrh": "wrh_place"}


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A world-size-1 NCCL group and its ``data`` mesh on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.cuda.set_device(0)
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    yield make_data_mesh(1, "cuda")
    dist.destroy_process_group()


@pytest.mark.parametrize("alg", ["asura", "ch", "rs", "wrh"])
def test_mesh_sweep_on_card_matches_engine(nccl_mesh, alg):
    engine = PlacementEngine(make_cluster(LADDERS["4096 nodes"]), algorithm=alg)
    sweep = ShardedSweep(engine, nccl_mesh)
    ids = _ids(20_011 if alg == "wrh" else 100_003, "cuda", seed=5)
    before = dict(LAUNCHES)
    owners = sweep.place_nodes(ids)
    assert LAUNCHES[OWNER_KERNEL[alg]] == before[OWNER_KERNEL[alg]] + 1
    assert np.array_equal(owners, engine.place_nodes(ids))
    assert np.array_equal(sweep.histogram(ids, 4096), np.bincount(owners, minlength=4096))
    assert engine.ledger.counter("mesh.host_staged") == 0


def test_mesh_matrix_and_plans_on_card_at_r3(nccl_mesh):
    cluster = make_cluster(LADDERS["4096 nodes"])
    engine = PlacementEngine(cluster)
    engine.artifact()
    v0 = cluster.version
    cluster.add_node(4096, 1.0)
    v1 = cluster.version
    sweep = ShardedSweep(engine, nccl_mesh)
    ids = np.random.default_rng(6).integers(0, 2**32, 100_003, dtype=np.uint32)
    planner = MigrationPlanner(engine)
    assert np.array_equal(sweep.histogram(ids, 4097, n_replicas=3), np.bincount(
        engine.place_replica_nodes(ids, 3).ravel(), minlength=4097))
    for R in (None, 3):
        plan = planner.plan(ids, v0, v1) if R is None else planner.plan_replicas(ids, v0, v1, R)
        splan = (planner.plan(ids, v0, v1, mesh=sweep) if R is None
                 else planner.plan_replicas(ids, v0, v1, R, mesh=nccl_mesh))
        for f in MESH_FIELDS:
            assert np.array_equal(getattr(splan, f), getattr(plan, f)), f
        n_moved, mat = sweep.movement_matrix(ids, v0, v1, 4097, n_replicas=R)
        want = np.zeros((4097, 4097), dtype=np.int64)
        np.add.at(want, (plan.src, plan.dst), 1)
        assert n_moved == plan.n_moves > 0 and np.array_equal(mat, want)


def test_mesh_serving_step_on_card_matches_plain_step(nccl_mesh):
    engine = PlacementEngine(make_cluster(LADDERS["4096 nodes"]))
    cfg = dict(batch=4096, n_keys=1 << 16, n_replicas=3, policy="pow2", seed=2)
    regs = (MetricsRegistry(), MetricsRegistry())
    shard = RequestStreamDriver(engine, mesh=nccl_mesh, metrics=regs[0], **cfg)
    solo = RequestStreamDriver(engine, metrics=regs[1], **cfg)
    before = LAUNCHES["place_replicas"]
    for _ in range(3):
        assert torch.equal(shard.step(), solo.step())
    assert LAUNCHES["place_replicas"] == before + 6
    assert torch.equal(shard.superstep(2), torch.stack([solo.step() for _ in range(2)]))
    for name in ("counts", "queue", "qhist"):
        assert torch.equal(getattr(shard, name), getattr(solo, name))
    snap, want = (r.snapshot() for r in regs)
    assert snap.keys() == want.keys()
    assert all(np.array_equal(snap[k], want[k]) for k in snap)


def test_gloo_mesh_stages_card_tensors_through_the_host(nccl_mesh):
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh.from_group(dist.new_group(backend="gloo"), "cuda",
                                 mesh_dim_names=("data",))
    engine = PlacementEngine(make_cluster(CAPS))
    sweep = ShardedSweep(engine, mesh)
    assert sweep.backend == "gloo"
    ids = _ids(10_001, "cuda", seed=7)
    owners = sweep.place_nodes(ids)
    assert np.array_equal(owners, engine.place_nodes(ids))
    assert np.array_equal(sweep.histogram(ids, 10), np.bincount(owners, minlength=10))
    assert engine.ledger.counter("mesh.host_staged") == 2  # one gather, one all-reduce



# ---------------------------------------------------------------------------
# The sharded model path on the card (chip_smoke.py phase 17a): the port's
# steps on a world-size-1 NCCL (data, model) mesh, every collective the
# identity, against the unsharded steps on the same card; reduced smollm.
# ---------------------------------------------------------------------------

from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402


@pytest.fixture(scope="module")
def sharded_smollm(nccl_mesh):
    """(cfg, params, opt, batch, decode batches, the (data, model) mesh)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, reduced_config
    from repro_torch.train import init_train_state

    cfg = reduced_config(get_config("smollm-135m"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=gen, device="cuda", dtype=torch.int32)
    steps = [{"tokens": tokens[:, t:t + 1], "positions": torch.full((4, 1), t, dtype=torch.int32,
                                                                   device="cuda")}
             for t in range(4)]
    return (cfg, params, init_train_state(cfg, params), {"tokens": tokens}, steps,
            make_debug_mesh(1, 1, "cuda"))


def _sharded(mesh):
    from repro_torch.models import hooks

    return hooks.activation_sharding(sh.activation_constraint_fn(mesh))


def test_sharded_train_and_prefill_on_card_equal_unsharded(sharded_smollm):
    """chip_smoke.py 17a's checks: AdamW from a warm-up of one step, the
    new parameters against AdamW in float64 of the step's own p, m, v
    (4 ulp; leaving them as they were, or doubling the update, reads far
    above), m and v leaf by leaf against each leaf's own max, grad_norm."""
    from repro_torch.train import AdamWConfig, make_prefill_step, make_train_step
    from repro_torch.train.optimizer import tree_flatten, update_reading

    cfg, params, opt, batch, _, mesh = sharded_smollm
    adamw = AdamWConfig(warmup_steps=1)
    p_u, o_u, m_u = make_train_step(cfg, adamw)(params, opt, batch)
    logits_u = make_prefill_step(cfg)(params, batch)
    with _sharded(mesh):
        p = sh.distribute_tree(params, sh.param_shardings(mesh, params))
        o = sh.distribute_tree(opt, sh.opt_shardings(mesh, params))
        b = sh.distribute_tree(batch, sh.batch_shardings(mesh, batch))
        p_s, o_s, m_s = make_train_step(cfg, adamw)(p, o, b)
        logits_s = make_prefill_step(cfg)(p, b)
    p_s, o_s, m_s = (sh.full_tree(t) for t in (p_s, o_s, m_s))
    loss_u, loss_s = float(m_u["loss"]), float(m_s["loss"])
    assert abs(loss_s - loss_u) <= 1e-5 * abs(loss_u), (loss_s, loss_u)
    norm_u, norm_s = float(m_u["grad_norm"]), float(m_s["grad_norm"])
    assert abs(norm_s - norm_u) <= 1e-3 * norm_u, (norm_s, norm_u)
    flat, rebuild = tree_flatten(params)
    doubled = rebuild([x + 2 * (y - x) for x, y in zip(flat, tree_flatten(p_s)[0])])
    readings = [update_reading(adamw, params, new, state, 4)
                for new, state in ((p_s, o_s), (p_u, o_u), (params, o_s), (doubled, o_s))]
    assert max(readings[:2]) <= 1.0 < min(readings[2:]), readings
    names = tree_flatten(sh.tree_map_with_path(lambda path, _: ".".join(path), params))[0]
    for key, limit in (("m", 0.1), ("v", 0.2)):
        for x, y, name in zip(tree_flatten(o_s[key])[0], tree_flatten(o_u[key])[0], names):
            diff, top = float((x - y).abs().max()), float(y.abs().max())
            assert diff <= limit * top, (key, name, diff, top)
    assert torch.equal(sh.full_tree(logits_s), logits_u)


def test_sharded_decode_on_card_equals_unsharded_without_host_sync(sharded_smollm):
    from repro_torch.models import init_cache
    from repro_torch.train import make_serve_step

    cfg, params, _, _, steps, mesh = sharded_smollm
    serve = make_serve_step(cfg)
    cache = init_cache(cfg, 4, 16, device="cuda")
    want = [serve(params, cache, b)[0] for b in steps]
    with _sharded(mesh):
        p = sh.distribute_tree(params, sh.serve_param_shardings(mesh, params))
        serve = make_serve_step(cfg)

        def new_cache():
            c = init_cache(cfg, 4, 16, device="cuda")
            return sh.distribute_tree(c, sh.cache_shardings(mesh, cfg, c))

        dsteps = [sh.distribute_tree(b, sh.batch_shardings(mesh, b)) for b in steps]
        serve(p, new_cache(), dsteps[0])  # warm-up on a cache of its own
        c, got = new_cache(), []
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for b in dsteps:
                logits, c = serve(p, c, b)
                got.append(logits)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for g, w in zip(got, want):
        assert torch.equal(sh.full_tree(g), w)
    from repro_torch.train.optimizer import tree_flatten

    for x, y in zip(tree_flatten(sh.full_tree(c))[0], tree_flatten(cache)[0]):
        assert torch.equal(x, y)

# ---------------------------------------------------------------------------
# The dense language-model serving path: the card's bf16 logits against an
# fp32 run of the same weights and inputs on the CPU, with the CPU's bf16
# run as the control, as chip_smoke.py's phase 13e holds them: max |card -
# fp32| within LM_NOISE_FACTOR x the control's max |cpu - fp32| (at least
# 2**-8 x max |fp32|); greedy tokens the fp32 run's wherever its top-2
# margin exceeds twice that limit.
# ---------------------------------------------------------------------------

LM_SERVED = ("smollm-135m", "granite-3-2b", "deepseek-7b", "command-r-35b")
LM_NOISE_FACTOR = 2.0


@contextlib.contextmanager
def _fp32_compute():
    from repro_torch.models import layers

    saved = layers.COMPUTE_DTYPE
    layers.set_compute_dtype(torch.float32)
    try:
        yield
    finally:
        layers.set_compute_dtype(saved)


def _lm_hold(card, cpu, truth):
    card, cpu, truth = (t.float().cpu() for t in (card, cpu, truth))
    control = max(float((cpu - truth).abs().max()), 2.0**-8 * float(truth.abs().max()))
    limit = LM_NOISE_FACTOR * control
    assert float((card - truth).abs().max()) <= limit
    top2 = truth.topk(2, dim=-1).values
    sure = top2[..., 0] - top2[..., 1] > 2 * limit
    assert torch.equal(card.argmax(-1)[sure], truth.argmax(-1)[sure])


def _lm_decode_runs(cfg, cpu_p, card_p, tokens, cache_len, device):
    """Each step's logits of a decode fed ``tokens`` (B, T), token t at
    position t, on the card, on the CPU and in fp32 on the CPU -> ({"cuda",
    "cpu", "fp32": [logits per step]}, {the same: the cache})."""
    from repro_torch.models import decode_step, init_cache

    b, steps = tokens.shape
    runs = (("cuda", card_p, device), ("cpu", cpu_p, "cpu"), ("fp32", cpu_p, "cpu"))
    out, caches = {}, {}
    for name, params, dev in runs:
        with _fp32_compute() if name == "fp32" else contextlib.nullcontext():
            cache = init_cache(cfg, b, cache_len, device=dev)
            out[name] = []
            for t in range(steps):
                batch = {"tokens": tokens[:, t:t + 1].to(dev),
                         "positions": torch.full((b, 1), t, dtype=torch.int32, device=dev)}
                logits, cache = decode_step(cfg, params, cache, batch)
                out[name].append(logits)
        caches[name] = cache
    return out, caches


def _lm_setup(arch, reduced=True):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, reduced_config

    cfg = get_config(arch)
    cfg = reduced_config(cfg) if reduced else cfg
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    return cfg, params, to(params, "cuda")


def _lm_tokens(cfg, shape, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32))


@pytest.mark.parametrize("arch", LM_SERVED + ("internvl2-26b",))
def test_lm_prefill_on_card_matches_cpu(cuda_device, arch):
    from repro_torch.models import prefill

    cfg, cpu_p, card_p = _lm_setup(arch)
    batch = {"tokens": _lm_tokens(cfg, (3, 20))}
    if cfg.vision_prefix:
        batch["patches"] = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (3, cfg.vision_prefix, cfg.d_model)).astype(np.float32))
    card = prefill(cfg, card_p, {k: v.to(cuda_device) for k, v in batch.items()})
    assert card.device.type == "cuda"
    with _fp32_compute():
        truth = prefill(cfg, cpu_p, batch)
    _lm_hold(card, prefill(cfg, cpu_p, batch), truth)


@pytest.mark.parametrize("cache_len", [16, 5])
@pytest.mark.parametrize("arch", LM_SERVED)
def test_lm_decode_on_card_matches_cpu(cuda_device, arch, cache_len):
    cfg, cpu_p, card_p = _lm_setup(arch)
    out, caches = _lm_decode_runs(cfg, cpu_p, card_p, _lm_tokens(cfg, (3, 9), seed=2),
                                  cache_len, cuda_device)
    for card, cpu, truth in zip(out["cuda"], out["cpu"], out["fp32"]):
        _lm_hold(card, cpu, truth)
    assert torch.equal(caches["cuda"]["dense_blocks"]["pos"].cpu(),
                       caches["cpu"]["dense_blocks"]["pos"])


def test_lm_decode_step_makes_no_host_sync(cuda_device):
    from repro_torch.models import init_cache
    from repro_torch.train import make_serve_step

    cfg, _, card_p = _lm_setup("smollm-135m")
    step = make_serve_step(cfg)
    cache = init_cache(cfg, 4, 8, device=cuda_device)
    batch = {"tokens": _lm_tokens(cfg, (4, 1)).to(cuda_device),
             "positions": torch.zeros((4, 1), dtype=torch.int32, device=cuda_device)}
    step(card_p, cache, batch)  # the working copy and cuBLAS are set up here
    batch["positions"] = torch.ones((4, 1), dtype=torch.int32, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = step(card_p, cache, batch)
        tokens = torch.argmax(logits, dim=-1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tokens.shape == (4,)
    assert cache["dense_blocks"]["index"].tolist() == [2] * cfg.n_layers


def test_lm_full_width_smollm_decode_on_card_matches_cpu(cuda_device):
    cfg, cpu_p, card_p = _lm_setup("smollm-135m", reduced=False)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (30, 576, 49152)
    out, _ = _lm_decode_runs(cfg, cpu_p, card_p, _lm_tokens(cfg, (2, 3), seed=3), 8,
                             cuda_device)
    for card, cpu, truth in zip(out["cuda"], out["cpu"], out["fp32"]):
        _lm_hold(card, cpu, truth)


# ---------------------------------------------------------------------------
# The language model's training path on the card (reduced configs): one
# step's loss, grad_norm and moments m and v held to an fp32 run on the CPU,
# the CPU's bf16 run the control, as chip_smoke.py's phase 14b holds them
# (max |card - fp32| within LM_NOISE_FACTOR x max |cpu - fp32|, at least
# 2**-8 x max |fp32|); the step free of host syncs; the training CLI.
# ---------------------------------------------------------------------------


def _lm_hold_values(card, cpu, truth, factor=LM_NOISE_FACTOR):
    def dist(xs, ys):
        return max(float((x.float().cpu() - y.float().cpu()).abs().max()) for x, y in zip(xs, ys))

    floor = 2.0**-8 * max(float(t.float().abs().max()) for t in truth)
    assert dist(card, truth) <= factor * max(dist(cpu, truth), floor)


def _lm_train_runs(cfg, cpu_p, card_p, batch, device):
    """One train step on the card, on the CPU and in fp32 on the CPU ->
    {"cuda", "cpu", "fp32": {"loss", "grad_norm", "m", "v": [tensors]}}."""
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.optimizer import tree_flatten

    step = make_train_step(cfg)
    out = {}
    for name, params, dev in (("cuda", card_p, device), ("cpu", cpu_p, "cpu"),
                              ("fp32", cpu_p, "cpu")):
        with _fp32_compute() if name == "fp32" else contextlib.nullcontext():
            b = {k: v.to(dev) for k, v in batch.items()}
            _, state, m = step(params, init_train_state(cfg, params), b)
        out[name] = {"loss": [m["loss"]], "grad_norm": [m["grad_norm"]],
                     "m": tree_flatten(state["m"])[0], "v": tree_flatten(state["v"])[0]}
    return out


@pytest.mark.parametrize("arch", LM_SERVED + ("internvl2-26b",))
def test_lm_train_step_on_card_matches_cpu(cuda_device, arch):
    cfg, cpu_p, card_p = _lm_setup(arch)
    batch = {"tokens": _lm_tokens(cfg, (4, 32), seed=4)}
    if cfg.vision_prefix:
        batch["patches"] = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (4, cfg.vision_prefix, cfg.d_model)).astype(np.float32))
    out = _lm_train_runs(cfg, cpu_p, card_p, batch, cuda_device)
    assert out["cuda"]["loss"][0].device.type == "cuda"
    for key in ("loss", "grad_norm", "m", "v"):
        _lm_hold_values(out["cuda"][key], out["cpu"][key], out["fp32"][key])


@pytest.mark.parametrize("seq", [64, 1024], ids=["256 tokens", "4096 tokens"])
@pytest.mark.parametrize("policy", ["nothing", "dots", "everything"])
def test_lm_train_step_makes_no_host_sync(cuda_device, policy, seq):
    """A microbatched step (2 x 2 rows) under sync debug "error", after a
    warm-up; 4096 tokens take the embedding gradient's sorted path."""
    from repro_torch.models.lm import set_remat_policy
    from repro_torch.train import init_train_state, make_train_step

    cfg, _, card_p = _lm_setup("smollm-135m")
    step = make_train_step(cfg, n_microbatches=2)
    batch = {"tokens": _lm_tokens(cfg, (4, seq)).to(cuda_device)}
    set_remat_policy(policy)
    try:
        params, opt, _ = step(card_p, init_train_state(cfg, card_p), batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            params, opt, m = step(params, opt, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    finally:
        set_remat_policy("nothing")
    assert bool(torch.isfinite(m["loss"])) and int(opt["count"]) == 2


def test_lm_remat_policies_agree_on_card(cuda_device):
    from repro_torch.models import loss_fn
    from repro_torch.models.lm import set_remat_policy
    from repro_torch.train.optimizer import tree_flatten

    cfg, _, card_p = _lm_setup("command-r-35b")
    batch = {"tokens": _lm_tokens(cfg, (4, 64), seed=5).to(cuda_device)}
    runs = {}
    try:
        for policy in ("everything", "nothing", "dots"):
            set_remat_policy(policy)
            leaves, rebuild = tree_flatten(card_p)
            xs = [p.detach().requires_grad_() for p in leaves]
            val, _ = loss_fn(cfg, rebuild(xs), batch)
            runs[policy] = [val.detach()] + list(torch.autograd.grad(val, xs))
    finally:
        set_remat_policy("nothing")
    for policy in ("nothing", "dots"):
        for a, b in zip(runs[policy], runs["everything"]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * float(b.abs().max()))


def test_lm_blockwise_train_step_on_card_matches_cpu(cuda_device, monkeypatch):
    """Above the threshold (chunks of 8 over 64 positions) the step runs
    through the online softmax's backward on the card."""
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "KV_CHUNK", 8)
    monkeypatch.setattr(layers, "BLOCKWISE_THRESHOLD", 16)
    cfg, cpu_p, card_p = _lm_setup("granite-3-2b")
    out = _lm_train_runs(cfg, cpu_p, card_p, {"tokens": _lm_tokens(cfg, (2, 64), seed=6)},
                         cuda_device)
    for key in ("loss", "grad_norm", "m", "v"):
        _lm_hold_values(out["cuda"][key], out["cpu"][key], out["fp32"][key])


def test_lm_train_cli_on_card(cuda_device):
    """The training CLI at the reduced size: the pipeline's sweep launches
    B1, the store's saves B2; two of six store nodes fail and the last save
    restores bit for bit."""
    from repro_torch.checkpoint.sharded import _flatten
    from repro_torch.kernels import reset_launches
    from repro_torch.launch import train

    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        rep = train.run(["--reduced", "--steps", "6", "--batch", "4", "--seq", "64",
                         "--ckpt-every", "3", "--lr", "1e-3"])
    assert rep["rc"] == 0 and rep["device"].type == "cuda" and rep["peak_bytes"] > 0
    assert LAUNCHES["place_fused"] > 0 and LAUNCHES["place_replicas"] > 0
    step, saved = rep["last_save"]
    for nid in (1, 3):
        rep["manager"].store.fail_node(nid)
    restored = rep["manager"].restore(step, saved)
    assert all(torch.equal(a, b) for a, b in zip(_flatten(restored)[0], _flatten(saved)[0]))


# ---------------------------------------------------------------------------
# The MoE language models on the card (reduced configs of mixtral-8x22b and
# deepseek-v2-236b).  Routing is discontinuous, so logits are held on the
# rows no route flip reached (``routes.route_changes``): the fp32-compute
# runs route alike except where the CPU's top-k gap is within 2**-14 of the
# largest |logit| and agree at rtol 1e-4 / atol 1e-5; the card's bf16 routes
# are the CPU bf16 run's except within 2**-5 (8 bf16 steps), and its logits
# are held to fp32 as above.  One train step is held as the dense one is, at
# 4.0 x the control (chip_smoke.py MOE_TRAIN_FACTOR).
# ---------------------------------------------------------------------------

LM_MOE = ("mixtral-8x22b", "deepseek-v2-236b")
ROUTE_EPS_FP32, ROUTE_EPS_BF16, MOE_TRAIN_FACTOR = 2.0**-14, 2.0**-5, 4.0


def _lm_routed_runs(cfg, cpu_p, card_p, tokens, device):
    """A prefill of ``tokens`` (B, T) and T decode steps fed them, on the
    card and the CPU in bf16 and in fp32 -> {run: [(logits, route calls)]}."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models.routes import RouteLog

    b, steps = tokens.shape
    out = {}
    for name, params, dev, fp32 in (("cuda", card_p, device, False), ("cpu", cpu_p, "cpu", False),
                                    ("cuda32", card_p, device, True), ("fp32", cpu_p, "cpu", True)):
        with _fp32_compute() if fp32 else contextlib.nullcontext():
            with RouteLog() as log:
                stages = [(prefill(cfg, params, {"tokens": tokens.to(dev)}), log.calls)]
            cache = init_cache(cfg, b, steps, device=dev)
            for t in range(steps):
                batch = {"tokens": tokens[:, t:t + 1].to(dev),
                         "positions": torch.full((b, 1), t, dtype=torch.int32, device=dev)}
                with RouteLog() as log:
                    logits, cache = decode_step(cfg, params, cache, batch)
                stages.append((logits, log.calls))
        out[name] = stages
    return out


@pytest.mark.parametrize("arch", LM_MOE)
def test_lm_moe_prefill_and_decode_on_card_match_cpu(cuda_device, arch):
    from repro_torch.models.routes import route_changes

    cfg, cpu_p, card_p = _lm_setup(arch)
    tokens = _lm_tokens(cfg, (8, 64), seed=7)  # 512 tokens: two dispatch groups
    runs = _lm_routed_runs(cfg, cpu_p, card_p, tokens, cuda_device)
    held_rows = 0
    hit32 = hit16 = None
    for i, ((card, card_r), (cpu, cpu_r), (c32, c32_r), (f32, f32_r)) in enumerate(
            zip(runs["cuda"], runs["cpu"], runs["cuda32"], runs["fp32"])):
        tpr = tokens.shape[1] if i == 0 else 1
        if i == 1:
            hit32 = hit16 = None  # decode runs against its own cache
        a = route_changes(f32_r, c32_r, tokens_per_row=tpr, eps=ROUTE_EPS_FP32, hit=hit32)
        b = route_changes(cpu_r, card_r, tokens_per_row=tpr, eps=ROUTE_EPS_BF16, hit=hit16)
        assert a["wide"] == b["wide"] == 0
        hit32, hit16 = ~a["held"], ~b["held"]
        torch.testing.assert_close(c32.cpu()[a["held"]], f32[a["held"]], rtol=1e-4, atol=1e-5)
        if b["held"].any():
            _lm_hold(card.cpu()[b["held"]], cpu[b["held"]], f32[b["held"]])
            held_rows += int(b["held"].sum())
    assert held_rows * 2 >= 8 * (tokens.shape[1] + 1)


@pytest.mark.parametrize("arch", LM_MOE)
def test_lm_moe_decode_step_makes_no_host_sync(cuda_device, arch):
    """Routing, capacity and the ring write all stay on the card."""
    from repro_torch.models import init_cache
    from repro_torch.train import make_serve_step

    cfg, _, card_p = _lm_setup(arch)
    step = make_serve_step(cfg)
    cache = init_cache(cfg, 8, 4, device=cuda_device)
    batch = {"tokens": _lm_tokens(cfg, (8, 1)).to(cuda_device),
             "positions": torch.zeros((8, 1), dtype=torch.int32, device=cuda_device)}
    step(card_p, cache, batch)
    batch["positions"] = torch.ones((8, 1), dtype=torch.int32, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = step(card_p, cache, batch)
        tokens = torch.argmax(logits, dim=-1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tokens.shape == (8,)
    assert cache["blocks"]["index"].tolist() == [2] * cache["blocks"]["index"].numel()


@pytest.mark.parametrize("arch", LM_MOE)
def test_lm_moe_train_step_on_card_matches_cpu(cuda_device, arch):
    cfg, cpu_p, card_p = _lm_setup(arch)
    out = _lm_train_runs(cfg, cpu_p, card_p, {"tokens": _lm_tokens(cfg, (2, 128), seed=8)},
                         cuda_device)
    for key in ("loss", "grad_norm", "m", "v"):
        _lm_hold_values(out["cuda"][key], out["cpu"][key], out["fp32"][key],
                        factor=MOE_TRAIN_FACTOR)


# ---------------------------------------------------------------------------
# The recurrent, RWKV and encoder-decoder families on the card (reduced
# configs of recurrentgemma-9b, rwkv6-3b and whisper-large-v3): a prefill of
# 300 tokens (three RWKV chunks, one padded) and 20 decode steps (past
# recurrentgemma's window of 16: its ring wraps), whisper's ``enc_out`` its
# own encoding of random frames.  fp32-compute runs of the card and the CPU
# agree at rtol 1e-4 / atol 1e-5; the card's bf16 logits are held to the
# CPU's fp32 run at REC_NOISE_FACTOR x the CPU bf16 control, one train step
# at REC_TRAIN_FACTOR (chip_smoke.py phase 16d / 16e, where the factors'
# grounds are stated).
# ---------------------------------------------------------------------------

LM_REC = ("recurrentgemma-9b", "rwkv6-3b", "whisper-large-v3")
REC_NOISE_FACTOR, REC_TRAIN_FACTOR = 3.0, 5.0


def _lm_rec_batch(cfg, shape, seed):
    batch = {"tokens": _lm_tokens(cfg, shape, seed=seed)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (shape[0], cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return batch


def _lm_rec_runs(cfg, cpu_p, card_p, batch, steps, device):
    """A prefill of ``batch`` and ``steps`` decode steps fed its first tokens
    against a fresh cache of the prompt's length (whisper: ``enc_out`` each
    run's own encoding of the frames), on the card and the CPU in bf16 and
    in fp32 -> ({run: [logits]}, {run: cache})."""
    from repro_torch.models import decode_step, init_cache, lm, prefill

    b, p = batch["tokens"].shape
    out, caches = {}, {}
    for name, params, dev, fp32 in (("cuda", card_p, device, False), ("cpu", cpu_p, "cpu", False),
                                    ("cuda32", card_p, device, True), ("fp32", cpu_p, "cpu", True)):
        with _fp32_compute() if fp32 else contextlib.nullcontext():
            on = {k: v.to(dev) for k, v in batch.items()}
            logits = [prefill(cfg, params, on)]
            cache = init_cache(cfg, b, p, device=dev)
            if cfg.family == "encdec":
                cache["enc_out"] = lm._encode(cfg, params, on["frames"]).to(
                    cache["enc_out"].dtype)
            for t in range(steps):
                step = {"tokens": on["tokens"][:, t:t + 1],
                        "positions": torch.full((b, 1), t, dtype=torch.int32, device=dev)}
                got, cache = decode_step(cfg, params, cache, step)
                logits.append(got)
        out[name], caches[name] = logits, cache
    return out, caches


@pytest.mark.parametrize("arch", LM_REC)
def test_lm_rec_prefill_and_decode_on_card_match_cpu(cuda_device, arch):
    from repro_torch.train.optimizer import tree_flatten

    cfg, cpu_p, card_p = _lm_setup(arch)
    out, caches = _lm_rec_runs(cfg, cpu_p, card_p, _lm_rec_batch(cfg, (8, 300), 9), 20,
                               cuda_device)
    for card, cpu, c32, truth in zip(out["cuda"], out["cpu"], out["cuda32"], out["fp32"]):
        torch.testing.assert_close(c32.cpu(), truth, rtol=1e-4, atol=1e-5)
        card, cpu, truth = (t.float().cpu() for t in (card, cpu, truth))
        control = max(float((cpu - truth).abs().max()), 2.0**-8 * float(truth.abs().max()))
        assert float((card - truth).abs().max()) <= REC_NOISE_FACTOR * control
    for a, b in zip(tree_flatten(caches["cuda"])[0], tree_flatten(caches["cpu"])[0]):
        if not a.is_floating_point():  # ring positions and indices
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("arch", LM_REC)
def test_lm_rec_decode_step_makes_no_host_sync(cuda_device, arch):
    """The recurrent states and rings are written on the card."""
    from repro_torch.models import init_cache
    from repro_torch.train import make_serve_step

    cfg, _, card_p = _lm_setup(arch)
    step = make_serve_step(cfg)
    cache = init_cache(cfg, 8, 4, device=cuda_device)
    batch = {"tokens": _lm_tokens(cfg, (8, 1)).to(cuda_device),
             "positions": torch.zeros((8, 1), dtype=torch.int32, device=cuda_device)}
    step(card_p, cache, batch)
    batch["positions"] = torch.ones((8, 1), dtype=torch.int32, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = step(card_p, cache, batch)
        tokens = torch.argmax(logits, dim=-1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tokens.shape == (8,)


@pytest.mark.parametrize("arch", LM_REC)
def test_lm_rec_train_step_on_card_matches_cpu(cuda_device, arch):
    cfg, cpu_p, card_p = _lm_setup(arch)
    out = _lm_train_runs(cfg, cpu_p, card_p, _lm_rec_batch(cfg, (2, 128), 10), cuda_device)
    for key in ("loss", "grad_norm", "m", "v"):
        _lm_hold_values(out["cuda"][key], out["cpu"][key], out["fp32"][key],
                        factor=REC_TRAIN_FACTOR)
