"""The port's multi-card sweep (``repro_torch.launch.placement_mesh``)
against the reference's, bit for bit, on the CPU.

Two halves, as ``tests/test_sharded_placement.py``:

  * IN PROCESS at world size 1: a module-scoped gloo group (``file://``
    init under a temporary directory).  Owners, histograms, replica
    histograms, movement matrices, the planner's ``mesh=`` plans and
    streams and the mesh serving stream are each compared with the
    reference's ``ShardedSweep`` on its own 1-device mesh, on the same ids
    (4,099, odd) and the same cluster (crossed over through its JSON).

  * FOUR RANKS: ``python -m repro_torch.launch.placement_mesh --selftest
    --devices 4 --device cpu`` spawns 4 gloo ranks (one thread each) that
    assert sharded == single-card on every rank; rank 0 writes its owners,
    histograms, matrices, plans and chosen nodes, which are compared here
    with the reference's single-device results.  The run starts with the
    module and overlaps the in-process cases.

Plus the port's deliberate divergences, pinned: the mesh needs an
initialized process group and spans all of it, node ids outside the bins
raise, and host-fed batches and migration windows refuse a mesh.
Exact equality everywhere: the whole stack is integer math.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro.core import PlacementEngine as JaxEngine
from repro.core import make_uniform_cluster as jax_uniform_cluster
from repro.launch.placement_mesh import ShardedSweep as JaxSweep
from repro.launch.placement_mesh import make_data_mesh as jax_mesh
from repro.migrate import MigrationPlanner as JaxPlanner
from repro.obs import MetricsRegistry as JaxMetrics
from repro.serve import RequestStreamDriver as JaxDriver
from repro_torch.convert import cluster_from_reference_json
from repro_torch.core import PlacementEngine
from repro_torch.launch import placement_mesh as pm
from repro_torch.launch.placement_mesh import ShardedSweep, make_data_mesh
from repro_torch.migrate import MigrationPlanner
from repro_torch.obs import MetricsRegistry

ROOT = Path(__file__).resolve().parents[1]
N_NODES = 16
N_IDS = 4_099  # odd: does not divide any mesh
FIELDS = ("ids", "src", "dst", "index", "slot", "src_slot")
RANKS = 4
SELFTEST_NODES = 32  # the selftest's cluster (repro.launch.placement_mesh.selftest)


@pytest.fixture(scope="module", autouse=True)
def four_ranks(tmp_path_factory):
    """The 4-rank selftest, started with the module: (process, npz path)."""
    out = tmp_path_factory.mktemp("ranks") / "rank0.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.placement_mesh", "--selftest",
         "--devices", str(RANKS), "--device", "cpu", "--ids", str(N_IDS),
         "--out", str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A world-size-1 gloo group for the in-process cases."""
    store = tmp_path_factory.mktemp("group") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh(group):
    return make_data_mesh(device_type="cpu")


def _pair(alg="asura"):
    """(reference engine, port engine) on equal uniform clusters."""
    jc = jax_uniform_cluster(N_NODES)
    tc = cluster_from_reference_json(jc.to_json(), device="cpu")
    return (JaxEngine(jc, backend="ref", algorithm=alg),
            PlacementEngine(tc, device="cpu", algorithm=alg))


@pytest.fixture(scope="module")
def versions(mesh):
    """Both sides after one add-node event, both versions cached:
    (ref engine, ref sweep, port engine, port sweep, ids, v0, v1)."""
    je, te = _pair()
    jsweep, tsweep = je.sharded(), te.sharded()
    je.artifact()
    te.artifact()
    v0 = te.cluster.version
    for eng in (je, te):
        eng.cluster.add_node(N_NODES, 1.0)
    assert je.cluster.version == te.cluster.version
    return je, jsweep, te, tsweep, np.arange(N_IDS, dtype=np.uint32), v0, te.cluster.version


def _same_plan(a, b):
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# in process, world size 1, against the reference's ShardedSweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alg", ["asura", "ch", "wrh", "rs"])
def test_sharded_owners_and_histogram_match_reference(alg, mesh):
    je, te = _pair(alg)
    jsweep, tsweep = JaxSweep(je, jax_mesh()), ShardedSweep(te, mesh)
    ids = np.arange(N_IDS, dtype=np.uint32)
    owners = tsweep.place_nodes(ids)
    assert owners.dtype == np.int64
    assert np.array_equal(owners, jsweep.place_nodes(ids))
    hist = tsweep.histogram(ids, N_NODES)
    assert hist.sum() == N_IDS  # pad lanes carry weight 0
    assert np.array_equal(hist, jsweep.histogram(ids, N_NODES))
    local = tsweep.place_nodes_device(ids)
    assert local.shape == (N_IDS,) and np.array_equal(local.numpy(), owners)


@pytest.mark.parametrize("n_replicas", [1, 3])
def test_sharded_replica_histogram(n_replicas, versions):
    _, jsweep, _, tsweep, ids, _, _ = versions
    hist = tsweep.histogram(ids, N_NODES + 1, n_replicas=n_replicas)
    assert hist.sum() == n_replicas * N_IDS
    assert np.array_equal(hist, jsweep.histogram(ids, N_NODES + 1, n_replicas=n_replicas))


def test_engine_sharded_accessor_caches_default(versions, mesh):
    te, tsweep = versions[2], versions[3]
    assert te.sharded() is tsweep  # the default-mesh sweep is cached
    other = te.sharded(mesh)
    assert other is not tsweep and other.n_devices == 1 and other.rank == 0


def test_diff_shards_match_reference(versions):
    _, jsweep, _, tsweep, ids, v0, v1 = versions
    for got, want in zip(tsweep.diff_nodes_device(ids, v0, v1),
                         jsweep.diff_nodes_device(ids, v0, v1)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tsweep.diff_replicas_device(ids, v0, v1, 3),
                         jsweep.diff_replicas_device(ids, v0, v1, 3)):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_replicas", [None, 3])
def test_movement_matrix_matches_plan_and_reference(n_replicas, versions):
    je, jsweep, te, tsweep, ids, v0, v1 = versions
    n_moved, mat = tsweep.movement_matrix(ids, v0, v1, N_NODES + 1, n_replicas=n_replicas)
    jn, jmat = jsweep.movement_matrix(ids, v0, v1, N_NODES + 1, n_replicas=n_replicas)
    assert n_moved == jn and np.array_equal(mat, jmat)
    planner = MigrationPlanner(te)
    plan = (planner.plan(ids, v0, v1) if n_replicas is None
            else planner.plan_replicas(ids, v0, v1, n_replicas))
    assert n_moved == plan.n_moves == mat.sum() > 0
    want = np.zeros_like(mat)
    np.add.at(want, (plan.src, plan.dst), 1)
    assert np.array_equal(mat, want)


def test_planner_mesh_kwarg_matches_reference(versions):
    je, jsweep, te, tsweep, ids, v0, v1 = versions
    planner, jplanner = MigrationPlanner(te), JaxPlanner(je)
    want = jplanner.plan(ids, v0, v1, mesh=jsweep)
    for mesh_arg in (tsweep, tsweep.mesh):
        _same_plan(planner.plan(ids, v0, v1, mesh=mesh_arg), want)
    # ragged chunks with the ADDITION-NUMBER prefilter: the same plan
    _same_plan(planner.plan(ids, v0, v1, mesh=tsweep, chunk=1000, max_new_seg=1 << 30), want)
    for R in (1, 3):
        _same_plan(planner.plan_replicas(ids, v0, v1, R, mesh=tsweep),
                   jplanner.plan_replicas(ids, v0, v1, R, mesh=jsweep))


def test_rejects_non_data_mesh(versions, group):
    te = versions[2]
    with pytest.raises(ValueError, match="must be 1-D"):
        ShardedSweep(te, init_device_mesh("cpu", (1,), mesh_dim_names=("model",)))
    with pytest.raises(ValueError, match="must be 1-D"):
        MigrationPlanner(te).plan(versions[4], versions[5], versions[6], mesh=object())


def test_ragged_stream_chunks_produce_no_phantom_moves(versions):
    """Streamed moved rows equal the plan's for ragged chunkings: the pad
    lanes (zero ids) are masked out of ``moved``, never trusted to place
    alike under both versions."""
    je, jsweep, te, tsweep, ids, v0, v1 = versions
    planner = MigrationPlanner(te)
    want = JaxPlanner(je).plan(ids, v0, v1).n_moves
    for chunk, mesh_arg in ((1000, None), (1 << 10, None), (777, tsweep)):
        total = 0
        for padded, moved, _, _ in planner.plan_stream(
            planner.chunked(ids, chunk), v0, v1, mesh=mesh_arg
        ):
            assert moved.shape[0] == padded.shape[0]
            total += int(moved.sum())
        assert total == want, f"phantom/lost moves at chunk={chunk}"


@pytest.mark.parametrize("n_replicas", [1, 3])
def test_ragged_replica_stream_no_phantom_moves(n_replicas, versions):
    je, jsweep, te, tsweep, ids, v0, v1 = versions
    planner = MigrationPlanner(te)
    want = JaxPlanner(je).plan_replicas(ids, v0, v1, n_replicas).n_moves
    for chunk, mesh_arg in ((1000, None), (777, tsweep)):
        total = sum(int(moved.sum()) for _, moved, _, _, _ in planner.plan_replicas_stream(
            planner.chunked(ids, chunk), v0, v1, n_replicas, mesh=mesh_arg))
        assert total == want, f"phantom/lost replica moves at chunk={chunk}"


def test_device_chunk_tail_pads_on_device(versions):
    """A ragged tensor chunk pads where it lies and masks its tail, on one
    card and over the mesh alike."""
    je, _, te, tsweep, _, v0, v1 = versions
    planner = MigrationPlanner(te)
    want = JaxPlanner(je).plan(np.arange(900, dtype=np.uint32), v0, v1).n_moves
    chunk = torch.arange(900, dtype=torch.int64).to(torch.uint32)
    for mesh_arg in (None, tsweep):
        [(padded, moved, _, _)] = list(planner.plan_stream([chunk], v0, v1, mesh=mesh_arg))
        assert isinstance(padded, torch.Tensor) and padded.shape[0] == 1024
        assert int(moved[900:].sum()) == 0
        assert int(moved.sum()) == want


def test_mesh_serving_matches_reference_mesh_stream(versions):
    """The mesh stream at world size 1 (instrumented, R = 3, pow2) equals
    the reference's mesh stream: chosen nodes, counters, queue and slab,
    with one all-reduce and one gather per step."""
    je, jsweep, te, tsweep, _, _, _ = versions
    kw = dict(batch=256, n_keys=4096, law="zipf", n_replicas=3, policy="pow2", seed=7)
    reg, jreg = MetricsRegistry(device="cpu"), JaxMetrics()
    port = tsweep.serve_stream(metrics=reg, **kw)
    ref = JaxDriver(je, mesh=jsweep.mesh, metrics=jreg, **kw)
    reduces = te.ledger.counter("mesh.all_reduces")
    for _ in range(3):
        assert np.array_equal(port.step().numpy(), np.asarray(ref.step()))
    assert te.ledger.counter("mesh.all_reduces") == reduces + 3
    assert np.array_equal(port.load_counts(), np.asarray(ref.load_counts()))
    assert np.array_equal(port.queue.numpy(), np.asarray(ref.queue))
    assert np.array_equal(np.asarray(port.superstep(2)), np.asarray(ref.superstep(2)))
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert set(snap) == set(jsnap)
    for name in snap:
        assert np.array_equal(np.asarray(snap[name]), np.asarray(jsnap[name])), name


# ---------------------------------------------------------------------------
# the port's divergences, pinned
# ---------------------------------------------------------------------------


def test_make_data_mesh_needs_a_process_group(monkeypatch):
    monkeypatch.setattr(pm.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        make_data_mesh(device_type="cpu")


def test_make_data_mesh_spans_the_whole_group(group):
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        make_data_mesh(2, device_type="cpu")
    assert make_data_mesh(1, device_type="cpu").size() == 1


def test_sweep_refuses_a_mesh_of_another_device_type(versions, group):
    cuda_mesh = type("M", (), {"mesh_dim_names": ("data",), "device_type": "cuda"})()
    with pytest.raises(ValueError, match="engine places on cpu"):
        ShardedSweep(versions[2], cuda_mesh)


def test_node_ids_outside_the_bins_raise(versions):
    _, _, _, tsweep, ids, v0, v1 = versions
    with pytest.raises(ValueError, match="outside the 16 bins"):
        tsweep.histogram(ids, N_NODES)  # node 16 joined in v1
    with pytest.raises(ValueError, match="outside the 16 bins"):
        tsweep.movement_matrix(ids, v0, v1, N_NODES)
    with pytest.raises(ValueError, match="ASURA-only"):
        tsweep.histogram(ids, N_NODES + 1, algorithm="ch", n_replicas=3)


def test_host_fed_batches_and_windows_refuse_a_mesh(versions):
    """The reference's messages: host-fed batches and migration windows
    stay single-device."""
    te, tsweep = versions[2], versions[3]
    driver = tsweep.serve_stream(batch=64, n_keys=256, n_replicas=3)
    with pytest.raises(ValueError, match="route_batch serves host-fed batches single-device"):
        driver.route_batch(np.arange(10, dtype=np.uint32))
    window = type("W", (), {"n_replicas": 3})()
    for call in (lambda: driver.serve_migrating(window),
                 lambda: driver.superstep_migrating(window, 2)):
        with pytest.raises(ValueError, match="migration windows are single-device"):
            call()


# ---------------------------------------------------------------------------
# four ranks: the port's selftest, and rank 0's results against the reference
# ---------------------------------------------------------------------------


def _reference_results() -> dict:
    """The reference's single-device results on the selftest's inputs."""
    out = {}
    ids = np.arange(N_IDS, dtype=np.uint32)
    for alg in ("asura", "ch", "wrh", "rs"):
        eng = JaxEngine(jax_uniform_cluster(SELFTEST_NODES), backend="numpy", algorithm=alg)
        out[f"owners_{alg}"] = owners = eng.place_nodes(ids)
        out[f"hist_{alg}"] = np.bincount(owners, minlength=SELFTEST_NODES)
    cluster = jax_uniform_cluster(SELFTEST_NODES)
    eng = JaxEngine(cluster, backend="numpy")
    for R in (1, 3):
        nodes = eng.place_replica_nodes(ids, R)
        out[f"rhist_{R}"] = np.bincount(nodes.ravel(), minlength=SELFTEST_NODES)
    eng.artifact()
    v0 = cluster.version
    cluster.add_node(SELFTEST_NODES, 1.0)
    planner = JaxPlanner(eng)
    plan = planner.plan(ids, v0, cluster.version)
    for f in FIELDS:
        out[f"plan_{f}"] = getattr(plan, f)
    out["n_moved"] = plan.n_moves
    out["mat"] = np.zeros((SELFTEST_NODES + 1,) * 2, dtype=np.int64)
    np.add.at(out["mat"], (plan.src, plan.dst), 1)
    for R in (1, 3):
        rplan = planner.plan_replicas(ids, v0, cluster.version, R)
        for f in FIELDS:
            out[f"rplan{R}_{f}"] = getattr(rplan, f)
        out[f"rmat_{R}"] = np.zeros_like(out["mat"])
        np.add.at(out[f"rmat_{R}"], (rplan.src, rplan.dst), 1)
    # the selftest's ASURA stream (R = 3) and the 10-node, batch-256
    # stream of the reference's own mesh superstep test
    kw = dict(batch=256 * RANKS, n_keys=4096, law="zipf", n_replicas=3, policy="pow2", seed=7)
    solo = JaxDriver(JaxEngine(jax_uniform_cluster(16), backend="ref"), **kw)
    for step in range(3):
        out[f"chosen_asura_3_{step}"] = np.asarray(solo.step())
    solo = JaxDriver(JaxEngine(jax_uniform_cluster(10), backend="ref"), batch=256,
                     n_keys=1 << 12, n_replicas=3, policy="pow2", seed=3)
    for block in range(2):
        out[f"super10_chosen_{block}"] = np.stack([np.asarray(solo.step()) for _ in range(3)])
    out["super10_counts"] = np.asarray(solo.load_counts())
    return out


def test_selftest_on_4_gloo_ranks_matches_reference(four_ranks):
    proc, out = four_ranks
    want = _reference_results()
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"selftest failed:\n{stderr[-3000:]}"
    assert "sharded placement selftest OK on 4 ranks" in stdout
    assert "backend gloo on cpu, mesh.host_staged 0" in stdout
    got = np.load(out)
    assert int(got["refused_batch"]) == 1  # a batch not divisible by 4 raised
    for key, value in want.items():
        assert np.array_equal(got[key], np.asarray(value)), key
