"""Multi-card scale-out of the placement / diff path (DESIGN.md section 11).

The port of the reference's ``ShardedSweep``.  Everything the repo does at
cluster scale -- uniformity histograms, section-6.D movement accounting,
migration planning, the serving stream -- is bulk work over millions of
ids, and the placement and diff kernels are embarrassingly parallel over
ids.  Where the reference is single-controller (one process ``shard_map``s
its kernels over a ``jax.sharding.Mesh``), the port is SPMD over
``torch.distributed``: one process per card (or several processes sharing
one), one process group, and a 1-D ``DeviceMesh`` over it whose only axis
is ``data``.

The calling contract: EVERY RANK calls each method with the same
arguments -- the same full id stream, the same versions, the same engine
state (each rank builds its cluster from the same calls, or from the same
``Cluster.to_json()`` blob through ``repro_torch.convert``).  Then:

  * the id stream is zero-padded to a multiple of the world size and rank
    r works on lanes ``[r * local, (r + 1) * local)``; pad lanes carry
    weight 0, so they never reach a histogram, a matrix or a ``moved``
    row;
  * the table artifacts are not partitioned: every rank's engine holds
    its own copy (kilobytes to a few MiB);
  * each rank runs its engine's own device path on its shard -- kernel B1
    for ASURA owners, B5 / B6 / B7 for CH / RS / WRH owners, B2 for
    replica histograms, B3 / B4 for the diffs, and in the serving stream
    B2, the baselines' fan-out or B8 -- so per-lane results equal the
    single-card sweep by construction (on the CPU the twins run);
  * ``*_device`` methods return the rank's LOCAL shard on its device;
    host-facing methods (``place_nodes``, the planner's plans) gather every
    shard onto every rank with ONE ``all_gather`` and trim the pad;
  * histograms, movement matrices and moved counts are integer
    scatter-adds into an int32 partial, merged by ONE ``all_reduce(SUM)``
    per sweep: integer addition is exact, so the result equals the
    single-card sweep bit for bit, as the reference's one ``psum``.

A CUDA tensor on a gloo group (several ranks sharing one card, where NCCL
refuses) crosses the group through the host: a rule by backend, counted by
the engine ledger's ``mesh.host_staged``.  The kernels still run on the
card.  ``mesh.all_reduces`` and ``mesh.all_gathers`` count the
collectives.

    python -m repro_torch.launch.placement_mesh --selftest --devices 4 --device cpu

spawns 4 ranks (gloo on the CPU; on the card NCCL at one rank per card,
gloo when ranks share a card) and asserts, on every rank, that every
sharded result equals the same engine's single-card path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..kernels.ops import as_ids

DATA_AXIS = "data"


def make_data_mesh(n_devices: int | None = None, device_type: str | None = None):
    """1-D placement mesh (axis ``data``) over the initialized default
    process group; ``device_type`` defaults to the card ("cuda"; raises
    without one), as every entry point of the port.

    The group is the caller's to set up (``torch.distributed.
    init_process_group``); none is built here.  ``n_devices``, when given,
    must equal the world size: the reference's "first n devices" has no
    SPMD counterpart (every rank of the group calls every sweep)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialized: call "
            "torch.distributed.init_process_group(...) on every rank first"
        )
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"asked for {n_devices} devices, but the process group has {world} "
            "ranks (the mesh spans the whole group)"
        )
    if device_type is None:
        device_type = resolve_device(None).type
    return init_device_mesh(device_type, (world,), mesh_dim_names=(DATA_AXIS,))


class ShardedSweep:
    """Mesh-wide bulk placement / diff sweeps bound to one ``PlacementEngine``.

    Construction is cheap (no collective, no upload).  Every method accepts
    an id stream of ANY length (a NumPy array or an integer tensor): it is
    zero-padded to a multiple of the world size and the pad lanes carry
    weight 0.  See the module docstring for the calling contract."""

    def __init__(self, engine, mesh=None):
        self.engine = engine
        self.mesh = make_data_mesh(device_type=engine.device.type) if mesh is None else mesh
        names = tuple(getattr(self.mesh, "mesh_dim_names", None) or ())
        if names != (DATA_AXIS,):
            raise ValueError(
                f"placement mesh must be 1-D over ('{DATA_AXIS}',); got axes {names}"
            )
        if self.mesh.device_type != engine.device.type:
            raise ValueError(
                f"the mesh is over {self.mesh.device_type!r} devices but the "
                f"engine places on {engine.device}"
            )
        self.group = self.mesh.get_group(DATA_AXIS)
        self.backend = dist.get_backend(self.group)
        self.n_devices = int(self.mesh.size())
        self.rank = int(self.mesh.get_local_rank(DATA_AXIS))
        self.ledger = engine.ledger

    # -- padding and the rank's shard ----------------------------------------

    def _pad(self, datum_ids):
        """(ids, n_valid): ``datum_ids`` zero-padded to a multiple of
        ``n_devices`` (a tensor pads where it lies); the lanes from
        ``n_valid`` on are pad lanes, weight 0."""
        if isinstance(datum_ids, torch.Tensor):
            ids = datum_ids.reshape(-1)
        else:
            ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
        n = int(ids.shape[0])
        pad = (-n) % self.n_devices
        if pad and isinstance(ids, torch.Tensor):
            ids = torch.cat([ids, ids.new_zeros(pad)])
        elif pad:
            ids = np.concatenate([ids, np.zeros(pad, dtype=np.uint32)])
        return ids, n

    def bounds(self, n_padded: int) -> tuple[int, int]:
        """This rank's lanes ``[lo, hi)`` of a padded stream."""
        local = int(n_padded) // self.n_devices
        return self.rank * local, (self.rank + 1) * local

    def _local(self, datum_ids):
        """(ids, valid, n_valid): this rank's slice of the padded stream as
        a uint32 tensor on the engine's device (host ids are sliced before
        the upload) and its weight mask, False on the pad lanes."""
        ids, n = self._pad(datum_ids)
        lo, hi = self.bounds(ids.shape[0])
        local = as_ids(ids[lo:hi], self.engine.device)
        valid = torch.arange(lo, hi, device=local.device) < n
        return local, valid, n

    # -- collectives -----------------------------------------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        """A CUDA tensor on a gloo group crosses it through the host."""
        staged = t.device.type == "cuda" and self.backend == "gloo"
        if staged:
            self.ledger.incr("mesh.host_staged")
        return staged

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the mesh, in place (exact on integer tensors)."""
        self.ledger.incr("mesh.all_reduces")
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def gather(self, *tensors: torch.Tensor, dim: int = 0):
        """Every rank's shard of each tensor, concatenated along ``dim`` in
        rank order, on this rank's device -- ONE ``all_gather``: several
        tensors of one shape ride packed as int32 columns (bool and int32
        outputs are exact in int32)."""
        if len(tensors) == 1:
            packed = tensors[0].contiguous()
        else:
            packed = torch.stack([t.to(torch.int32) for t in tensors], dim=-1)
        self.ledger.incr("mesh.all_gathers")
        send = packed.cpu() if self._staged(packed) else packed
        parts = [torch.empty_like(send) for _ in range(self.n_devices)]
        dist.all_gather(parts, send, group=self.group)
        whole = torch.cat(parts, dim=dim).to(packed.device)
        if len(tensors) == 1:
            return whole
        return tuple(whole[..., i].to(t.dtype) for i, t in enumerate(tensors))

    # -- bin checks ------------------------------------------------------------

    def _check_bins(self, n_bins: int, arts) -> None:
        """A node id outside ``n_bins`` raises on the host (the reference's
        scatter drops it silently; on the card it would be a device
        fault)."""
        from ..serve.stream import top_node

        for art in arts:
            top = top_node(art)
            if top >= n_bins:
                raise ValueError(
                    f"node id {top} is outside the {n_bins} bins of this sweep"
                )

    # -- per-id sweeps (local shards) --------------------------------------------

    def place_nodes_device(self, datum_ids, algorithm: str | None = None) -> torch.Tensor:
        """This rank's shard of the padded stream's owners -> (local,) int32
        on the engine's device (pad lanes place id 0; ``place_nodes`` gives
        the exact stream)."""
        ids, _, _ = self._local(datum_ids)
        return self.engine.place_nodes_device(ids, algorithm)

    def place_nodes(self, datum_ids, algorithm: str | None = None) -> np.ndarray:
        """Host-facing mesh placement -> int64 owners of the whole stream on
        every rank, equal to ``engine.place_nodes`` (one gather, pad
        trimmed)."""
        ids, n = self._pad(datum_ids)
        out = self.gather(self.place_nodes_device(ids, algorithm))
        return out[:n].cpu().numpy().astype(np.int64)

    def diff_nodes_device(self, datum_ids, v_from: int, v_to: int):
        """This rank's shard of the two-version diff -> ``(moved, src,
        dst)``, each (local,) on the engine's device; pad lanes have
        ``moved`` False."""
        self.engine._require_asura("diff_nodes_device")
        ids, valid, _ = self._local(datum_ids)
        moved, src, dst = self.engine.diff_nodes_device(ids, v_from, v_to)
        return moved & valid, src, dst

    def diff_replicas_device(self, datum_ids, v_from: int, v_to: int, n_replicas: int):
        """This rank's shard of the replica-set diff -> ``(moved, src, dst,
        src_slot)``, each (local, R); pad rows have ``moved`` all False."""
        self.engine._require_asura("diff_replicas_device")
        ids, valid, _ = self._local(datum_ids)
        moved, src, dst, src_slot = self.engine.diff_replicas_device(
            ids, v_from, v_to, n_replicas
        )
        return moved & valid[:, None], src, dst, src_slot

    # -- one-reduction sweeps --------------------------------------------------

    def histogram(
        self,
        datum_ids,
        n_bins: int,
        algorithm: str | None = None,
        n_replicas: int | None = None,
    ) -> np.ndarray:
        """Per-node occupancy histogram in ONE mesh sweep -> (n_bins,) int64
        on every rank, equal to ``np.bincount(engine.place_nodes(ids),
        minlength=n_bins)``; each rank scatter-adds its weight-masked
        owners, one all-reduce sums the partials.  With ``n_replicas`` the
        ASURA replica sets are counted (R counts per id; -1 slots
        excluded)."""
        alg = self.engine._resolve_algorithm(algorithm)
        ids, valid, _ = self._local(datum_ids)
        if n_replicas is None:
            eng = self.engine
            self._check_bins(n_bins, [eng.hier_artifact() if eng.hierarchical
                                      else eng.artifact(alg)])
            nodes = self.engine.place_nodes_device(ids, alg)
            weight = valid
        else:
            if alg != "asura" or self.engine.hierarchical:
                raise ValueError("replica histograms are ASURA-only (flat tables)")
            self._check_bins(n_bins, [self.engine.artifact("asura")])
            nodes = self.engine.place_replica_nodes_device(ids, n_replicas, "asura")
            weight = valid[:, None]
        weight = (weight & (nodes >= 0)).to(torch.int32).reshape(-1)
        hist = torch.zeros(n_bins, dtype=torch.int32, device=ids.device)
        hist.scatter_add_(0, nodes.reshape(-1).clamp(min=0).long(), weight)
        return self.all_reduce(hist).cpu().numpy().astype(np.int64)

    def movement_matrix(
        self,
        datum_ids,
        v_from: int,
        v_to: int,
        n_bins: int,
        n_replicas: int | None = None,
    ) -> tuple[int, np.ndarray]:
        """(n_moved, (n_bins, n_bins) int64 src -> dst matrix) in ONE mesh
        sweep: each rank diffs its shard (per owner, or per replica slot
        with ``n_replicas``) and scatter-adds its moved rows into an int32
        partial; one all-reduce sums them.  ``n_moved`` is the matrix
        total -- the single-card planner's moved rows, bit for bit."""
        eng = self.engine
        eng._require_asura("movement_matrix")
        self._check_bins(n_bins, [eng.artifact_for(v, "asura") for v in (v_from, v_to)])
        if n_replicas is None:
            moved, src, dst = self.diff_nodes_device(datum_ids, v_from, v_to)
        else:
            moved, src, dst, _ = self.diff_replicas_device(
                datum_ids, v_from, v_to, n_replicas
            )
        cell = src.clamp(min=0).long() * n_bins + dst.clamp(min=0).long()
        mat = torch.zeros(n_bins * n_bins, dtype=torch.int32, device=cell.device)
        mat.scatter_add_(0, cell.reshape(-1), moved.reshape(-1).to(torch.int32))
        mat = self.all_reduce(mat).cpu().numpy().astype(np.int64).reshape(n_bins, n_bins)
        return int(mat.sum()), mat

    # -- serving (DESIGN.md section 12) ----------------------------------------

    def serve_stream(self, **kwargs):
        """A ``RequestStreamDriver`` sharding its request stream over this
        mesh: each rank draws its slice of the global lanes (the same words
        as the single-card stream, by the counter-based construction),
        routes and selects against the start-of-batch counters (equal on
        every rank), and the per-node histogram merges with ONE all-reduce
        per batch -- equal to the single-card stream bit for bit."""
        from ..serve.stream import RequestStreamDriver

        return RequestStreamDriver(self.engine, mesh=self, **kwargs)


# ---------------------------------------------------------------------------
# Bit-identity selftest (every rank runs it; the spawn below, tests and
# chip_smoke.py call it)
# ---------------------------------------------------------------------------


def _expect(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _same(a, b, msg: str) -> None:
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    _expect(a.shape == b.shape and np.array_equal(a, b), msg)


def selftest(
    n_devices: int | None = None,
    n_ids: int = 100_003,
    *,
    device=None,
    batch: int | None = None,
    record: dict | None = None,
) -> int:
    """Assert sharded == the same engine's single-card path on this rank:
    owners and histograms under all four algorithms, replica histograms
    at R in {1, 3}, diffs, movement matrices, the planner's ``mesh=``
    plans and streams, mesh serving for every algorithm and R, the
    instrumented metrics slab, two-level serving on a 4 x 4 hierarchy and
    a mesh ``superstep``.  Every rank of the group calls it.

    ``n_ids`` should not divide the mesh, so the pad-lane masking is
    exercised everywhere; ``batch`` is the serving batch (default 256 per
    rank).  ``record``, when given, receives the results as NumPy arrays.
    Returns the number of ranks."""
    from ..core import HierarchicalCluster, PlacementEngine, make_uniform_cluster
    from ..migrate import MigrationPlanner
    from ..obs import MetricsRegistry
    from ..serve import RequestStreamDriver

    dev = resolve_device(device)
    mesh = make_data_mesh(n_devices, dev.type)
    world = int(mesh.size())
    rec = {} if record is None else record
    engines = []

    def engine(cluster, **kw):
        engines.append(PlacementEngine(cluster, device=dev, **kw))
        return engines[-1]

    n_nodes = 32
    ids = np.arange(n_ids, dtype=np.uint32)

    # placement + histogram, all four algorithms
    cluster = make_uniform_cluster(n_nodes)
    for alg in ("asura", "ch", "wrh", "rs"):
        eng = engine(cluster, algorithm=alg)
        sw = ShardedSweep(eng, mesh)
        ref = eng.place_nodes(ids)
        got = rec[f"owners_{alg}"] = sw.place_nodes(ids)
        _same(got, ref, f"{alg}: sharded owners differ")
        hist = rec[f"hist_{alg}"] = sw.histogram(ids, n_nodes)
        _same(hist, np.bincount(ref, minlength=n_nodes), f"{alg}: sharded histogram differs")

    eng = engine(cluster)
    sweep = ShardedSweep(eng, mesh)

    # replica histograms, R in {1, 3}
    for R in (1, 3):
        nodes = eng.place_replica_nodes(ids, R)
        hist = rec[f"rhist_{R}"] = sweep.histogram(ids, n_nodes, n_replicas=R)
        _same(hist, np.bincount(nodes.ravel(), minlength=n_nodes),
              f"R={R}: sharded replica histogram differs")

    # version diff + movement matrix + sharded planner, R in {1, 3}
    eng.artifact()
    v0 = cluster.version
    cluster.add_node(n_nodes, 1.0)
    v1 = cluster.version
    padded, _ = sweep._pad(ids)
    lo, hi = sweep.bounds(padded.shape[0])
    valid = torch.arange(lo, hi, device=dev) < n_ids
    whole = eng.diff_nodes_device(padded, v0, v1)
    for got, want in zip(sweep.diff_nodes_device(ids, v0, v1), whole):
        _same(got, want[lo:hi] & valid if got.dtype == torch.bool else want[lo:hi],
              "sharded diff_nodes_device differs")
    whole = eng.diff_replicas_device(padded, v0, v1, 3)
    for got, want in zip(sweep.diff_replicas_device(ids, v0, v1, 3), whole):
        _same(got, want[lo:hi] & valid[:, None] if got.dtype == torch.bool else want[lo:hi],
              "sharded diff_replicas_device differs")
    planner = MigrationPlanner(eng)
    plan = planner.plan(ids, v0, v1)
    n_moved, mat = sweep.movement_matrix(ids, v0, v1, n_nodes + 1)
    rec["n_moved"], rec["mat"] = np.int64(n_moved), mat
    _expect(n_moved == plan.n_moves, "sharded moved count differs")
    ref_mat = np.zeros((n_nodes + 1, n_nodes + 1), dtype=np.int64)
    np.add.at(ref_mat, (plan.src, plan.dst), 1)
    _same(mat, ref_mat, "sharded movement matrix differs")
    fields = ("ids", "src", "dst", "index", "slot", "src_slot")
    for mesh_arg in (mesh, sweep):
        splan = planner.plan(ids, v0, v1, mesh=mesh_arg)
        for f in fields:
            _same(getattr(splan, f), getattr(plan, f), f"sharded plan field {f} differs")
            rec[f"plan_{f}"] = getattr(splan, f)
    for R in (1, 3):
        rplan = planner.plan_replicas(ids, v0, v1, R)
        srplan = planner.plan_replicas(ids, v0, v1, R, mesh=mesh)
        for f in fields:
            _same(getattr(srplan, f), getattr(rplan, f),
                  f"R={R}: sharded replica plan field {f} differs")
            rec[f"rplan{R}_{f}"] = getattr(srplan, f)
        rn, rmat = sweep.movement_matrix(ids, v0, v1, n_nodes + 1, n_replicas=R)
        rec[f"rmat_{R}"] = rmat
        _expect(rn == rplan.n_moves, f"R={R}: sharded replica moved count differs")
    # ragged streamed chunks: the ranks' moved rows add up to the plan's
    for R, want in ((None, plan.n_moves), (3, planner.plan_replicas(ids, v0, v1, 3).n_moves)):
        chunks = planner.chunked(ids, 777)
        stream = (planner.plan_stream(chunks, v0, v1, mesh=sweep) if R is None
                  else planner.plan_replicas_stream(chunks, v0, v1, R, mesh=sweep))
        total = torch.zeros(1, dtype=torch.int64, device=dev)
        for part in stream:
            total += part[1].sum()
        _expect(int(sweep.all_reduce(total)) == want, f"R={R}: streamed moves differ")

    # mesh-sharded serving == single-card serving, bit for bit: chosen
    # nodes, load counters and queue state, every batch, all four
    # algorithms, R in {1, 3}
    serve_cluster = make_uniform_cluster(16)
    batch = 256 * world if batch is None else int(batch)
    kw = dict(batch=batch, n_keys=4096, law="zipf", policy="pow2", seed=7)
    for alg in ("asura", "ch", "wrh", "rs"):
        eng_s = engine(serve_cluster, algorithm=alg)
        for R in (1, 3):
            solo = RequestStreamDriver(eng_s, n_replicas=R, **kw)
            shard = ShardedSweep(eng_s, mesh).serve_stream(n_replicas=R, **kw)
            for step in range(3):
                got = rec[f"chosen_{alg}_{R}_{step}"] = shard.step().cpu().numpy()
                _same(got, solo.step(), f"{alg} R={R} step {step}: sharded chosen nodes differ")
                _same(shard.counts, solo.counts, f"{alg} R={R} step {step}: load counters differ")
                _same(shard.queue, solo.queue, f"{alg} R={R} step {step}: queue state differs")

    # a batch that does not divide the mesh is refused
    rec["refused_batch"] = np.int64(0)
    if world > 1:
        try:
            RequestStreamDriver(eng_s, mesh=mesh, **dict(kw, batch=batch + 1))
        except ValueError:
            rec["refused_batch"] = np.int64(1)
        _expect(rec["refused_batch"], f"batch {batch + 1} was not refused on {world} ranks")

    # the instrumented stream's all-reduced metrics slab == the single-card
    # slab, bit for bit
    eng_m = engine(serve_cluster)
    for R in (1, 3):
        reg_solo, reg_shard = (MetricsRegistry(device=dev) for _ in range(2))
        solo = RequestStreamDriver(eng_m, metrics=reg_solo, n_replicas=R, **kw)
        shard = RequestStreamDriver(eng_m, mesh=mesh, metrics=reg_shard, n_replicas=R, **kw)
        for _ in range(3):
            solo.step()
            shard.step()
        snap_a, snap_b = reg_solo.snapshot(), reg_shard.snapshot()
        _expect(set(snap_a) == set(snap_b), "metric name sets differ")
        for name in snap_a:
            _same(snap_b[name], snap_a[name], f"R={R}: sharded metric {name!r} differs")

    # two-level (domain, node) placement: B8 through the engine equals the
    # HierarchicalCluster oracle, and the mesh stream on a hierarchical
    # engine equals the single-card stream
    hcluster = HierarchicalCluster()
    for d in range(4):
        for i in range(4):
            hcluster.add_node(d, 100 + d * 4 + i, 1.0 + 0.25 * i)
    heng = engine(hcluster)
    hids = ids[: min(n_ids, 20_011)]
    for R in (1, 3):
        want = hcluster.place_replicas(hids, R)
        _same(heng.place_replica_pairs(hids, R), want, f"R={R}: two-level kernel differs")
    _same(heng.place_nodes(hids), want[:, 0, 1], "two-level place_nodes differs")
    for R in (1, 3):
        solo = RequestStreamDriver(heng, n_replicas=R, **kw)
        shard = RequestStreamDriver(heng, mesh=mesh, n_replicas=R, **kw)
        for step in range(3):
            got = rec[f"hier_chosen_{R}_{step}"] = shard.step().cpu().numpy()
            _same(got, solo.step(), f"hier R={R} step {step}: sharded chosen nodes differ")
            _same(shard.counts, solo.counts, f"hier R={R} step {step}: load counters differ")

    # a mesh superstep(k) equals k single-card step() calls -- chosen,
    # counters, queue; first the selftest's stream, then the 10-node,
    # batch-256 stream of the reference's superstep test
    for name, n, b, seed in (("super", 16, batch, 7), ("super10", 10, 256, 3)):
        if b % world:
            continue
        eng_k = engine(make_uniform_cluster(n))
        cfg = dict(batch=b, n_keys=4096 if n == 16 else 1 << 12, law="zipf",
                   n_replicas=3, policy="pow2", seed=seed)
        solo = RequestStreamDriver(eng_k, **cfg)
        shard = RequestStreamDriver(eng_k, mesh=mesh, **cfg)
        for block in range(2):
            want = torch.stack([solo.step() for _ in range(3)])
            got = rec[f"{name}_chosen_{block}"] = shard.superstep(3).cpu().numpy()
            _same(got, want, f"{name} block {block}: sharded superstep chosen nodes differ")
            _same(shard.counts, solo.counts, f"{name} block {block}: load counters differ")
            _same(shard.queue, solo.queue, f"{name} block {block}: queue state differs")
        rec[f"{name}_counts"] = shard.load_counts()
    rec["host_staged"] = np.int64(sum(e.ledger.counter("mesh.host_staged") for e in engines))
    return world


def _selftest_rank(rank: int, world: int, init_file: str, device_type: str,
                   n_ids: int, batch, out) -> None:
    """One spawned rank: join the group, run ``selftest``, leave."""
    import datetime

    torch.set_num_threads(1)
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda", rank % cards)
        torch.cuda.set_device(device)
        backend = "nccl" if world <= cards else "gloo"  # NCCL refuses shared cards
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        rec: dict = {}
        selftest(world, n_ids, device=device, batch=batch, record=rec)
        if rank == 0:
            print(f"rank 0 of {world}: backend {backend} on {device}, "
                  f"mesh.host_staged {int(rec['host_staged'])}", flush=True)
            if out:
                np.savez(out, **rec)
    finally:
        dist.destroy_process_group()


def spawn_selftest(n_ranks: int, *, device=None, n_ids: int = 100_003,
                   batch: int | None = None, out: str | None = None) -> int:
    """Run ``selftest`` on ``n_ranks`` spawned processes joined by a
    ``file://`` store: gloo on the CPU; on the card NCCL at one rank per
    card, gloo when ranks share a card.  A failing rank fails the run (the
    others are stopped).  Rank 0 writes its results to ``out`` (.npz)."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    device_type = resolve_device(device).type
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _selftest_rank,
            args=(n_ranks, os.path.join(tmp, "store"), device_type, n_ids, batch, out),
            nprocs=n_ranks, start_method="spawn",
        )
    return n_ranks


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--devices", type=int, default=1, help="ranks to spawn")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the ranks place (default: the card)")
    ap.add_argument("--ids", type=int, default=100_003)
    ap.add_argument("--batch", type=int, default=None,
                    help="serving batch (default: 256 per rank)")
    ap.add_argument("--out", default=None, help="rank 0's results (.npz)")
    args = ap.parse_args(argv)
    if not args.selftest:
        print("nothing to do (pass --selftest)")
        return 0
    n = spawn_selftest(args.devices, device=args.device, n_ids=args.ids,
                       batch=args.batch, out=args.out)
    print(f"sharded placement selftest OK on {n} ranks")
    return 0


if __name__ == "__main__":
    # run from the package's module, not ``__main__``: the spawned ranks
    # then share the classes the rest of the package imports
    from repro_torch.launch.placement_mesh import main as _main

    raise SystemExit(_main())
