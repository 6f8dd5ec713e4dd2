"""Batched device-resident serving pipeline (DESIGN.md section 12).

The port of the reference's ``RequestStreamDriver`` on one card.  One
``step()`` serves one generated batch:

  1. generate: counter-based threefry words per GLOBAL lane and exact-u32
     CDF sampling (``serve.traffic``) -- no host RNG in the loop;
  2. route: the batch goes through the section-5.A replica kernel
     (``place_replicas_cuda`` with the fused node output, and with its
     stats vector when instrumented), or under a baseline algorithm
     through the fan-out kernel (``baseline_replicas_cuda``, with its
     ``[reprobes]`` stat), or on a hierarchical engine through the
     two-level kernel B8 (``hier_place_replicas_cuda``, its node plane:
     the R holders lie in R distinct failure domains; uninstrumented, as
     the reference has no stats plane there) -- where the reference
     routes through its jnp twins, the port routes through the kernels,
     and the result is the same bit for bit;
  3. select: ``primary``, ``random`` or ``pow2`` (power-of-two-choices
     against the start-of-batch per-node counters), and the batch's
     per-node histogram in the same pass: on the card one launch of the
     hand-written kernel SC (``select_count_cuda``, a block-private
     histogram in shared memory), on the CPU its twin ``select_count_twin``
     (``select_replica``, then a scatter-add into the driver's zeroed
     histogram; ``bincount`` would read its max on the host);
  4. count: the counts, the queue recurrence ``q' = max(q + arrivals -
     service, 0)`` and the queue-history ring from that histogram, which
     is handed back zeroed (``count_update_cuda`` on the card, one launch;
     ``count_update_twin`` on the CPU).  ``counts`` and ``queue`` are new
     tensors every batch: a caller may keep an earlier batch's.

Nothing in ``step()`` reads a device value on the host: the stream
position is a host int (the batch key is folded in on the host), and the
state stays on the device.  ``superstep(k)`` is k calls of the same
one-batch body, so it equals k ``step()`` calls by construction.

``serve_migrating`` serves a batch THROUGH a live migration window: the
same body, routed by the window's per-slot read rule
(``LiveMigration.route_replicas_device``: v+1 sets from the replica
kernel, pending slots from their v-side sources), so every request lands
on a node that holds its datum mid-drain.  ``superstep_migrating(k)`` is
k of those batches against the same pending view.  Windows are ASURA's
(they ride on its dual-version tables), as in the reference.

``mesh=`` (a ``DeviceMesh`` or a ``launch.placement_mesh.ShardedSweep``)
shards the stream over the ranks of a ``torch.distributed`` group
(DESIGN.md section 12): every rank builds the same driver, rank r draws
lanes ``r * local + arange(local)`` (the same words as the single-card
stream), routes them through its own kernel and selects against the
start-of-batch counters, which are equal on every rank; the per-node
histogram -- and, when instrumented, the metrics slab's delta -- merge
with ONE all-reduce per batch, and ``step()`` gathers the whole chosen
vector.  The sharded stream equals the single-card stream bit for bit.
Host-fed batches (``route_batch``) and migration windows stay single-card,
as in the reference.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch

from ..kernels.asura_place import place_replicas_cuda
from ..kernels.baselines import baseline_replicas_cuda
from ..kernels.hierarchy import hier_place_replicas_cuda
from ..kernels.ref import DEPTH_BINS
from ..kernels.serve import count_update_cuda, select_count_cuda
from ..kernels.u32 import M32, to_u32
from ..obs.trace import TraceLedger, maybe_span
from .traffic import TrafficModel, prng_key

POLICIES = ("primary", "random", "pow2")

DEFAULT_BATCH = 1 << 16
DEFAULT_KEYS = 1 << 20
DEFAULT_HIST = 256  # queue-history ring rows (p99 window)

_BIG = 2**31 - 1  # an invalid candidate's load: always loses


def route_statics(engine, algorithm: str | None = None):
    """(tables, statics) for the replica-routing body under ``algorithm``:
    ``tables`` are the device operands, ``statics`` the hashable key that
    fully determines the body."""
    alg = engine._resolve_algorithm(algorithm)
    if engine.hierarchical:
        art, p = engine.hier_artifact(), engine.params
        statics = ("hier", art.top_level, art.max_top, art.s_pad, p.s_log2, p.max_draws)
        return art.tables_dev, statics
    art = engine._device_artifact(alg)
    if alg == "asura":
        tables = (art.len32_dev, art.node_of_dev)
        statics = ("asura", art.top_level, engine.params.s_log2, engine.params.max_draws)
    else:
        tables = (art.keys_dev, art.vals_dev)
        statics = (alg,)
    return tables, statics


def replica_owners_body(statics: tuple, n_replicas: int, emit_stats: bool = False):
    """``(ids, *tables) -> (batch, R) int32`` replica nodes, and with
    ``emit_stats`` the algorithm's uint32 stats vector (ASURA:
    ``[depth_hist..., nonconverged]``; baselines: ``[reprobes]``).
    ``hier`` statics route the two-level kernel and give its NODE plane;
    they have no stats plane (``emit_stats`` raises, as in the reference).
    ``ids`` are u32 values in int64 or a uint32 tensor."""
    alg = statics[0]
    if alg == "hier":
        if emit_stats:
            raise NotImplementedError(
                "hierarchical serving has no stats plane yet; route with "
                "emit_stats=False"
            )
        _, top_level, max_top, s_pad, s_log2, max_draws = statics

        def kernel(ids, *tables):
            return hier_place_replicas_cuda(
                ids, *tables, top_level=top_level, max_top=max_top, s_pad=s_pad,
                s_log2=s_log2, max_draws=max_draws, n_replicas=n_replicas,
            )[1].T  # (batch, R) node plane
    elif alg != "asura":
        kernel = partial(baseline_replicas_cuda, alg, n_replicas=n_replicas,
                         emit_stats=emit_stats)
    else:
        _, top_level, s_log2, max_draws = statics
        kernel = partial(
            place_replicas_cuda, top_level=top_level, s_log2=s_log2,
            max_draws=max_draws, n_replicas=n_replicas, emit_nodes=True,
            emit_stats=emit_stats,
        )

    def owners(ids, *tables):
        if ids.dtype != torch.uint32:
            ids = to_u32(ids)
        return kernel(ids, *tables)

    return owners


def top_node(art) -> int:
    """The largest node id a table artifact can route to."""
    if hasattr(art, "node_domain"):  # a hierarchical artifact
        return max(art.node_domain)
    if getattr(art, "algorithm", "asura") == "asura":
        return int(art.node_of.max())
    return int((art.keys if art.algorithm == "wrh" else art.vals).max())


def select_replica(owners, sel, counts, *, policy: str, n_replicas: int):
    """Pick one holder per request -> (batch,) int32 chosen nodes.

    ``owners`` is (batch, R) int32 with -1 for unfilled slots (an invalid
    candidate always loses; a fully-invalid row falls back to the clamped
    primary).  ``pow2`` draws two DISTINCT slots from the selection word
    and takes the one with the smaller start-of-batch counter (strict <,
    first-slot tie-break); ``random`` one slot uniformly; ``primary`` (or
    R == 1) slot 0."""
    prim = owners[:, 0].clamp(min=0)
    if policy == "primary" or n_replicas == 1:
        return prim
    R = n_replicas
    if policy == "random":
        slot = (sel % R).unsqueeze(1)
        chosen = torch.gather(owners, 1, slot)[:, 0]
        return torch.where(chosen >= 0, chosen, prim)
    if policy != "pow2":
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    i = sel % R
    j = (i + 1 + (sel >> 16) % (R - 1)) % R
    a = torch.gather(owners, 1, i.unsqueeze(1))[:, 0]
    b = torch.gather(owners, 1, j.unsqueeze(1))[:, 0]
    la = torch.where(a >= 0, counts[a.clamp(min=0).long()], _BIG)
    lb = torch.where(b >= 0, counts[b.clamp(min=0).long()], _BIG)
    chosen = torch.where(lb < la, b, a)
    return torch.where(chosen >= 0, chosen, prim)


def select_count_twin(owners, sel, counts, hist, *, policy: str, n_replicas: int,
                      n_valid: int) -> torch.Tensor:
    """The plain-torch twin of ``select_count_cuda``: ``select_replica``,
    then 1 added to ``hist[chosen]`` for each lane below ``n_valid`` (the
    pad lanes of a host-fed batch weigh 0) -> the chosen nodes."""
    chosen = select_replica(owners, sel, counts, policy=policy, n_replicas=n_replicas)
    lanes = torch.arange(chosen.shape[0], device=chosen.device)
    hist.scatter_add_(0, chosen.long(), (lanes < n_valid).to(torch.int32))
    return chosen


def count_update_twin(hist, counts, queue, service, qrow):
    """The plain-torch twin of ``count_update_cuda`` -> (counts + hist,
    max(queue + hist - service, 0)), new tensors; the queue also goes into
    ``qrow`` and ``hist`` is zeroed, in place."""
    queue = torch.clamp(queue + hist - service, min=0)
    counts = counts + hist
    qrow.copy_(queue)
    hist.zero_()
    return counts, queue


def select_count(owners, sel, counts, hist, *, policy: str, n_replicas: int, n_valid: int):
    """SC for CUDA tensors (one launch), its twin for CPU ones."""
    kw = dict(policy=policy, n_replicas=n_replicas, n_valid=n_valid)
    if owners.device.type == "cuda":
        return select_count_cuda(owners, sel, counts, hist, **kw)
    if owners.device.type != "cpu":
        raise ValueError(f"select_count runs on cuda or cpu, not {owners.device}")
    return select_count_twin(owners, sel, counts, hist, **kw)


def count_update(hist, counts, queue, service, qrow):
    """The bin update for CUDA tensors (one launch), its twin for CPU ones."""
    if hist.device.type == "cuda":
        return count_update_cuda(hist, counts, queue, service, qrow)
    if hist.device.type != "cpu":
        raise ValueError(f"count_update runs on cuda or cpu, not {hist.device}")
    return count_update_twin(hist, counts, queue, service, qrow)


class RequestStreamDriver:
    """Stateful batched serving simulator bound to one ``PlacementEngine``.

    Device state (tensors on the engine's device, int32; the host reads
    them only through the metric accessors):

      * ``counts`` -- (n_bins,) cumulative served requests per node,
      * ``queue``  -- (n_bins,) current queue depth per node
        (``service_rate`` requests drain per node per step),
      * ``qhist``  -- (max_hist, n_bins) queue-depth ring (p99), updated
        in place; ``counts`` and ``queue`` are new tensors every batch.

    ``step_traces`` counts bindings of the one-batch body to a routing
    configuration (a new table version binds anew) -- the tripwire that
    repeated steps reuse one binding.
    """

    def __init__(
        self,
        engine,
        *,
        batch: int = DEFAULT_BATCH,
        n_keys: int = DEFAULT_KEYS,
        law: str = "zipf",
        alpha: float = 1.1,
        hot_fraction: float = 0.9,
        hot_keys: int = 64,
        n_replicas: int = 3,
        policy: str = "pow2",
        seed: int = 0,
        service_rate: int | None = None,
        max_hist: int = DEFAULT_HIST,
        n_bins: int | None = None,
        mesh=None,
        algorithm: str | None = None,
        metrics=None,
    ):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        self.engine = engine
        self.algorithm = engine._resolve_algorithm(algorithm)
        self.device = engine.device
        self.batch = int(batch)
        self._sweep = None
        if mesh is not None:
            from ..launch.placement_mesh import ShardedSweep

            self._sweep = mesh if isinstance(mesh, ShardedSweep) else ShardedSweep(engine, mesh)
            if self.batch % self._sweep.n_devices:
                raise ValueError(
                    f"batch ({self.batch}) must divide the mesh "
                    f"({self._sweep.n_devices} devices)"
                )
        self.n_replicas = int(n_replicas)
        self.policy = policy
        self.max_hist = int(max_hist)
        self.traffic = TrafficModel(
            n_keys, law=law, alpha=alpha,
            hot_fraction=hot_fraction, hot_keys=hot_keys, seed=seed,
        )
        nodes = getattr(engine.cluster, "nodes", None)
        if nodes is None and engine.hierarchical:
            # two-level cluster: the artifact's node -> domain map is the
            # flat node-id space the load and queue planes index
            nodes = engine.hier_artifact().node_domain
        if n_bins is not None:
            self.n_bins = int(n_bins)
        elif nodes:
            self.n_bins = int(max(nodes)) + 1
        else:  # table-only cluster: size off the seg->node map
            self.n_bins = int(np.max(engine.artifact().node_of)) + 1
        n_active = len(nodes) if nodes else self.n_bins
        if service_rate is None:
            # 25% capacity headroom over the mean arrival rate
            service_rate = max(1, math.ceil(1.25 * self.batch / max(1, n_active)))
        self.service_rate = int(service_rate)
        self._key = prng_key(seed)
        dev = self.device
        self._service = torch.full((self.n_bins,), self.service_rate,
                                   dtype=torch.int32, device=dev)
        # this rank's GLOBAL lanes (all of them on one card)
        lo, hi = (0, self.batch) if self._sweep is None else self._sweep.bounds(self.batch)
        self._lanes = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        self._thresholds = self.traffic.thresholds_on(dev)
        self.ledger = TraceLedger()  # instance-scoped tripwire counts
        self.metrics = metrics
        self._instrumented = metrics is not None and metrics.enabled
        if self._instrumented:
            self._register_metrics()
            metrics.slab()
        self._bodies: dict = {}
        self._checked_version = None
        self._checked_window = None
        self._route()  # upload and check the tables now, not in a step
        self.reset()

    def _register_metrics(self) -> None:
        """Claim this driver's slab windows (append-only; idempotent)."""
        reg = self.metrics
        self._routed_name = reg.counter(
            f"serve.routed.{self.algorithm}.{self.policy}"
        )
        reg.histogram("serve.served", self.n_bins)
        if self.algorithm == "asura":
            reg.histogram("asura.ladder_depth", DEPTH_BINS)
            reg.counter("asura.nonconverged")
        else:
            reg.counter("baseline.reprobes")

    @property
    def step_traces(self) -> int:
        """One-batch body bindings (the rebinding tripwire) -- a ledger
        counter behind the reference's attribute name."""
        return self.ledger.counter("serve.step_traces")

    @property
    def superstep_traces(self) -> int:
        """``superstep`` bindings, one per distinct (routing configuration,
        k) -- the reference's per-(statics, k) trace count."""
        return self.ledger.counter("serve.superstep_traces")

    # -- state ----------------------------------------------------------------

    def reset(self) -> None:
        """Zero the load/queue state and rewind the request stream."""
        dev = self.device
        self.counts = torch.zeros(self.n_bins, dtype=torch.int32, device=dev)
        self.queue = torch.zeros(self.n_bins, dtype=torch.int32, device=dev)
        self.qhist = torch.zeros((self.max_hist, self.n_bins), dtype=torch.int32,
                                 device=dev)
        # the batch's histogram: SC adds into it, the bin update zeroes it
        self._hist = torch.zeros(self.n_bins, dtype=torch.int32, device=dev)
        self._step = 0
        self.steps_done = 0

    # -- the batch body -------------------------------------------------------

    def _kernel_route(self, owners_fn, tables):
        """``ids -> (owners, stats or None)`` through the replica kernel."""
        if self._instrumented:
            return lambda ids: owners_fn(ids, *tables)
        return lambda ids: (owners_fn(ids, *tables), None)

    def _serve_batch(self, route):
        """generate -> route -> select -> count for stream position
        ``self._step``; returns the batch's ids (u32 values in int64) and
        the chosen nodes.  ``route(ids)`` gives the (batch, R) holders and
        the kernel's stats vector (None when it has none)."""
        with maybe_span(None, "serve.words"):
            ids, sel = TrafficModel.draw(
                self._key, self._step, self._lanes, self._thresholds,
                self.traffic.id_salt,
            )
        owners, stats = route(ids)
        return ids, self._select_count(owners, sel, self._lanes.shape[0], stats)

    def _select_count(self, owners, sel, n_valid: int, stats):
        """select -> count for stream position ``self._step``, then advance
        it -> the chosen nodes: this rank's lanes on a mesh, whose histogram
        (and slab delta) one all-reduce merges.  Lanes at or past
        ``n_valid`` are a host-fed batch's pad and weigh 0.  ``stats`` is
        the kernel's stats vector, or None.  The histogram is seen before
        the bin update where it has to be: added to the slab when
        instrumented, all-reduced on a mesh."""
        hist = self._hist
        with maybe_span(None, "serve.select"):
            chosen = select_count(owners, sel, self.counts, hist, policy=self.policy,
                                  n_replicas=self.n_replicas, n_valid=n_valid)
        with maybe_span(None, "serve.count"):
            delta = None
            if self._instrumented:
                reg = self.metrics
                slab = reg.slab()
                # on a mesh the adds go to a delta that rides the batch's one
                # all-reduce beside the histogram
                delta = slab if self._sweep is None else torch.zeros_like(slab)
                reg.add(delta, self._routed_name, n_valid)
                reg.add_hist(delta, "serve.served", hist)
                if stats is not None and self.algorithm == "asura":
                    reg.add_hist(delta, "asura.ladder_depth", stats[:DEPTH_BINS])
                    reg.add(delta, "asura.nonconverged", stats[DEPTH_BINS])
                elif stats is not None:
                    reg.add(delta, "baseline.reprobes", stats[0])
            if self._sweep is not None and delta is not None:
                merged = self._sweep.all_reduce(torch.cat([hist.to(torch.int64), delta]))
                hist.copy_(merged[: self.n_bins])
                slab.add_(merged[self.n_bins :]).bitwise_and_(M32)
            elif self._sweep is not None:
                self._sweep.all_reduce(hist)
            self.counts, self.queue = count_update(
                hist, self.counts, self.queue, self._service,
                self.qhist[self._step % self.max_hist],
            )
        self._step += 1
        self.steps_done += 1
        return chosen

    def _route(self, bucket: int | None = None):
        """(owners function, tables) for the cluster's current version, whose
        load bins are checked on the host once.  One binding per (routing
        configuration, ``emit_stats``, pow2 bucket) counts in
        ``step_traces``: a generated batch (``bucket=None``) routes with the
        kernel's stats vector when instrumented, a host-fed bucket without
        it (pad lanes would count phantom work)."""
        tables, statics = route_statics(self.engine, self.algorithm)
        if self.engine.cluster.version != self._checked_version:
            art = (self.engine.hier_artifact() if self.engine.hierarchical
                   else self.engine.artifact(self.algorithm))
            self._check_bins(art)
            self._checked_version = art.version
        emit_stats = self._instrumented and bucket is None
        key = (statics, emit_stats, bucket)
        if key not in self._bodies:
            self.ledger.incr("serve.step_traces")
            self._bodies[key] = replica_owners_body(statics, self.n_replicas, emit_stats=emit_stats)
        return self._bodies[key], tables

    def _check_bins(self, art) -> None:
        """A node id of ``art`` outside the ``n_bins`` load planes raises
        here (the reference drops its counts silently; on the card an
        out-of-range scatter would be a device-side fault)."""
        top = top_node(art)
        if top >= self.n_bins:
            raise ValueError(
                f"node id {top} of version {art.version} is outside this "
                f"driver's {self.n_bins} load bins; build the driver with a "
                "larger n_bins"
            )

    def _whole(self, chosen: torch.Tensor) -> torch.Tensor:
        """The whole batch's chosen nodes: on a mesh, every rank's lanes
        gathered along the last axis."""
        return chosen if self._sweep is None else self._sweep.gather(chosen, dim=-1)

    def step(self) -> torch.Tensor:
        """Serve one generated batch -> (batch,) int32 chosen nodes on the
        device.  No host sync: the state and the result stay on the device."""
        return self._whole(self._serve_batch(self._kernel_route(*self._route()))[1])

    def superstep(self, k: int) -> torch.Tensor:
        """Serve K generated batches -> (k, batch) int32 chosen nodes; equal
        to K ``step()`` calls (the same body, K times)."""
        k = int(k)
        if k < 1:
            raise ValueError(f"superstep needs k >= 1, got {k}")
        body, tables = self._route()
        key = ("superstep", body, k)
        if key not in self._bodies:
            self._bodies[key] = body
            self.ledger.incr("serve.superstep_traces")
        route = self._kernel_route(body, tables)
        return self._whole(torch.stack([self._serve_batch(route)[1] for _ in range(k)]))

    def route_batch(self, datum_ids) -> torch.Tensor:
        """Serve one EXTERNAL id batch through the select + count pass ->
        (len(ids),) int32 chosen nodes on the device.

        Ids are pow2-bucketed (``migrate.planner.pad_pow2``) and pad lanes
        never touch a counter.  The selection words come from the stream
        position, as a generated batch's do.  The batch routes without the
        kernel's stats vector, so only the routed and served metrics
        accumulate.  One binding per (routing configuration, bucket) counts
        in ``step_traces``, as the reference traces once per padded shape."""
        from ..kernels.ops import as_ids
        from ..migrate.planner import pad_pow2

        if self._sweep is not None:
            raise ValueError(
                "route_batch serves host-fed batches single-device; "
                "mesh-sharded serving goes through step()"
            )
        with maybe_span(None, "serve.route_batch"):
            ids = as_ids(datum_ids, self.device)
            n = int(ids.shape[0])
            padded, n_valid = pad_pow2(ids)
            owners_fn, tables = self._route(int(padded.shape[0]))
            lanes = torch.arange(padded.shape[0], dtype=torch.int64, device=self.device)
            with maybe_span(None, "serve.words"):
                sel = TrafficModel.lane_words(self._key, self._step, lanes, 1)[:, 0]
            owners = owners_fn(padded, *tables)
            return self._select_count(owners, sel, n_valid, None)[:n]

    # -- serving through a live migration window --------------------------------

    def _window_route(self, migration):
        """``ids -> (owners, None)`` through the window's replica read rule,
        after checking (on the host, once per window) that R matches and
        that every node of both versions has a load bin."""
        if self._sweep is not None:
            raise ValueError(
                "migration windows are single-device (the pending views "
                "refresh per round); build the driver without mesh="
            )
        if migration.n_replicas != self.n_replicas:
            raise ValueError(
                f"driver serves R={self.n_replicas} but the migration plan "
                f"is R={migration.n_replicas}"
            )
        migration._check_live()
        key = (migration.v_from, migration.v_to)
        if self._checked_window != key:
            for v in key:
                self._check_bins(self.engine.artifact_for(v, "asura"))
            self._checked_window = key
        return lambda ids: (migration.route_replicas_device(ids), None)

    def serve_migrating(self, migration):
        """Serve one generated batch THROUGH a live migration window ->
        ``(datum_ids, chosen)`` device tensors (uint32 ids, int32 nodes).

        Routing goes through the window's per-slot read rule, so every
        request lands on a node that holds its datum mid-drain.  No host
        sync after the per-round pending-view refresh."""
        ids, chosen = self._serve_batch(self._window_route(migration))
        return to_u32(ids), chosen

    def superstep_migrating(self, migration, k: int):
        """Serve K generated batches THROUGH a live migration window ->
        ``(datum_ids, chosen)``, each (k, batch): K ``serve_migrating``
        batches against the pending view at call time, so it equals K
        sequential calls."""
        k = int(k)
        if k < 1:
            raise ValueError(f"superstep needs k >= 1, got {k}")
        route = self._window_route(migration)
        ids, chosen = zip(*(self._serve_batch(route) for _ in range(k)))
        return to_u32(torch.stack(ids)), torch.stack(chosen)

    # -- host-facing metrics (each accessor is ONE deliberate sync) -----------

    def _active_bins(self) -> np.ndarray:
        nodes = getattr(self.engine.cluster, "nodes", None)
        if nodes:
            return np.asarray(sorted(int(n) for n in nodes), dtype=np.int64)
        return np.arange(self.n_bins, dtype=np.int64)

    def load_counts(self) -> np.ndarray:
        return self.counts.cpu().numpy()

    def load_skew(self) -> float:
        """max/mean served load over the live nodes (1.0 = perfectly even)."""
        c = self.load_counts()[self._active_bins()].astype(np.float64)
        mean = c.mean()
        return float(c.max() / mean) if mean > 0 else 0.0

    def queue_p99(self) -> float:
        """p99 queue depth over (recorded step, live node) samples."""
        rows = min(self.steps_done, self.max_hist)
        if rows == 0:
            return 0.0
        q = self.qhist.cpu().numpy()[:rows][:, self._active_bins()]
        return float(np.percentile(q, 99))

    def snapshot(self) -> dict:
        snap = {
            "counts": self.load_counts(),
            "queue": self.queue.cpu().numpy(),
            "steps": self.steps_done,
            "skew": self.load_skew(),
            "q_p99": self.queue_p99(),
        }
        self.ledger.event(
            "serve.snapshot", self.algorithm,
            steps=self.steps_done, skew=snap["skew"], q_p99=snap["q_p99"],
        )
        return snap
