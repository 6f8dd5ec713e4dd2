"""Migration layer 1: the streaming version-diff planner.

A membership change turns cluster version v into v+1.  The planner answers
"which data must move, from where, to where" by placing every tracked id
under BOTH table versions (both artifacts coexist in the engine's LRU) and
diffing the owners:

  * ``diff_device``   -- one chunk: ``(moved, src, dst)`` tensors on the
                         engine's device, one launch of the two-version
                         diff kernel, no host sync;
  * ``plan_stream``   -- the streaming sweep: id chunks through
                         ``diff_device`` in fixed device memory; yields
                         device tuples and never reads one on the host.
                         ``fuse=n`` diffs n equal-length chunks in ONE
                         launch over their concatenation (each id's diff
                         is independent, so the yielded tuples are the
                         same);
  * ``plan``          -- host-facing assembly into a ``MigrationPlan`` (the
                         moved rows only).  For an add-node event,
                         ``max_new_seg`` turns on the ADDITION-NUMBER
                         prefilter (section 2.D): a metadata sweep marks
                         the candidates and only they pay the full diff.

The unit of work generalizes from a node to an R-way REPLICA SET:
``diff_replicas_device`` / ``plan_replicas_stream`` / ``plan_replicas``
are the per-slot twins -- each id's replica set is placed under both
versions in one launch and aligned slot by slot, so only replicas whose
owner actually changed produce a row (the paper's section-5 minimal
replica movement, even under replication).

On a hierarchical engine (``HierarchicalCluster``) the replica diffs run
the two-level kernel under both versions (``engine.diff_replicas_device``
aligns the node planes), streams diff chunk by chunk (``fuse`` is
ignored, as in the reference), and the ADDITION-NUMBER prefilter -- flat
table semantics -- raises.

``mesh=`` (a ``DeviceMesh`` or a ``launch.placement_mesh.ShardedSweep``)
runs each chunk's diff over the ranks of a ``torch.distributed`` group
(DESIGN.md section 11): every rank calls with the same ids, each diffs its
shard of the chunk, and the assembled plan -- gathered onto every rank --
equals the single-card plan.  Mesh streams yield each rank's shard, diff
chunk by chunk (``fuse`` is ignored) and a hierarchical engine refuses
them, as in the reference.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.asura import addition_numbers_batch, align_replica_sets
from ..obs.trace import maybe_span

DEFAULT_CHUNK = 1 << 20  # ids per streaming chunk (fixed device memory)


def pow2_bucket(n: int, multiple: int = 1) -> int:
    """The length ``pad_pow2`` pads ``n`` ids to: the pow2 bucket of ``n``,
    rounded up to a multiple of ``multiple``."""
    target = 1 << max(0, n - 1).bit_length()
    return target + (-target) % max(1, multiple)


def pad_pow2(chunk, multiple: int = 1):
    """(padded, n_valid): zero-pad a chunk into its pow2 bucket (and up to
    ``multiple``).  Full pow2 chunks pass through untouched (``padded is
    chunk``); tensors pad where they lie, with no host round trip."""
    n = int(chunk.shape[0])
    target = pow2_bucket(n, multiple)
    if target == n:
        return chunk, n
    if isinstance(chunk, np.ndarray):
        return np.pad(chunk, (0, target - n)), n
    pad = torch.zeros(target - n, dtype=chunk.dtype, device=chunk.device)
    return torch.cat([chunk, pad]), n


def _mask_tail(moved: torch.Tensor, n_valid: int, first: int = 0) -> torch.Tensor:
    """``moved`` (rows ``first``, ``first + 1``, ... of a padded chunk)
    with the rows from ``n_valid`` on forced False, where it lies."""
    idx = torch.arange(first, first + moved.shape[0], device=moved.device)
    idx = idx.reshape((-1,) + (1,) * (moved.dim() - 1))
    return moved & (idx < n_valid)


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """The moved rows of a two-version placement diff.

    The unit of work is a REPLICA SLOT: row i says replica slot ``slot[i]``
    of datum ``ids[i]`` must move from node ``src[i]`` (where its bytes live
    under v) to node ``dst[i]`` (its v+1 owner); ``index[i]`` is the row's
    position in the scanned id array.  Single-owner plans are the R=1 case
    (``slot`` / ``src_slot`` all zero).  For replica plans ``slot`` indexes
    the id's v+1 replica set and ``src_slot`` the position of ``src`` in its
    v set -- rollback swaps the two.  Rows keep scan order (id major, slot
    minor)."""

    v_from: int
    v_to: int
    ids: np.ndarray  # uint32, moved ids (one row per moved (id, slot))
    src: np.ndarray  # int64, vacated owner under v_from
    dst: np.ndarray  # int64, owner under v_to
    index: np.ndarray  # int64, positions in the scanned id array
    n_scanned: int
    n_replicas: int = 1
    slot: np.ndarray | None = None  # int32, position in the v_to replica set
    src_slot: np.ndarray | None = None  # int32, position of src in the v set

    def __post_init__(self):
        if self.slot is None:
            object.__setattr__(self, "slot", np.zeros(len(self.ids), dtype=np.int32))
        if self.src_slot is None:
            object.__setattr__(
                self, "src_slot", np.zeros(len(self.ids), dtype=np.int32)
            )

    @property
    def n_moves(self) -> int:
        return int(self.ids.shape[0])

    @property
    def moved_fraction(self) -> float:
        """Moved fraction of the scanned REPLICA mass (R * n_scanned)."""
        return self.n_moves / max(1, self.n_scanned * self.n_replicas)

    def moves_dict(self) -> dict[int, tuple[int, int]]:
        """datum id -> (src, dst), built from the arrays in one pass.  For
        replica plans an id with several moved slots keeps its LAST row
        (add and remove events move at most one slot per id); slot-accurate
        consumers read the arrays."""
        return dict(zip(self.ids.tolist(), zip(self.src.tolist(), self.dst.tolist())))


class MigrationPlanner:
    """Version-diff planner bound to one ``PlacementEngine``.

    Both versions' artifacts must be cached (place at v before mutating)
    or ``engine.artifact_for`` raises."""

    def __init__(self, engine, *, ledger=None, metrics=None):
        self.engine = engine
        # observability (optional): a span event per assembled plan plus
        # the ADDITION-NUMBER prefilter's scanned / kept counters
        self.ledger = ledger
        self.metrics = metrics

    def _note_prefilter(self, n_scanned: int, n_kept: int) -> None:
        if self.ledger is not None:
            self.ledger.incr("planner.prefilter_scanned", n_scanned)
            self.ledger.incr("planner.prefilter_kept", n_kept)
        if self.metrics is not None:
            self.metrics.inc_host("planner.prefilter_scanned", n_scanned)
            self.metrics.inc_host("planner.prefilter_kept", n_kept)

    def _note_plan(self, kind: str, plan, t0: float) -> None:
        if self.ledger is not None:
            self.ledger.event(
                "span", kind, dur_s=float(time.perf_counter() - t0),
                n_scanned=plan.n_scanned, n_moves=plan.n_moves,
                v_from=plan.v_from, v_to=plan.v_to,
            )

    # -- device streaming sweep ---------------------------------------------

    def diff_device(self, datum_ids, v_from: int, v_to: int):
        """One chunk -> (moved, src, dst) device tensors, no host sync."""
        return self.engine.diff_nodes_device(datum_ids, v_from, v_to)

    def diff_replicas_device(self, datum_ids, v_from: int, v_to: int, n_replicas: int):
        """One chunk -> per-slot (moved, src, dst, src_slot) device tensors,
        each (chunk, R), no host sync."""
        return self.engine.diff_replicas_device(datum_ids, v_from, v_to, n_replicas)

    def _sweep(self, mesh):
        """``mesh=`` (a ``DeviceMesh``, a ``ShardedSweep`` or None) as a
        sweep bound to this planner's engine -- the multi-card diff path."""
        if mesh is None:
            return None
        from ..launch.placement_mesh import ShardedSweep

        if isinstance(mesh, ShardedSweep):
            return mesh
        return ShardedSweep(self.engine, mesh)

    def _diff(self, ids, v_from: int, v_to: int, n_replicas: int | None, sweep=None):
        """One (padded) chunk's diff: on one card, or this rank's shard of
        it over ``sweep``."""
        if sweep is not None and n_replicas:
            return sweep.diff_replicas_device(ids, v_from, v_to, n_replicas)
        if sweep is not None:
            return sweep.diff_nodes_device(ids, v_from, v_to)
        if n_replicas:
            return self.diff_replicas_device(ids, v_from, v_to, n_replicas)
        return self.diff_device(ids, v_from, v_to)

    def _mesh_stream(self, id_chunks, v_from: int, v_to: int, n_replicas, sweep):
        """The streaming driver over a mesh: chunk by chunk, each padded
        into its pow2 bucket (a multiple of the world size); yields this
        rank's shard ``(ids, *diff)`` with the pad lanes' ``moved`` False."""
        for chunk in id_chunks:
            padded, n_valid = pad_pow2(chunk, sweep.n_devices)
            lo, hi = sweep.bounds(padded.shape[0])
            outs = list(self._diff(padded, v_from, v_to, n_replicas, sweep))
            if padded is not chunk:
                outs[0] = _mask_tail(outs[0], n_valid, lo)
            yield (padded[lo:hi], *outs)

    def _host_diff(self, c: np.ndarray, v_from: int, v_to: int, n_replicas, sweep):
        """One host chunk's device diff, pow2-padded (a multiple of the
        world size on a mesh), copied back whole -> NumPy arrays of
        ``len(c)`` rows; a mesh gathers every rank's shard in one
        collective."""
        n_c = len(c)
        cp, _ = pad_pow2(c, 1 if sweep is None else sweep.n_devices)
        outs = self._diff(cp, v_from, v_to, n_replicas, sweep)
        if sweep is not None:
            outs = sweep.gather(*outs)
        return [o.cpu().numpy()[:n_c] for o in outs]

    def _stream(self, id_chunks, v_from: int, v_to: int, fuse: int, n_replicas):
        """The shared streaming driver: group consecutive equal-length
        (pow2-padded) chunks into blocks of up to ``fuse``, diff each block
        in ONE launch over the concatenated ids, and yield the per-chunk
        tuples (pad lanes' ``moved`` masked False)."""
        from ..kernels.ops import as_ids

        # hierarchical sweeps stay per chunk, as in the reference
        fuse = 1 if self.engine.hierarchical else max(1, int(fuse))
        device = self.engine.device

        def flush(buf):
            if not buf:
                return
            # the block's span closes before its first yield: a range left
            # open across a yield would take in the caller's work
            with maybe_span(None, "planner.block"):
                padded = [pad_pow2(chunk) for chunk in buf]
                if len(padded) == 1:
                    block = padded[0][0]
                else:
                    block = torch.cat([as_ids(p, device) for p, _ in padded])
                outs = self._diff(block, v_from, v_to, n_replicas)
                length = int(padded[0][0].shape[0])
                parts = []
                for i, ((p, n_valid), chunk) in enumerate(zip(padded, buf)):
                    part = [o[i * length : (i + 1) * length] for o in outs]
                    if p is not chunk:
                        part[0] = _mask_tail(part[0], n_valid)
                    parts.append((p, *part))
            yield from parts

        buf: list = []
        for chunk in id_chunks:
            length = pow2_bucket(int(chunk.shape[0]))
            if buf and (pow2_bucket(int(buf[0].shape[0])) != length or len(buf) >= fuse):
                yield from flush(buf)
                buf = []
            buf.append(chunk)
        yield from flush(buf)

    def plan_stream(self, id_chunks, v_from: int, v_to: int, *, mesh=None, fuse: int = 1):
        """Streaming sweep: yield ``(ids, moved, src, dst)`` per chunk.

        ``id_chunks`` is any iterable of id arrays (device tensors keep the
        whole sweep sync-free; NumPy chunks pay one upload each).  A ragged
        final chunk is padded into its pow2 bucket; the yielded arrays are
        bucket-length with the pad lanes' ``moved`` forced False.
        ``fuse`` > 1 diffs up to that many consecutive equal-length chunks
        in one launch over their concatenation -- the same yielded tuples,
        ``fuse``-fold fewer launches.

        ``mesh=`` diffs each chunk over the ranks: each rank yields its
        shard of every padded chunk (lanes ``sweep.bounds``), and the
        ranks' tuples concatenated in rank order are the single-card
        tuple."""
        sweep = self._sweep(mesh)
        if sweep is not None:
            yield from self._mesh_stream(id_chunks, v_from, v_to, None, sweep)
        else:
            yield from self._stream(id_chunks, v_from, v_to, fuse, None)

    def plan_replicas_stream(
        self, id_chunks, v_from: int, v_to: int, n_replicas: int, *,
        mesh=None, fuse: int = 1,
    ):
        """Replica streaming sweep: yield ``(ids, moved, src, dst,
        src_slot)`` device tuples per chunk -- the R-way twin of
        ``plan_stream``."""
        sweep = self._sweep(mesh)
        if sweep is not None:
            yield from self._mesh_stream(id_chunks, v_from, v_to, int(n_replicas), sweep)
        else:
            yield from self._stream(id_chunks, v_from, v_to, fuse, int(n_replicas))

    @staticmethod
    def chunked(ids, chunk: int = DEFAULT_CHUNK):
        """Chunking helper for ``plan_stream`` (arrays or tensors)."""
        for start in range(0, len(ids), chunk):
            yield ids[start : start + chunk]

    # -- host-facing plan assembly ------------------------------------------

    def plan(
        self,
        datum_ids,
        v_from: int,
        v_to: int,
        *,
        chunk: int = DEFAULT_CHUNK,
        max_new_seg: int | None = None,
        known_src=None,
        mesh=None,
    ) -> MigrationPlan:
        """Assemble the full ``MigrationPlan`` for a tracked id set.

        ``max_new_seg`` (the largest segment number the v -> v+1 change
        assigned; add-node events know it) turns on the ADDITION-NUMBER
        prefilter: only ids with AN <= max_new_seg (or AN unknown, the
        sound fallback) pay the full two-version diff.  The numpy backend
        diffs on the host; the device backend launches the diff kernel per
        (pow2-padded) chunk and copies the result back once per chunk.
        ``known_src`` (aligned with ``datum_ids``) gives the v owners a
        caller already keeps (``ElasticCoordinator``'s owner table), so the
        numpy backend places each id once; the device diff places both
        versions in one launch anyway and ignores it.  ``mesh=`` diffs
        every chunk over the ranks (the device path whatever the backend);
        the plan, on every rank, equals the single-card plan."""
        t0 = time.perf_counter()
        ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
        sweep = self._sweep(mesh)
        host = self.engine.backend == "numpy" and sweep is None
        if known_src is not None:
            known_src = np.asarray(known_src, dtype=np.int64)
        out_ids, out_src, out_dst, out_idx = [], [], [], []
        for start in range(0, len(ids), chunk):
            c = ids[start : start + chunk]
            base = np.arange(start, start + len(c), dtype=np.int64)
            if max_new_seg is not None:
                keep = self._candidates(c, v_from, max_new_seg, host)
                self._note_prefilter(len(keep), int(keep.sum()))
                c, base = c[keep], base[keep]
            if c.size == 0:
                continue
            if host:
                src = (known_src[base] if known_src is not None
                       else self.engine.place_nodes_at(c, v_from))
                dst = self.engine.place_nodes_at(c, v_to)
                moved = src != dst
            else:
                moved, src, dst = self._host_diff(c, v_from, v_to, None, sweep)
                src, dst = src.astype(np.int64), dst.astype(np.int64)
            out_ids.append(c[moved])
            out_src.append(src[moved])
            out_dst.append(dst[moved])
            out_idx.append(base[moved])
        plan = MigrationPlan(
            v_from=v_from,
            v_to=v_to,
            ids=_cat(out_ids, np.uint32),
            src=_cat(out_src, np.int64),
            dst=_cat(out_dst, np.int64),
            index=_cat(out_idx, np.int64),
            n_scanned=len(ids),
        )
        self._note_plan("planner.plan", plan, t0)
        return plan

    def plan_replicas(
        self,
        datum_ids,
        v_from: int,
        v_to: int,
        n_replicas: int,
        *,
        chunk: int = DEFAULT_CHUNK,
        max_new_seg: int | None = None,
        known_before=None,
        mesh=None,
    ) -> MigrationPlan:
        """Assemble the per-slot REPLICA ``MigrationPlan`` for an id set.

        Every id's R-replica set is placed under both versions and the two
        sets are aligned per slot, so a row exists exactly for the replicas
        whose owner changed -- ``|after \\ before|`` rows per id, the
        section-5 minimal replica mass.  ``max_new_seg`` turns on the
        R-aware ADDITION-NUMBER prefilter.  ``known_before`` ((len(ids), R)
        v replica sets a caller already keeps) saves the numpy backend one
        of its two sweeps; the device diff ignores it.  ``mesh=`` as in
        ``plan``."""
        t0 = time.perf_counter()
        ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
        sweep = self._sweep(mesh)
        hier = self.engine.hierarchical
        if hier and max_new_seg is not None:
            raise ValueError(
                "the ADDITION-NUMBER prefilter is flat-table semantics; "
                "hierarchical plans scan the full id set (max_new_seg=None)"
            )
        # hierarchical engines always diff through the two-level kernel path
        # (node-plane alignment); the host replica sweep returns pairs
        host = self.engine.backend == "numpy" and sweep is None and not hier
        if known_before is not None:
            known_before = np.asarray(known_before, dtype=np.int64)
        out: dict[str, list[np.ndarray]] = {
            k: [] for k in ("ids", "src", "dst", "idx", "slot", "src_slot")
        }
        for start in range(0, len(ids), chunk):
            c = ids[start : start + chunk]
            base = np.arange(start, start + len(c), dtype=np.int64)
            if max_new_seg is not None:
                keep = self._candidates(c, v_from, max_new_seg, host, n_replicas=n_replicas)
                self._note_prefilter(len(keep), int(keep.sum()))
                c, base = c[keep], base[keep]
            if c.size == 0:
                continue
            if host:
                before = (known_before[base] if known_before is not None
                          else self.engine.place_replica_nodes_at(c, v_from, n_replicas))
                dst = self.engine.place_replica_nodes_at(c, v_to, n_replicas)
                moved, src, src_slot = align_replica_sets(before, dst)
            else:
                moved, src, dst, src_slot = self._host_diff(
                    c, v_from, v_to, n_replicas, sweep
                )
                src, dst = src.astype(np.int64), dst.astype(np.int64)
            b_idx, r_idx = np.nonzero(moved)  # id-major, slot-minor
            out["ids"].append(c[b_idx])
            out["src"].append(src[b_idx, r_idx])
            out["dst"].append(dst[b_idx, r_idx])
            out["idx"].append(base[b_idx])
            out["slot"].append(r_idx.astype(np.int32))
            out["src_slot"].append(src_slot[b_idx, r_idx].astype(np.int32))
        plan = MigrationPlan(
            v_from=v_from,
            v_to=v_to,
            ids=_cat(out["ids"], np.uint32),
            src=_cat(out["src"], np.int64),
            dst=_cat(out["dst"], np.int64),
            index=_cat(out["idx"], np.int64),
            n_scanned=len(ids),
            n_replicas=n_replicas,
            slot=_cat(out["slot"], np.int32),
            src_slot=_cat(out["src_slot"], np.int32),
        )
        self._note_plan("planner.plan_replicas", plan, t0)
        return plan

    def _candidates(
        self, chunk: np.ndarray, v_from: int, max_new_seg: int, host: bool,
        n_replicas: int = 1,
    ) -> np.ndarray:
        """AN <= max_new_seg prefilter mask (sound: unknown -> candidate);
        the ADDITION NUMBER of the R-replica trace."""
        if host:
            art = self.engine.artifact_for(v_from, "asura")
            lengths = art.len32.astype(np.float64) / 2.0**32  # exact round trip
            an = addition_numbers_batch(
                chunk, lengths, art.node_of, n_replicas, params=self.engine.params
            )
            return an <= max_new_seg
        an = self.engine.addition_numbers_device(
            chunk, version=v_from, n_replicas=n_replicas
        ).cpu().numpy()
        return (an < 0) | (an <= max_new_seg)


def _cat(parts, dtype) -> np.ndarray:
    return np.concatenate(parts) if parts else np.zeros(0, dtype=dtype)
