"""ASURA-placed, replicated, async checkpointing.

Checkpoint model: the train state is flattened to leaves; each leaf is split
into fixed-size chunks; each chunk gets a stable datum id
hash(step, leaf_index, chunk_index).  ASURA places every chunk on R distinct
storage nodes (paper section 5.A replication) -- so

  * there is NO manifest mapping chunks to nodes: any reader recomputes the
    placement from the O(N) segment table (algorithm management),
  * the system tolerates up to R-1 storage-node losses for every chunk,
  * when a storage node dies, exactly the chunks it held are re-replicated
    (optimal data movement, paper section 2.A), chosen via REMOVE NUMBERS
    without recomputing every chunk's placement (section 2.D),
  * adding storage capacity rebalances minimally (ADDITION NUMBER path).

``StorageNode`` is an in-memory stand-in for a storage daemon; the I/O layer
is deliberately pluggable (the placement logic is the paper's contribution).
Async saves run on a thread and are awaited by ``wait()`` -- checkpoint
writes overlap the next training step.

The port's copy of the reference store.  Chunk placement runs through the
cluster's port engine (the replica kernel B2, on the card unless
``device="cpu"``).  A state is a nested dict / list / tuple of torch
tensors or NumPy arrays, flattened in ``jax.tree.leaves`` order (plain
dict keys sorted, ``OrderedDict`` -- a ``state_dict`` -- in insertion
order, lists and tuples in order, ``None`` dropped), so a leaf's index,
and with it every chunk id, is the reference's: either package reads a
store the other wrote.  A leaf's bytes are its C-order memory (bfloat16
included, through a byte view).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..core import Cluster
from ..core.rng import fmix32_scalar
from ..migrate import DrainDriver, LiveMigration, MigrationPlanner
from ..obs.trace import maybe_span

CHUNK_BYTES = 1 << 20  # 1 MiB chunks, the paper's example datum unit


def chunk_id(step: int, leaf_idx: int, chunk_idx: int) -> int:
    return fmix32_scalar(
        fmix32_scalar(step * 0x9E3779B9 + leaf_idx) ^ (chunk_idx * 0x85EBCA77)
    )


@dataclasses.dataclass
class StorageNode:
    node_id: int
    capacity: float
    blobs: dict[int, bytes] = dataclasses.field(default_factory=dict)
    alive: bool = True

    def put(self, key: int, blob: bytes) -> None:
        if not self.alive:
            raise IOError(f"node {self.node_id} is down")
        self.blobs[key] = blob

    def get(self, key: int) -> bytes:
        if not self.alive:
            raise IOError(f"node {self.node_id} is down")
        return self.blobs[key]

    def used_bytes(self) -> int:
        return sum(len(b) for b in self.blobs.values())


class AsuraCheckpointStore:
    """A cluster of storage nodes addressed purely by the ASURA table; its
    engine places on ``device`` (None: the card)."""

    def __init__(self, capacities: dict[int, float], n_replicas: int = 3, *, device=None):
        self.cluster = Cluster(device=device)
        self.nodes: dict[int, StorageNode] = {}
        for nid, cap in capacities.items():
            self.cluster.add_node(nid, cap)
            self.nodes[nid] = StorageNode(nid, cap)
        self.n_replicas = n_replicas
        # Chunk placement runs through the cluster's PlacementEngine: save /
        # restore / repair issue many replica lookups against one cached
        # table artifact per membership version (no per-call table prep).
        self.engine = self.cluster.engine
        self._migration: StoreMigration | None = None  # live rebalance window

    # -- placement ---------------------------------------------------------

    def replicas_for(self, keys: np.ndarray) -> np.ndarray:
        return self.engine.place_replica_nodes(
            np.asarray(keys, dtype=np.uint32), self.n_replicas
        )

    def replicas_for_device(self, keys) -> torch.Tensor:
        """(keys, R) replica node ids as a device tensor, no host sync.

        For device-chained consumers (e.g. diffing placements across a
        membership change, or sharding device-resident key streams): the
        placement, tail resolution and node gather all stay on device."""
        return self.engine.place_replica_nodes_device(keys, self.n_replicas)

    def _all_blobs(self) -> dict[int, bytes]:
        """Every stored (key, blob) across the live nodes."""
        all_keys: dict[int, bytes] = {}
        for node in self.nodes.values():
            all_keys.update(node.blobs)
        return all_keys

    def _replica_rows(self, keys: np.ndarray, keys_dev=None) -> np.ndarray:
        """Host (keys, R) replica sweep, chained on device when available
        (one sync for the whole sweep instead of per-key work)."""
        if keys.size == 0:
            return np.empty((0, self.n_replicas), dtype=np.int64)
        if keys_dev is not None:
            return self.replicas_for_device(keys_dev).cpu().numpy().astype(np.int64)
        return self.replicas_for(keys)

    # -- chunk I/O ----------------------------------------------------------

    def put_chunks(self, keys: np.ndarray, blobs: list[bytes]) -> None:
        placements = self.replicas_for(keys)
        for key, blob, nodes in zip(keys, blobs, placements):
            if self._migration is not None:
                # Write through the migration window: a pending chunk must
                # be overwritten where READERS are routed (its mixed-version
                # replica set) -- the fresh blob then rides the landing copy
                # to the v+1 owners (``StoreMigration._land`` prefers the
                # live copy, and the refreshed snapshot keeps even the
                # all-sources-died fallback from resurrecting stale bytes).
                row = self._migration.read_row(int(key))
                if row is not None:
                    nodes = row
                    self._migration._blobs[int(key)] = blob
            for nid in nodes:
                # a served set may still name a REMOVED node mid-repair
                # (its pending slots); skip it -- the fresh blob rides the
                # landing copy.  Dead-but-registered nodes still raise.
                node = self.nodes.get(int(nid))
                if node is not None:
                    node.put(int(key), blob)

    def get_chunk(self, key: int) -> bytes:
        nodes = None
        if self._migration is not None:
            # Migration-window read rule (DESIGN.md sections 8, 10): each
            # replica SLOT of a moving chunk is read from its v-side source
            # until its copy lands, from its v+1 owner after -- the set
            # that actually holds it, mixed-version mid-drain.
            nodes = self._migration.read_row(int(key))
        if nodes is None:
            nodes = self.replicas_for(np.array([key], dtype=np.uint32))[0]
        errors = []
        for nid in nodes:  # primary first, replicas on failure
            node = self.nodes.get(int(nid))
            if node is None or not node.alive:
                errors.append(f"node {nid} down")
                continue
            try:
                return node.get(int(key))
            except KeyError:
                errors.append(f"node {nid} missing chunk")
        raise IOError(f"chunk {key} unreadable: {errors}")

    # -- elasticity / failure ----------------------------------------------

    def fail_node(self, node_id: int) -> None:
        self.nodes[node_id].alive = False

    def _check_no_migration(self) -> None:
        """Membership must not mutate under a live rebalance window -- the
        window's before/after snapshots would no longer describe reality
        (same single-drain rule as ``ElasticCoordinator``)."""
        if self._migration is not None and not self._migration.done:
            raise RuntimeError(
                "a store migration is in flight; drain it before the next "
                "membership event"
            )

    def _affected_by_removal(self, keys: np.ndarray, node_id: int) -> np.ndarray:
        """Keys whose replica set includes the victim, via one vectorized
        REMOVE-NUMBER sweep (section 2.D: a chunk is affected iff one of
        its remove numbers names a victim segment) -- the engine-path
        ``remove_numbers_batch``, not a per-key scalar trace."""
        if keys.size == 0:
            return keys
        victim_segments = np.asarray(
            sorted(self.cluster.nodes[node_id].segments), dtype=np.int64
        )
        rn = self.engine.remove_numbers_batch(keys, self.n_replicas)
        return keys[np.isin(rn, victim_segments).any(axis=1)]

    def remove_node_and_repair(self, node_id: int) -> int:
        """Remove a node; re-replicate exactly the chunks it held.

        Uses REMOVE NUMBERS (paper section 2.D): a chunk needs repair iff
        one of its remove numbers is a segment of the removed node --
        computed for the whole key population in one vectorized
        ``remove_numbers_batch`` sweep.  Returns the number of chunk copies
        moved (provably minimal).  ``begin_remove_node`` is the THROTTLED
        variant (repair as a live replica migration)."""
        self._check_no_migration()
        # collect every stored key (any surviving replica knows its blobs)
        all_keys: dict[int, bytes] = {}
        for node in self.nodes.values():
            if node.node_id != node_id and node.alive:
                all_keys.update(node.blobs)
        keys = np.fromiter(all_keys, dtype=np.uint32, count=len(all_keys))
        affected = self._affected_by_removal(keys, node_id)
        self.cluster.remove_node(node_id)
        dead = self.nodes.pop(node_id)
        dead.alive = False
        moved = 0
        if affected.size:
            placements = self.replicas_for(affected)  # one vectorized sweep
            for key, row in zip(affected, placements):
                blob = all_keys[int(key)]
                for nid in row:
                    node = self.nodes[int(nid)]
                    # other down-but-not-yet-removed nodes get their copies
                    # when their own removal/repair runs
                    if node.alive and int(key) not in node.blobs:
                        node.put(int(key), blob)
                        moved += 1
        return moved

    def _begin_migration(
        self,
        plan,
        all_keys,
        *,
        egress,
        ingress,
        clock,
        round_seconds,
        ledger=None,
        bytes_per_row=0,
    ) -> "StoreMigration":
        live = LiveMigration.from_plan(
            self.engine,
            plan,
            egress=egress,
            ingress=ingress,
            clock=clock,
            round_seconds=round_seconds,
            ledger=ledger,
            bytes_per_row=bytes_per_row,
        )
        self._migration = StoreMigration(self, live, all_keys)
        return self._migration

    def begin_add_node(
        self,
        node_id: int,
        capacity: float,
        *,
        egress=None,
        ingress=None,
        clock=None,
        round_seconds: float = 1.0,
        ledger=None,
    ) -> "StoreMigration":
        """Add storage as a LIVE migration: the same minimal chunk set as
        ``add_node``, but blob copies drain in bandwidth-budgeted rounds
        while ``get_chunk`` reads through the dual-version rule.

        The plan is the PER-SLOT replica plan (``plan_replicas``, DESIGN.md
        section 10): one row per replica copy that actually changes owner,
        with the vacated v-side node as its source -- so ingress/egress
        budgets bind on the nodes doing each transfer and the movement
        matrices account every copy, not one flow per chunk.  The add-node
        ADDITION-NUMBER prefilter (R-replica trace) shrinks the diff set.
        Drive the returned ``StoreMigration`` (``round``/``pump``/``run``);
        the store detaches it automatically once drained.  A ``ledger``
        gets one ``migrate.round`` event per drained round with CHUNK_BYTES
        per-row byte accounting."""
        self._check_no_migration()
        all_keys = self._all_blobs()
        keys = np.fromiter(all_keys, dtype=np.uint32, count=len(all_keys))
        self.engine.artifact()  # pin the v table before mutating
        v_from = self.cluster.version
        new_segs = self.cluster.add_node(node_id, capacity)
        self.nodes[node_id] = StorageNode(node_id, capacity)
        plan = MigrationPlanner(self.engine, ledger=ledger).plan_replicas(
            keys,
            v_from,
            self.cluster.version,
            self.n_replicas,
            max_new_seg=max(new_segs) if new_segs else None,
        )
        return self._begin_migration(
            plan,
            all_keys,
            egress=egress,
            ingress=ingress,
            clock=clock,
            round_seconds=round_seconds,
            ledger=ledger,
            bytes_per_row=CHUNK_BYTES,
        )

    def begin_remove_node(
        self,
        node_id: int,
        *,
        egress=None,
        ingress=None,
        clock=None,
        round_seconds: float = 1.0,
        ledger=None,
    ) -> "StoreMigration":
        """Remove (or repair a failed) node as a LIVE migration.

        The throttled variant of ``remove_node_and_repair``: exactly the
        victim's replica mass re-replicates -- a per-slot replica plan over
        the affected keys (one vectorized REMOVE-NUMBER sweep picks them)
        whose every row sources at the victim -- in bandwidth-budgeted
        rounds, while ``get_chunk`` keeps reading through the window: a
        pending slot still names the victim, and the surviving R-1 replicas
        serve it via the fall-back read, so restores stay bit-identical
        throughout the degraded window (tested)."""
        self._check_no_migration()
        all_keys = self._all_blobs()
        keys = np.fromiter(all_keys, dtype=np.uint32, count=len(all_keys))
        self.engine.artifact()  # pin the v table before mutating
        v_from = self.cluster.version
        affected = self._affected_by_removal(keys, node_id)
        self.cluster.remove_node(node_id)
        dead = self.nodes.pop(node_id)
        dead.alive = False
        plan = MigrationPlanner(self.engine, ledger=ledger).plan_replicas(
            affected, v_from, self.cluster.version, self.n_replicas
        )
        return self._begin_migration(
            plan,
            all_keys,
            egress=egress,
            ingress=ingress,
            clock=clock,
            round_seconds=round_seconds,
            ledger=ledger,
            bytes_per_row=CHUNK_BYTES,
        )

    def add_node(self, node_id: int, capacity: float) -> int:
        """Add storage; migrate exactly the chunks the new node wins."""
        self._check_no_migration()
        all_keys = self._all_blobs()
        keys = np.fromiter(all_keys, dtype=np.uint32, count=len(all_keys))
        keys_dev = None
        if self.engine.backend != "numpy" and keys.size:
            # both placement sweeps read one upload of the keys
            keys_dev = torch.from_numpy(keys).to(self.engine.device)
        before = self._replica_rows(keys, keys_dev)
        self.cluster.add_node(node_id, capacity)
        self.nodes[node_id] = StorageNode(node_id, capacity)
        moved = 0
        if keys.size:
            after = self._replica_rows(keys, keys_dev)
            for key, b_row, a_row in zip(keys, before, after):
                if set(b_row.tolist()) == set(a_row.tolist()):
                    continue
                blob = all_keys[int(key)]
                a_set = set(int(x) for x in a_row)
                for nid in a_set:
                    node = self.nodes[nid]
                    if node.alive and int(key) not in node.blobs:
                        node.put(int(key), blob)
                        moved += 1
                # GC copies superseded by the new placement (reclaim capacity)
                for nid in set(int(x) for x in b_row) - a_set:
                    self.nodes[nid].blobs.pop(int(key), None)
        return moved


class StoreMigration(DrainDriver):
    """A live storage rebalance: throttled PER-SLOT blob copies +
    read-through (DESIGN.md section 10).

    Wraps a ``LiveMigration`` over a per-slot replica plan: each row is one
    replica copy ``(key, slot, src, dst)``.  Each round the mover lands a
    budgeted batch of rows; every newly landed row copies its blob to the
    row's destination and garbage-collects the vacated source copy once
    the destination actually holds it (capacity is reclaimed
    incrementally, and a destination that died mid-migration never costs
    the surviving copies -- repair reconciles it later).  ``read_row`` is
    ``get_chunk``'s window rule: the mixed-version replica set that holds
    the key right now (``LiveMigration.route_replicas``), ``None`` for
    unaffected keys.  round/pump/run come from the shared ``DrainDriver``
    loop; the landing hook rides ``_advance`` so no verb can skip it.
    """

    def __init__(self, store, live, blobs):
        self.store = store
        self.live = live
        self._window_ids = np.unique(live.state.plan.ids)  # sorted
        self._served_rows = None  # per-round cache of the window's sets
        self._blobs = blobs  # key -> blob snapshot, refreshed by put_chunks
        self.copies_moved = 0

    @property
    def done(self) -> bool:
        return self.live.done

    def _pending_desc(self) -> str:
        return f"{self.live.state.n_pending} rows pending"

    def read_row(self, key: int):
        pos = int(np.searchsorted(self._window_ids, np.uint32(key)))
        if pos >= len(self._window_ids) or int(self._window_ids[pos]) != int(key):
            return None
        if self._served_rows is None:
            # One vectorized replica-route sweep per ROUND for the whole
            # window (served sets only change when rows land, which
            # invalidates this cache) -- per-key reads are then O(log n).
            self._served_rows = self.live.route_replicas(self._window_ids)
        return self._served_rows[pos]

    def _land(self, rows: np.ndarray) -> None:
        plan = self.live.state.plan
        for row in rows:
            key = int(plan.ids[row])
            src = int(plan.src[row])
            dst = int(plan.dst[row])
            # Prefer the live copy at the vacated source (the chunk may
            # have been overwritten mid-migration -- window writes land on
            # the serving set, which includes the source while pending);
            # the put_chunks-refreshed snapshot is the fallback.
            blob = self._blobs.get(key)
            snode = self.store.nodes.get(src)
            if snode is not None and snode.alive and key in snode.blobs:
                blob = snode.blobs[key]
            dnode = self.store.nodes.get(dst)  # tolerate removed nodes
            if (
                blob is not None
                and dnode is not None
                and dnode.alive
                and key not in dnode.blobs
            ):
                dnode.put(key, blob)
                self.copies_moved += 1
            # GC the vacated copy ONLY once a LIVE destination holds the
            # chunk -- a dead destination's copy is unreadable and must not
            # cost the surviving one.
            if (
                snode is not None
                and dnode is not None
                and dnode.alive
                and key in dnode.blobs
            ):
                snode.blobs.pop(key, None)

    def _advance(self, fn) -> list[dict[tuple[int, int], int]]:
        pre = self.live.state.landed.copy()
        matrices = fn()
        newly = np.nonzero(self.live.state.landed & ~pre)[0]
        if newly.size:
            self._served_rows = None  # landed bits moved the read rule
        self._land(newly)
        if self.done and self.store._migration is self:
            self.store._migration = None  # detach: table v+1 is now total
        return matrices

    def _round(self) -> dict[tuple[int, int], int]:
        return self.live.round()

    def _pump_rounds(self) -> list[dict[tuple[int, int], int]]:
        return self.live.pump()


def _flatten(tree):
    """``(leaves, rebuild)`` in ``jax.tree.leaves`` order: plain dict keys
    sorted, ``OrderedDict`` keys in insertion order, lists, tuples and
    namedtuples in order, ``None`` an empty subtree; anything else is a
    leaf.  ``rebuild(new_leaves)`` returns ``tree``'s structure around
    them."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, dict):
        keys = list(tree) if isinstance(tree, collections.OrderedDict) else sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        kind = collections.OrderedDict if isinstance(tree, collections.OrderedDict) else dict
        order = list(tree)

        def rebuild(leaves):
            out, pos = {}, 0
            for k, (sub, build) in zip(keys, parts):
                out[k] = build(leaves[pos : pos + len(sub)])
                pos += len(sub)
            return kind((k, out[k]) for k in order)

        return [x for sub, _ in parts for x in sub], rebuild
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(x) for x in tree]

        def rebuild(leaves):
            out, pos = [], 0
            for sub, build in parts:
                out.append(build(leaves[pos : pos + len(sub)]))
                pos += len(sub)
            if isinstance(tree, list):
                return out
            return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)

        return [x for sub, _ in parts for x in sub], rebuild
    return [tree], lambda leaves: leaves[0]


def _leaf_bytes(leaf) -> bytes:
    """A leaf's C-order bytes, copied to the host.  Tensors go through a
    uint8 view, so dtypes NumPy lacks (bfloat16) keep their bits."""
    if isinstance(leaf, torch.Tensor):
        flat = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
        return flat.cpu().numpy().tobytes()
    return np.asarray(leaf).tobytes()


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


def _leaf_from_bytes(buf: bytes, like):
    """A leaf of ``like``'s dtype and shape (and device, for a tensor)
    from its C-order bytes."""
    if isinstance(like, torch.Tensor):
        raw = torch.from_numpy(np.frombuffer(buf, dtype=np.uint8).copy())
        return raw.view(like.dtype).reshape(like.shape).to(like.device)
    arr = np.asarray(like)
    return np.frombuffer(buf, dtype=arr.dtype).reshape(arr.shape)


class CheckpointManager:
    """Save/restore nested states of tensors or arrays against an
    AsuraCheckpointStore.

    Pass an ``obs.TraceLedger`` to get one span per save/restore
    (``checkpoint.save`` / ``checkpoint.restore`` with chunk and byte
    counts); without one the manager emits nothing.
    """

    def __init__(self, store: AsuraCheckpointStore, *, ledger=None):
        self.store = store
        self.ledger = ledger
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saved_steps: list[int] = []

    # -- save ----------------------------------------------------------------

    def _save_raw(self, step: int, raws: list[bytes]) -> None:
        keys, blobs = [], []
        for li, raw in enumerate(raws):
            n = max(1, -(-len(raw) // CHUNK_BYTES))
            for ci in range(n):
                keys.append(chunk_id(step, li, ci))
                blobs.append(raw[ci * CHUNK_BYTES : (ci + 1) * CHUNK_BYTES])
        with maybe_span(
            self.ledger,
            "checkpoint.save",
            step=step,
            n_chunks=len(keys),
            n_bytes=sum(len(b) for b in blobs),
        ):
            self.store.put_chunks(np.asarray(keys, dtype=np.uint32), blobs)
        self.saved_steps.append(step)

    def save(self, step: int, tree: Any) -> None:
        self._save_raw(step, [_leaf_bytes(x) for x in _flatten(tree)[0]])

    def save_async(self, step: int, tree: Any) -> None:
        """Copy every leaf to host bytes NOW, then write on a thread
        (overlaps training): tensors updated in place after this call (an
        optimizer step) do not reach the checkpoint."""
        self.wait()
        raws = [_leaf_bytes(x) for x in _flatten(tree)[0]]

        def work():
            try:
                self._save_raw(step, raws)
            except BaseException as e:  # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore --------------------------------------------------------------

    def restore(self, step: int, like: Any) -> Any:
        """Rebuild a state shaped like ``like`` from the store: each leaf
        of ``like``'s dtype and shape, tensors on ``like``'s device."""
        leaves, rebuild = _flatten(like)
        out = []
        n_chunks = n_bytes = 0
        with maybe_span(self.ledger, "checkpoint.restore", step=step):
            for li, leaf in enumerate(leaves):
                n = max(1, -(-_leaf_nbytes(leaf) // CHUNK_BYTES))
                buf = b"".join(
                    self.store.get_chunk(chunk_id(step, li, ci)) for ci in range(n)
                )
                n_chunks += n
                n_bytes += len(buf)
                out.append(_leaf_from_bytes(buf, leaf))
        if self.ledger is not None:
            self.ledger.incr("checkpoint.chunks_read", n_chunks)
            self.ledger.incr("checkpoint.bytes_read", n_bytes)
        return rebuild(out)
