"""PlacementEngine: versioned, device-resident table artifacts per cluster.

The port of the reference engine's flat-ASURA half.  The engine owns a
small LRU of ``TableArtifact`` snapshots keyed by ``Cluster.version``:
canonical u32 lengths, the seg->node map, the static ladder top level and
their device copies (plus the u64 length-cumsum halves the on-device tail
reads), so one STEP-1 mutation costs exactly ONE table materialization
and upload however many placements follow -- the ``uploads`` ledger
counter asserts it.  The cache holds the ``CACHE_VERSIONS`` most recent
versions, so a router flapping between two versions rebuilds nothing.

Two backends, bit-identical:

  * ``device`` -- the hand-written CUDA kernels on a CUDA ``device``, their
    plain-torch twins on ``device="cpu"`` (the default backend),
  * ``numpy``  -- the host oracles of ``core.asura`` (the reference's
    NumPy path, copied).

Host-facing methods (``place``, ``place_nodes``, ``place_replicas``,
``place_replica_nodes``) return NumPy arrays after one device->host copy;
the ``*_device`` variants return tensors on the engine's device with no
host sync (placement, tail and seg->node gather in one launch).

The version-pinned surface serves a migration window: ``artifact_for``
returns a cached older version (and raises ``KeyError`` for an evicted
one -- the cluster has moved on, so it is never rebuilt), the ``*_at``
methods place under it, ``diff_nodes_device`` / ``diff_replicas_device``
place every id under two versions in one launch (the planner's
primitives), and ``addition_numbers_device`` / ``remove_numbers_batch``
compute the section 2.D metadata.

The engine is duck-typed on the cluster (``version``, ``params``,
``seg_lengths()``, ``seg_to_node()``).  The baselines' algorithms and
hierarchical clusters are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.u32 import as_u32
from ..obs.trace import TraceLedger
from .asura import (
    DEFAULT_PARAMS,
    AsuraParams,
    _upper_bound,
    lengths_to_u32,
    align_replica_sets,
    place_batch_u32,
    place_replicas_u32,
    resolve_tail_np,
)

BACKENDS = ("device", "numpy")

CACHE_VERSIONS = 4  # most-recent table versions kept materialized


@dataclasses.dataclass(frozen=True)
class TableArtifact:
    """Immutable snapshot of one cluster version's placement table.

    ``len32`` (uint32) / ``node_of`` (int64) are the host canonical arrays;
    ``len32_dev`` / ``cum_hi_dev`` / ``cum_lo_dev`` (uint32) and
    ``node_of_dev`` (int32) are the device copies, None until a device path
    needs them."""

    version: int
    n_segs: int
    top_level: int
    len32: np.ndarray
    node_of: np.ndarray
    len32_dev: Any = None
    node_of_dev: Any = None
    cum_hi_dev: Any = None
    cum_lo_dev: Any = None

    @property
    def has_device_tables(self) -> bool:
        return self.len32_dev is not None


def with_device_tables(art: TableArtifact, device) -> TableArtifact:
    """``art`` with its device copies filled (one host->device upload)."""
    from ..kernels.ops import node_table_prep, tail_prep

    dev = resolve_device(device)
    cum_hi, cum_lo = tail_prep(art.len32, device=dev)
    return dataclasses.replace(
        art,
        len32_dev=torch.from_numpy(np.ascontiguousarray(art.len32, np.uint32)).to(dev),
        node_of_dev=node_table_prep(art.node_of, device=dev),
        cum_hi_dev=cum_hi,
        cum_lo_dev=cum_lo,
    )


class PlacementEngine:
    """Cached STEP-2 dispatcher bound to one mutable cluster."""

    def __init__(
        self,
        cluster,
        *,
        device=None,
        backend: str = "device",
        algorithm: str = "asura",
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if getattr(cluster, "is_hierarchical", False):
            raise NotImplementedError(
                "hierarchical clusters are not ported yet (ROADMAP A6)"
            )
        self.algorithm = self._resolve_algorithm(algorithm)
        self.cluster = cluster
        self.params: AsuraParams = getattr(cluster, "params", DEFAULT_PARAMS)
        self.device = resolve_device(device)
        self.backend = backend
        self._artifacts: OrderedDict[int, TableArtifact] = OrderedDict()
        # instance-scoped so the exact upload tripwire never aliases
        self.ledger = TraceLedger()

    @staticmethod
    def _resolve_algorithm(algorithm: str | None) -> str:
        if algorithm not in (None, "asura"):
            raise NotImplementedError(
                f"algorithm {algorithm!r} is not ported yet (ROADMAP A5); "
                "the port places with 'asura' only"
            )
        return "asura"

    @property
    def uploads(self) -> int:
        """Table materializations (one per version) -- a ledger counter."""
        return self.ledger.counter("engine.uploads")

    # -- artifact lifecycle --------------------------------------------------

    def _store(self, art: TableArtifact) -> None:
        self._artifacts[art.version] = art
        while len(self._artifacts) > CACHE_VERSIONS:
            evicted, _ = self._artifacts.popitem(last=False)
            self.ledger.incr("engine.lru_evictions")
            self.ledger.event("engine.lru_evict", "asura", version=evicted)

    def artifact(self) -> TableArtifact:
        """The current version's table, rebuilt (and re-uploaded) only when
        ``cluster.version`` is not among the cached artifacts."""
        version = self.cluster.version
        art = self._artifacts.get(version)
        if art is not None:
            self._artifacts.move_to_end(version)
            self.ledger.incr("engine.lru_hits")
            return art
        with self.ledger.span("engine.build_artifact", algorithm="asura",
                              version=version):
            lengths = np.asarray(self.cluster.seg_lengths(), dtype=np.float64)
            len32 = lengths_to_u32(lengths)
            art = TableArtifact(
                version=version,
                n_segs=len(len32),
                top_level=self.params.level_for(_upper_bound(lengths)),
                len32=len32,
                node_of=np.asarray(self.cluster.seg_to_node(), dtype=np.int64),
            )
            if self.backend == "device":
                art = with_device_tables(art, self.device)
        self._store(art)
        self.ledger.incr("engine.uploads")
        self.ledger.event("engine.upload", "asura", version=version,
                          n_segs=art.n_segs)
        return art

    def _device_artifact(self) -> TableArtifact:
        """``artifact()`` with device tables; on the numpy backend they are
        built on the first ``*_device`` call, as part of the same version's
        one materialization (``uploads`` does not tick again)."""
        art = self.artifact()
        if not art.has_device_tables:
            art = with_device_tables(art, self.device)
            self._artifacts[art.version] = art
        return art

    def artifact_for(self, version: int) -> TableArtifact:
        """The table artifact of a SPECIFIC version (migration windows).

        The current version is built on demand; any other version must
        still be in the LRU (place at it before mutating the cluster).  An
        evicted version cannot be rebuilt -- the cluster has moved on -- so
        this raises ``KeyError`` rather than re-deriving the wrong table."""
        if version == self.cluster.version:
            return self.artifact()
        art = self._artifacts.get(version)
        if art is None:
            raise KeyError(
                f"asura table version {version} not cached (LRU holds "
                f"{list(self._artifacts)}); place at that version before "
                "mutating"
            )
        self._artifacts.move_to_end(version)
        return art

    def _device_artifact_for(self, version: int) -> TableArtifact:
        """``artifact_for`` with device tables (same materialization)."""
        art = self.artifact_for(version)
        if not art.has_device_tables:
            art = with_device_tables(art, self.device)
            self._artifacts[art.version] = art
        return art

    # -- host-facing STEP 2 --------------------------------------------------

    @staticmethod
    def _host_ids(datum_ids) -> np.ndarray:
        if isinstance(datum_ids, torch.Tensor):
            return as_u32(datum_ids).cpu().numpy().astype(np.uint32)
        return np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))

    def place(self, datum_ids) -> np.ndarray:
        """Batch placement -> int64 segment numbers (tail-resolved, total)."""
        art = self.artifact()
        ids = self._host_ids(datum_ids)
        if self.backend == "numpy":
            segs = place_batch_u32(ids, art.len32, art.top_level, self.params)
            return resolve_tail_np(ids, segs, art.len32, art.top_level)
        return self.place_device(ids).cpu().numpy().astype(np.int64)

    def place_nodes(self, datum_ids, algorithm: str | None = None) -> np.ndarray:
        """Batch placement -> int64 node ids."""
        self._resolve_algorithm(algorithm)
        if self.backend == "numpy":
            return self.artifact().node_of[self.place(datum_ids)]
        ids = self._host_ids(datum_ids)
        return self.place_nodes_device(ids).cpu().numpy().astype(np.int64)

    def place_replicas(self, datum_ids, n_replicas: int) -> np.ndarray:
        """(batch, R) segment numbers on R distinct nodes, primary first."""
        art = self.artifact()
        ids = self._host_ids(datum_ids)
        if self.backend == "numpy":
            return place_replicas_u32(
                ids, art.len32, art.node_of, n_replicas, art.top_level, self.params
            )
        from ..kernels.ops import place_replicas_on_table

        art = self._device_artifact()
        return place_replicas_on_table(
            ids, art.len32_dev, art.node_of_dev, n_replicas,
            top_level=art.top_level, params=self.params,
        )

    def place_replica_nodes(
        self, datum_ids, n_replicas: int, algorithm: str | None = None
    ) -> np.ndarray:
        """(batch, R) node ids, primary first."""
        self._resolve_algorithm(algorithm)
        return self.artifact().node_of[self.place_replicas(datum_ids, n_replicas)]

    # -- device-resident variants (no host sync) -----------------------------

    def place_device(self, datum_ids) -> torch.Tensor:
        """Batch placement -> (batch,) int32 segments on the engine's device.

        Ids already on the device stay there; host ids are uploaded once."""
        from ..kernels.ops import place_on_table_device

        art = self._device_artifact()
        return place_on_table_device(
            datum_ids, art.len32_dev, art.cum_hi_dev, art.cum_lo_dev,
            art.node_of_dev, top_level=art.top_level, params=self.params,
        )

    def place_nodes_device(self, datum_ids, algorithm: str | None = None) -> torch.Tensor:
        """Batch placement -> (batch,) int32 node ids on the engine's device
        (fused seg->node gather, on-device tail)."""
        from ..kernels.ops import place_nodes_on_table_device

        self._resolve_algorithm(algorithm)
        art = self._device_artifact()
        return place_nodes_on_table_device(
            datum_ids, art.len32_dev, art.cum_hi_dev, art.cum_lo_dev,
            art.node_of_dev, top_level=art.top_level, params=self.params,
        )

    def place_replica_nodes_device(
        self, datum_ids, n_replicas: int, algorithm: str | None = None
    ) -> torch.Tensor:
        """(batch, R) int32 node ids on the engine's device, primary first;
        -1 marks unfilled slots (the host variant raises instead)."""
        from ..kernels.ops import place_replicas_on_table_device

        self._resolve_algorithm(algorithm)
        art = self._device_artifact()
        return place_replicas_on_table_device(
            datum_ids, art.len32_dev, art.node_of_dev, n_replicas,
            top_level=art.top_level, params=self.params, emit_nodes=True,
        )

    # -- version-pinned placement (migration windows) ------------------------

    def place_at(self, datum_ids, version: int) -> np.ndarray:
        """Batch placement under a cached table version -> int64 segments
        (tail-resolved): what ``place`` gave while that version was
        current."""
        art = self.artifact_for(version)
        ids = self._host_ids(datum_ids)
        if self.backend == "numpy":
            segs = place_batch_u32(ids, art.len32, art.top_level, self.params)
            return resolve_tail_np(ids, segs, art.len32, art.top_level)
        return self.place_device_at(ids, version).cpu().numpy().astype(np.int64)

    def place_nodes_at(
        self, datum_ids, version: int, algorithm: str | None = None
    ) -> np.ndarray:
        """Batch placement under a cached version -> int64 node ids."""
        self._resolve_algorithm(algorithm)
        if self.backend == "numpy":
            return self.artifact_for(version).node_of[self.place_at(datum_ids, version)]
        ids = self._host_ids(datum_ids)
        return self.place_nodes_device_at(ids, version).cpu().numpy().astype(np.int64)

    def place_replicas_at(self, datum_ids, version: int, n_replicas: int) -> np.ndarray:
        """(batch, R) segment numbers under a cached version, primary
        first (raises when a lane did not find R distinct nodes)."""
        art = self.artifact_for(version)
        ids = self._host_ids(datum_ids)
        if self.backend == "numpy":
            return place_replicas_u32(
                ids, art.len32, art.node_of, n_replicas, art.top_level, self.params
            )
        from ..kernels.ops import place_replicas_on_table

        art = self._device_artifact_for(version)
        return place_replicas_on_table(
            ids, art.len32_dev, art.node_of_dev, n_replicas,
            top_level=art.top_level, params=self.params,
        )

    def place_replica_nodes_at(
        self, datum_ids, version: int, n_replicas: int
    ) -> np.ndarray:
        """(batch, R) node ids under a cached version, primary first -- the
        window's replica read rule places the v+1 sets through this."""
        art = self.artifact_for(version)
        return art.node_of[self.place_replicas_at(datum_ids, version, n_replicas)]

    def remove_numbers_batch(
        self, datum_ids, n_replicas: int, version: int | None = None
    ) -> np.ndarray:
        """Section 2.D REMOVE NUMBERS -> (batch, R) sorted segments: the
        floors of a datum's replica-selecting numbers are its replicas'
        segments, so this is one replica placement plus a row sort."""
        segs = self.place_replicas_at(
            datum_ids, self.cluster.version if version is None else version,
            n_replicas,
        )
        return np.sort(np.asarray(segs, dtype=np.int64), axis=1)

    def place_device_at(self, datum_ids, version: int) -> torch.Tensor:
        """``place_device`` under a cached version (no host sync)."""
        from ..kernels.ops import place_on_table_device

        art = self._device_artifact_for(version)
        return place_on_table_device(
            datum_ids, art.len32_dev, art.cum_hi_dev, art.cum_lo_dev,
            art.node_of_dev, top_level=art.top_level, params=self.params,
        )

    def place_nodes_device_at(
        self, datum_ids, version: int, algorithm: str | None = None
    ) -> torch.Tensor:
        """``place_nodes_device`` under a cached version (no host sync)."""
        from ..kernels.ops import place_nodes_on_table_device

        self._resolve_algorithm(algorithm)
        art = self._device_artifact_for(version)
        return place_nodes_on_table_device(
            datum_ids, art.len32_dev, art.cum_hi_dev, art.cum_lo_dev,
            art.node_of_dev, top_level=art.top_level, params=self.params,
        )

    def place_replica_nodes_device_at(
        self, datum_ids, version: int, n_replicas: int
    ) -> torch.Tensor:
        """``place_replica_nodes_device`` under a cached version (no host
        sync; -1 marks unfilled slots)."""
        from ..kernels.ops import place_replicas_on_table_device

        art = self._device_artifact_for(version)
        return place_replicas_on_table_device(
            datum_ids, art.len32_dev, art.node_of_dev, n_replicas,
            top_level=art.top_level, params=self.params, emit_nodes=True,
        )

    # -- migration planner primitives ----------------------------------------

    def diff_nodes_device(self, datum_ids, v_from: int, v_to: int):
        """Two-version placement diff -> ``(moved, src, dst)`` tensors on the
        engine's device: both cached versions in one launch, no host sync."""
        from ..kernels.ops import diff_nodes_on_tables_device

        a = self._device_artifact_for(v_from)
        b = self._device_artifact_for(v_to)
        return diff_nodes_on_tables_device(
            datum_ids,
            a.len32_dev, a.cum_hi_dev, a.cum_lo_dev, a.node_of_dev,
            b.len32_dev, b.cum_hi_dev, b.cum_lo_dev, b.node_of_dev,
            top_a=a.top_level, top_b=b.top_level, params=self.params,
        )

    def diff_replicas_device(
        self, datum_ids, v_from: int, v_to: int, n_replicas: int
    ):
        """Two-version REPLICA-SET diff -> ``(moved, src, dst, src_slot)``,
        each (batch, R) on the engine's device, no host sync: both sets in
        one launch, then the per-slot alignment (``moved`` iff the slot's
        owner changed; ``src`` the vacated v-side node; ``src_slot`` its
        v-set position)."""
        from ..kernels.ops import diff_replicas_on_tables_device

        a = self._device_artifact_for(v_from)
        b = self._device_artifact_for(v_to)
        return diff_replicas_on_tables_device(
            datum_ids, a.len32_dev, a.node_of_dev, b.len32_dev, b.node_of_dev,
            top_a=a.top_level, top_b=b.top_level, n_replicas=n_replicas,
            params=self.params,
        )

    def diff_replicas_at(
        self, datum_ids, v_from: int, v_to: int, n_replicas: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Host-facing ``diff_replicas_device``: ``(moved, src, dst,
        src_slot)`` as NumPy arrays (int64 nodes).  The numpy backend runs
        both replica sweeps on the host and aligns with the host spec
        (``core.asura.align_replica_sets``)."""
        ids = self._host_ids(datum_ids)
        if self.backend == "numpy":
            before = self.place_replica_nodes_at(ids, v_from, n_replicas)
            after = self.place_replica_nodes_at(ids, v_to, n_replicas)
            moved, src, src_slot = align_replica_sets(before, after)
            return moved, src, after, src_slot
        moved, src, dst, src_slot = self.diff_replicas_device(
            ids, v_from, v_to, n_replicas
        )
        return (
            moved.cpu().numpy(),
            src.cpu().numpy().astype(np.int64),
            dst.cpu().numpy().astype(np.int64),
            src_slot.cpu().numpy(),
        )

    def addition_numbers_device(
        self, datum_ids, version: int | None = None, n_replicas: int = 1
    ) -> torch.Tensor:
        """Section 2.D ADDITION NUMBERs against a cached version (default:
        current) -> (batch,) int32 on the engine's device; -1 means
        "unknown, treat as candidate" (the planner's add-node prefilter)."""
        from ..kernels.ops import addition_numbers_on_table_device

        if version is None:
            version = self.cluster.version
        art = self._device_artifact_for(version)
        return addition_numbers_on_table_device(
            datum_ids, art.len32_dev, art.node_of_dev, top_level=art.top_level,
            n_replicas=n_replicas, params=self.params,
        )
