"""PlacementEngine: versioned, device-resident table artifacts per cluster.

The port of the reference engine's flat half (ASURA and the paper's
baselines).  For ASURA the engine owns a small LRU of ``TableArtifact``
snapshots keyed by ``Cluster.version``:
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

The engine also serves the paper's comparison baselines (DESIGN.md
section 9): ``algorithm`` selects ``"asura"`` (default), ``"ch"``
(consistent hashing, ``virtual_nodes`` points per node), ``"wrh"``
(capacity-weighted rendezvous hashing) or ``"rs"`` (random slicing).  A
baseline's ``BaselineArtifact`` -- its canonical lookup table and device
copies -- is materialized once per (algorithm, version) and cached in a
PER-ALGORITHM LRU keyed on version, so an ASURA upload never evicts a
baseline artifact or the reverse; ``place_nodes``,
``place_replica_nodes``, their ``_device`` and ``*_at`` variants and
``artifact_for`` dispatch on the algorithm (per call with
``algorithm=``).  Random slicing is history-dependent: the engine carries
one interval table forward (``rebalance`` once per version it builds, in
version order), and an evicted version is never rebuilt.  The
segment-table methods (``place``, ``place_replicas``, the diffs, ...)
are ASURA-only and raise ``ValueError`` on a baseline engine.

A ``HierarchicalCluster`` (``is_hierarchical``) switches the engine into
the failure-domain-aware mode (ASURA only): a ``HierArtifact`` per
version -- both levels' tables in kernel B8's layout -- behind the same
LRU and ``uploads`` counter; ``place_replica_pairs[_device]`` return
(domain, node) replica sets with pairwise-distinct domains,
``diff_replica_domains_device`` diffs both levels, and ``place_nodes*``,
``place_replica_nodes*``, ``diff_replicas_device`` and
``diff_replicas_at`` dispatch to the two-level path.  Flat segment-table
methods raise ``ValueError`` in this mode.  The backend does not pick the
two-level route: every two-level call goes through B8's wrapper, which
launches the kernel for tables on the card and runs its plain-torch twin
for tables on the CPU.

``sharded()`` returns the engine's multi-card sweep
(``launch.placement_mesh.ShardedSweep``) over a ``torch.distributed``
group.

The engine is duck-typed on the cluster (``version``, ``params``,
``seg_lengths()``, ``seg_to_node()``; the baselines also read ``nodes``).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.u32 import as_u32
from ..obs.trace import TraceLedger, maybe_span
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
from .consistent_hashing import build_ring
from .random_slicing import RandomSlicingTable

BACKENDS = ("device", "numpy")

ALGORITHMS = ("asura", "ch", "wrh", "rs")

CACHE_VERSIONS = 4  # most-recent table versions kept materialized per algorithm

DEFAULT_VIRTUAL_NODES = 100  # the paper's CH evaluation setting


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


@dataclasses.dataclass(frozen=True)
class BaselineArtifact:
    """Immutable snapshot of one baseline algorithm's lookup table at one
    cluster version.

    ``keys`` / ``vals`` are the host canonical arrays:

      * ``ch``  -- keys = sorted u32 ring hashes, vals = int32 owners,
      * ``rs``  -- keys = u32 interval starts (first 0), vals = int32 owners,
      * ``wrh`` -- keys = u32 node ids, vals = float32 capacity weights.

    ``keys_dev`` / ``vals_dev`` are the lane-padded device tables the
    kernels read (``kernels.baselines.*_table_prep``; for ``wrh`` the salts
    and reciprocals), None until a device path needs them."""

    algorithm: str
    version: int
    n_entries: int
    keys: np.ndarray
    vals: np.ndarray
    keys_dev: Any = None
    vals_dev: Any = None

    @property
    def has_device_tables(self) -> bool:
        return self.keys_dev is not None

    def memory_bytes(self) -> int:
        """Table-II accounting: 8 bytes per lookup entry (key + value)."""
        return 8 * self.n_entries


@dataclasses.dataclass(frozen=True)
class HierArtifact:
    """Immutable snapshot of one HIERARCHICAL cluster version.

    The device view of both levels: the domain-level segment table (node
    ids re-mapped to dense domain SLOTS, so the section-5.A distinct-node
    test is a distinct-domain test), the D per-domain tables stacked into
    flat ``(D * s_pad,)`` arrays (lengths zero-padded, node map -1-padded,
    u64-cumsum halves carried at each domain's total), and the per-domain
    top levels and domain ids.  ``tables_dev`` is the eight-tuple in the
    kernel's operand order (``kernels.hierarchy.hier_tables_prep``).  Node
    ids are validated globally unique at build time; ``node_domain`` is
    the host's node -> domain view."""

    version: int
    n_domains: int
    top_level: int
    max_top: int
    s_pad: int
    domain_ids: np.ndarray
    node_domain: dict
    tables_dev: tuple

    @property
    def statics(self) -> tuple:
        return (self.top_level, self.max_top, self.s_pad)


def with_baseline_device_tables(art: BaselineArtifact, device) -> BaselineArtifact:
    """``art`` with its lane-padded device tables (one host->device upload)."""
    from ..kernels.baselines import TABLE_PREP

    with maybe_span(None, "engine.ring_upload"):
        keys_dev, vals_dev = TABLE_PREP[art.algorithm](art.keys, art.vals, device=device)
        return dataclasses.replace(art, keys_dev=keys_dev, vals_dev=vals_dev)


def _check_algorithm(algorithm: str) -> str:
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}")
    return algorithm


def with_device_tables(art: TableArtifact, device) -> TableArtifact:
    """``art`` with its device copies filled (one host->device upload)."""
    from ..kernels.ops import node_table_prep, tail_prep

    with maybe_span(None, "engine.tables_upload"):
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
        virtual_nodes: int = DEFAULT_VIRTUAL_NODES,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.algorithm = _check_algorithm(algorithm)
        self.hierarchical = bool(getattr(cluster, "is_hierarchical", False))
        if self.hierarchical and algorithm != "asura":
            raise ValueError(
                "hierarchical placement is ASURA-only (two-level segment "
                f"tables); got algorithm={algorithm!r}"
            )
        self.cluster = cluster
        self.params: AsuraParams = getattr(cluster, "params", DEFAULT_PARAMS)
        self.device = resolve_device(device)
        self.backend = backend
        self._virtual_nodes = int(virtual_nodes)
        # algorithm -> (version -> artifact, most recently used last)
        self._artifacts: dict[str, OrderedDict[int, Any]] = {}
        # random slicing is history-dependent: one interval table carried
        # forward, rebalanced once per version the engine builds
        self._rs_shadow: RandomSlicingTable | None = None
        # instance-scoped so the exact upload tripwire never aliases
        self.ledger = TraceLedger()
        self._default_sweep = None

    def _resolve_algorithm(self, algorithm: str | None) -> str:
        """``algorithm``, or the engine's own when None (checked)."""
        return self.algorithm if algorithm is None else _check_algorithm(algorithm)

    def _require_asura(self, method: str) -> None:
        if self.algorithm != "asura":
            raise ValueError(
                f"{method} is segment-table semantics, ASURA-only; this "
                f"engine's algorithm is {self.algorithm!r} -- use "
                "place_nodes / place_nodes_device (they dispatch per "
                "algorithm)"
            )
        if self.hierarchical:
            raise ValueError(
                f"{method} is flat-table semantics; this engine is bound to "
                "a HierarchicalCluster -- use place_nodes / "
                "place_replica_nodes / place_replica_pairs[_device] / "
                "diff_replica{s,_domains}_device (the two-level paths)"
            )

    def _require_hier(self, method: str) -> None:
        if not self.hierarchical:
            raise ValueError(
                f"{method} needs a HierarchicalCluster-bound engine; this "
                "engine's cluster is flat"
            )

    @property
    def uploads(self) -> int:
        """Table materializations (one per (algorithm, version)) -- a
        ledger counter."""
        return self.ledger.counter("engine.uploads")

    # -- artifact lifecycle --------------------------------------------------

    def _cache(self, algorithm: str) -> OrderedDict:
        return self._artifacts.setdefault(algorithm, OrderedDict())

    def _store(self, algorithm: str, art) -> None:
        cache = self._cache(algorithm)
        cache[art.version] = art
        while len(cache) > CACHE_VERSIONS:
            evicted, _ = cache.popitem(last=False)
            self.ledger.incr("engine.lru_evictions")
            self.ledger.event("engine.lru_evict", algorithm, version=evicted)

    def _current(self, key: str, build):
        """The current version's artifact in the ``key`` LRU, built by
        ``build(version)`` (and uploaded) only when it is not cached."""
        version = self.cluster.version
        cache = self._cache(key)
        art = cache.get(version)
        if art is not None:
            cache.move_to_end(version)
            return art
        with self.ledger.span("engine.build_artifact", algorithm=key,
                              version=version):
            art = build(version)
        self._store(key, art)
        self.ledger.incr("engine.uploads")
        n_segs = art.n_domains if key == "hier" else getattr(art, "n_segs", None)
        self.ledger.event("engine.upload", key, version=version, n_segs=n_segs)
        return art

    def _pinned(self, key: str, version: int, current):
        """A SPECIFIC version's artifact in the ``key`` LRU: ``current()``
        for the current version, else the cached one.  An evicted version
        cannot be rebuilt -- the cluster has moved on, and random slicing's
        table is history-dependent -- so this raises ``KeyError`` rather
        than re-deriving the wrong table."""
        if version == self.cluster.version:
            return current()
        cache = self._cache(key)
        art = cache.get(version)
        if art is None:
            raise KeyError(
                f"{key} table version {version} not cached (LRU holds "
                f"{list(cache)}); place at that version before mutating"
            )
        cache.move_to_end(version)
        return art

    def artifact(self, algorithm: str | None = None):
        """The current version's table under ``algorithm`` (default: the
        engine's own), rebuilt (and re-uploaded) only when ``(algorithm,
        cluster.version)`` is not among the cached artifacts."""
        alg = self._resolve_algorithm(algorithm)
        if alg == "asura":
            return self._current(alg, self._build_asura_artifact)
        return self._current(alg, lambda v: self._build_baseline_artifact(alg, v))

    def _build_asura_artifact(self, version: int) -> TableArtifact:
        with maybe_span(None, "engine.tables_host"):
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
        return art

    def _node_weights(self) -> dict[int, float]:
        nodes = getattr(self.cluster, "nodes", None)
        if nodes is None:
            raise TypeError(
                "baseline algorithms need a cluster exposing `.nodes` "
                "(node_id -> NodeInfo); this cluster is table-only"
            )
        return {int(nid): float(info.capacity) for nid, info in nodes.items()}

    def _build_baseline_artifact(self, alg: str, version: int) -> BaselineArtifact:
        weights = self._node_weights()
        node_ids = sorted(weights)
        if alg == "ch":
            # the paper's CH setup: V virtual nodes per node, unweighted
            with maybe_span(None, "engine.ring_host"):
                keys, vals = build_ring(node_ids, self._virtual_nodes)
                vals = vals.astype(np.int32)
        elif alg == "wrh":
            keys = np.asarray(node_ids, dtype=np.uint32)
            vals = np.asarray([weights[n] for n in node_ids], dtype=np.float32)
        else:  # rs: carry the interval table forward to this version
            if self._rs_shadow is None:
                self._rs_shadow = RandomSlicingTable()
            self._rs_shadow.rebalance(weights)
            keys, vals = self._rs_shadow.starts_owners()
        art = BaselineArtifact(
            algorithm=alg, version=version, n_entries=int(keys.shape[0]),
            keys=keys, vals=vals,
        )
        if self.backend == "device":
            art = with_baseline_device_tables(art, self.device)
        return art

    def _with_device_tables(self, alg: str, art):
        """``art`` with device tables; on the numpy backend they are built
        on the first ``*_device`` call, as part of the same version's one
        materialization (``uploads`` does not tick again)."""
        if not art.has_device_tables:
            if alg == "asura":
                art = with_device_tables(art, self.device)
            else:
                art = with_baseline_device_tables(art, self.device)
            self._cache(alg)[art.version] = art
        return art

    def _device_artifact(self, algorithm: str | None = None):
        """``artifact()`` with device tables (same materialization)."""
        alg = self._resolve_algorithm(algorithm)
        return self._with_device_tables(alg, self.artifact(alg))

    def artifact_for(self, version: int, algorithm: str | None = None):
        """The table artifact of a SPECIFIC version (migration windows,
        baseline movement accounting).

        The current version is built on demand; any other version must
        still be in the algorithm's LRU (place at it before mutating the
        cluster), else ``KeyError``."""
        alg = self._resolve_algorithm(algorithm)
        return self._pinned(alg, version, lambda: self.artifact(alg))

    def _device_artifact_for(self, version: int, algorithm: str | None = None):
        """``artifact_for`` with device tables (same materialization)."""
        alg = self._resolve_algorithm(algorithm)
        return self._with_device_tables(alg, self.artifact_for(version, alg))

    def invalidate(self) -> None:
        """Drop every cached artifact, all algorithms (the next placement
        rebuilds and uploads)."""
        self._artifacts.clear()

    # -- hierarchical artifacts ----------------------------------------------

    def _build_hier_artifact(self, version: int) -> HierArtifact:
        from ..kernels.hierarchy import hier_tables_prep

        h = self.cluster
        top = h._top
        lengths = np.asarray(top.seg_lengths(), dtype=np.float64)
        node_domain = h.node_domains()  # validates global node-id uniqueness
        domain_ids = np.asarray(sorted(int(d) for d in top.nodes), dtype=np.int64)
        slot_of = {int(d): i for i, d in enumerate(domain_ids)}
        top_slot = [slot_of[int(d)] if d >= 0 else -1 for d in top.seg_to_node()]
        dom_lens, dom_nodes, dom_tops = [], [], []
        for d in domain_ids:
            dom = h.domains[int(d)]
            dl = np.asarray(dom.seg_lengths(), dtype=np.float64)
            dom_tops.append(self.params.level_for(_upper_bound(dl)))
            dom_lens.append(lengths_to_u32(dl))
            dom_nodes.append(dom.seg_to_node())
        tables, s_pad = hier_tables_prep(
            lengths_to_u32(lengths), top_slot, dom_lens, dom_nodes, dom_tops,
            domain_ids, device=self.device,
        )
        return HierArtifact(
            version=version,
            n_domains=len(domain_ids),
            top_level=self.params.level_for(_upper_bound(lengths)),
            max_top=int(max(dom_tops)),
            s_pad=s_pad,
            domain_ids=domain_ids,
            node_domain=node_domain,
            tables_dev=tables,
        )

    def hier_artifact(self) -> HierArtifact:
        """The current version's two-level artifact (the same versioned LRU,
        upload counter and eviction events as the flat artifacts)."""
        self._require_hier("hier_artifact")
        return self._current("hier", self._build_hier_artifact)

    def hier_artifact_for(self, version: int) -> HierArtifact:
        """A SPECIFIC version's two-level artifact: the current one is built
        on demand, any other must still be in the LRU (``KeyError``
        otherwise, as ``artifact_for``)."""
        self._require_hier("hier_artifact_for")
        return self._pinned("hier", version, self.hier_artifact)

    def _hier_kwargs(self, art: HierArtifact, n_replicas: int) -> dict:
        return dict(
            top_level=art.top_level, max_top=art.max_top, s_pad=art.s_pad,
            n_replicas=n_replicas, params=self.params,
        )

    def _hier_at(self, version: int | None) -> HierArtifact:
        return self.hier_artifact() if version is None else self.hier_artifact_for(version)

    def place_replica_pairs_device(
        self, datum_ids, n_replicas: int, version: int | None = None
    ) -> torch.Tensor:
        """Two-level replication -> (2, R, batch) int32 on the engine's
        device (plane 0 domains, plane 1 nodes), no host sync; -1 marks
        slots whose distinct-domain draw did not converge.  ``version``
        pins a cached table version (default: current)."""
        from ..kernels.ops import hier_place_replicas_on_tables_device

        self._require_hier("place_replica_pairs_device")
        art = self._hier_at(version)
        return hier_place_replicas_on_tables_device(
            datum_ids, art.tables_dev, **self._hier_kwargs(art, n_replicas)
        )

    def place_replica_pairs(
        self, datum_ids, n_replicas: int, version: int | None = None
    ) -> np.ndarray:
        """Host-facing two-level replication -> (batch, R, 2) int64
        ``(domain_id, node_id)`` pairs with pairwise-DISTINCT domains,
        primary first -- equal to the ``HierarchicalCluster`` oracle.
        Raises ``RuntimeError`` if the distinct-domain draw did not
        converge."""
        from ..kernels.ops import hier_place_replicas_on_tables

        self._require_hier("place_replica_pairs")
        art = self._hier_at(version)
        return hier_place_replicas_on_tables(
            self._host_ids(datum_ids), art.tables_dev,
            **self._hier_kwargs(art, n_replicas),
        )

    def diff_replica_domains_device(
        self, datum_ids, v_from: int, v_to: int, n_replicas: int
    ):
        """Two-level replica diff with the domain planes -> ``(moved, src,
        dst, src_slot, src_dom, dst_dom)``, each (batch, R) on the engine's
        device, no host sync.  Both levels of both versions are placed by
        B8; the alignment runs on the node plane and the domains ride
        along."""
        from ..kernels.ops import hier_diff_replicas_on_tables_device

        self._require_hier("diff_replica_domains_device")
        a = self.hier_artifact_for(v_from)
        b = self.hier_artifact_for(v_to)
        return hier_diff_replicas_on_tables_device(
            datum_ids, a.tables_dev, b.tables_dev, statics_a=a.statics,
            statics_b=b.statics, n_replicas=n_replicas, params=self.params,
        )

    # -- host-facing STEP 2 --------------------------------------------------

    @staticmethod
    def _host_ids(datum_ids) -> np.ndarray:
        if isinstance(datum_ids, torch.Tensor):
            return as_u32(datum_ids).cpu().numpy().astype(np.uint32)
        return np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))

    def place(self, datum_ids) -> np.ndarray:
        """Batch placement -> int64 segment numbers (tail-resolved, total)."""
        self._require_asura("place")
        art = self.artifact("asura")
        ids = self._host_ids(datum_ids)
        if self.backend == "numpy":
            segs = place_batch_u32(ids, art.len32, art.top_level, self.params)
            return resolve_tail_np(ids, segs, art.len32, art.top_level)
        return self.place_device(ids).cpu().numpy().astype(np.int64)

    def _baseline_nodes(self, alg: str, art, ids: np.ndarray) -> np.ndarray:
        """One baseline lookup of host ids against ``art`` -> int64 nodes."""
        from ..kernels.baselines import ORACLES
        from ..kernels.ops import baseline_place_on_table

        if self.backend == "numpy":
            return ORACLES[alg](ids, art.keys, art.vals)
        art = self._with_device_tables(alg, art)
        return baseline_place_on_table(alg, ids, art.keys_dev, art.vals_dev)

    def place_nodes(self, datum_ids, algorithm: str | None = None) -> np.ndarray:
        """Batch placement -> int64 node ids (dispatches on ``algorithm``;
        a hierarchical engine gives each id's primary node)."""
        alg = self._resolve_algorithm(algorithm)
        if self.hierarchical:
            return self.place_replica_pairs(datum_ids, 1)[:, 0, 1]
        ids = self._host_ids(datum_ids)
        if alg != "asura":
            return self._baseline_nodes(alg, self.artifact(alg), ids)
        if self.backend == "numpy":
            art = self.artifact("asura")
            segs = place_batch_u32(ids, art.len32, art.top_level, self.params)
            return art.node_of[resolve_tail_np(ids, segs, art.len32, art.top_level)]
        return self.place_nodes_device(ids, "asura").cpu().numpy().astype(np.int64)

    def place_replicas(self, datum_ids, n_replicas: int) -> np.ndarray:
        """(batch, R) segment numbers on R distinct nodes, primary first."""
        self._require_asura("place_replicas")
        art = self.artifact("asura")
        ids = self._host_ids(datum_ids)
        if self.backend == "numpy":
            return place_replicas_u32(
                ids, art.len32, art.node_of, n_replicas, art.top_level, self.params
            )
        from ..kernels.ops import place_replicas_on_table

        art = self._device_artifact("asura")
        return place_replicas_on_table(
            ids, art.len32_dev, art.node_of_dev, n_replicas,
            top_level=art.top_level, params=self.params,
        )

    def place_replica_nodes(
        self, datum_ids, n_replicas: int, algorithm: str | None = None
    ) -> np.ndarray:
        """(batch, R) node ids, primary first (dispatches on ``algorithm``:
        ASURA's section-5.A distinct-node draw, or the baselines' salted
        rejection fan-out, which raises ``ValueError`` when a slot stays
        unfilled).  Hierarchical engines return (batch, R, 2) ``(domain,
        node)`` pairs instead, as ``place_replica_pairs``."""
        alg = self._resolve_algorithm(algorithm)
        if self.hierarchical:
            return self.place_replica_pairs(datum_ids, n_replicas)
        if alg == "asura":
            return self.artifact("asura").node_of[self.place_replicas(datum_ids, n_replicas)]
        art = self.artifact(alg)
        ids = self._host_ids(datum_ids)
        if self.backend == "numpy":
            from ..kernels.baselines import baseline_place_replicas_np

            out = baseline_place_replicas_np(alg, ids, art.keys, art.vals, n_replicas)
        else:
            out = self.place_replica_nodes_device(ids, n_replicas, alg)
            out = out.cpu().numpy().astype(np.int64)
        if n_replicas > 1 and (out < 0).any():
            raise ValueError(
                f"{alg} replica fan-out found no {n_replicas} distinct "
                "nodes within the try budget (R exceeds live nodes?)"
            )
        return out

    # -- device-resident variants (no host sync) -----------------------------

    def place_device(self, datum_ids) -> torch.Tensor:
        """Batch placement -> (batch,) int32 segments on the engine's device.

        Ids already on the device stay there; host ids are uploaded once."""
        from ..kernels.ops import place_on_table_device

        self._require_asura("place_device")
        art = self._device_artifact("asura")
        return place_on_table_device(
            datum_ids, art.len32_dev, art.cum_hi_dev, art.cum_lo_dev,
            art.node_of_dev, top_level=art.top_level, params=self.params,
        )

    def _nodes_device(self, alg: str, art, datum_ids) -> torch.Tensor:
        """One placement launch against a device artifact -> int32 nodes."""
        from ..kernels.ops import baseline_place_on_table_device, place_nodes_on_table_device

        if alg != "asura":
            return baseline_place_on_table_device(alg, datum_ids, art.keys_dev, art.vals_dev)
        return place_nodes_on_table_device(
            datum_ids, art.len32_dev, art.cum_hi_dev, art.cum_lo_dev,
            art.node_of_dev, top_level=art.top_level, params=self.params,
        )

    def place_nodes_device(self, datum_ids, algorithm: str | None = None) -> torch.Tensor:
        """Batch placement -> (batch,) int32 node ids on the engine's device,
        no host sync (dispatches on ``algorithm``: ASURA's fused seg->node
        gather with the on-device tail, or a baseline's lookup kernel; a
        hierarchical engine gives the primary's node plane)."""
        alg = self._resolve_algorithm(algorithm)
        if self.hierarchical:
            return self.place_replica_pairs_device(datum_ids, 1)[1, 0, :]
        return self._nodes_device(alg, self._device_artifact(alg), datum_ids)

    def place_replica_nodes_device(
        self, datum_ids, n_replicas: int, algorithm: str | None = None
    ) -> torch.Tensor:
        """(batch, R) int32 node ids on the engine's device, primary first,
        no host sync (dispatches on ``algorithm``); -1 marks unfilled slots
        (the host variant raises instead).  Hierarchical engines return the
        (2, R, batch) planes of ``place_replica_pairs_device``."""
        from ..kernels.ops import (
            baseline_place_replicas_on_table_device,
            place_replicas_on_table_device,
        )

        alg = self._resolve_algorithm(algorithm)
        if self.hierarchical:
            return self.place_replica_pairs_device(datum_ids, n_replicas)
        art = self._device_artifact(alg)
        if alg != "asura":
            with maybe_span(None, "engine.baseline_replicas"):
                return baseline_place_replicas_on_table_device(
                    alg, datum_ids, art.keys_dev, art.vals_dev, n_replicas=n_replicas,
                )
        return place_replicas_on_table_device(
            datum_ids, art.len32_dev, art.node_of_dev, n_replicas,
            top_level=art.top_level, params=self.params, emit_nodes=True,
        )

    # -- version-pinned placement (migration windows) ------------------------

    def place_at(self, datum_ids, version: int) -> np.ndarray:
        """Batch placement under a cached table version -> int64 segments
        (tail-resolved): what ``place`` gave while that version was
        current."""
        self._require_asura("place_at")
        art = self.artifact_for(version, "asura")
        ids = self._host_ids(datum_ids)
        if self.backend == "numpy":
            segs = place_batch_u32(ids, art.len32, art.top_level, self.params)
            return resolve_tail_np(ids, segs, art.len32, art.top_level)
        return self.place_device_at(ids, version).cpu().numpy().astype(np.int64)

    def place_nodes_at(
        self, datum_ids, version: int, algorithm: str | None = None
    ) -> np.ndarray:
        """Batch placement under a cached version -> int64 node ids
        (dispatches on ``algorithm``: the baselines' movement accounting
        diffs owners across two cached versions with it)."""
        alg = self._resolve_algorithm(algorithm)
        if self.hierarchical:
            return self.place_replica_pairs(datum_ids, 1, version)[:, 0, 1]
        ids = self._host_ids(datum_ids)
        if alg != "asura":
            return self._baseline_nodes(alg, self.artifact_for(version, alg), ids)
        if self.backend == "numpy":
            art = self.artifact_for(version, "asura")
            segs = place_batch_u32(ids, art.len32, art.top_level, self.params)
            return art.node_of[resolve_tail_np(ids, segs, art.len32, art.top_level)]
        return self.place_nodes_device_at(ids, version, "asura").cpu().numpy().astype(np.int64)

    def place_replicas_at(self, datum_ids, version: int, n_replicas: int) -> np.ndarray:
        """(batch, R) segment numbers under a cached version, primary
        first (raises when a lane did not find R distinct nodes)."""
        self._require_asura("place_replicas_at")
        art = self.artifact_for(version, "asura")
        ids = self._host_ids(datum_ids)
        if self.backend == "numpy":
            return place_replicas_u32(
                ids, art.len32, art.node_of, n_replicas, art.top_level, self.params
            )
        from ..kernels.ops import place_replicas_on_table

        art = self._device_artifact_for(version, "asura")
        return place_replicas_on_table(
            ids, art.len32_dev, art.node_of_dev, n_replicas,
            top_level=art.top_level, params=self.params,
        )

    def place_replica_nodes_at(
        self, datum_ids, version: int, n_replicas: int
    ) -> np.ndarray:
        """(batch, R) node ids under a cached version, primary first -- the
        window's replica read rule places the v+1 sets through this.
        Hierarchical engines return (batch, R, 2) pairs."""
        if self.hierarchical:
            return self.place_replica_pairs(datum_ids, n_replicas, version)
        self._require_asura("place_replica_nodes_at")
        art = self.artifact_for(version, "asura")
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

        self._require_asura("place_device_at")
        art = self._device_artifact_for(version, "asura")
        return place_on_table_device(
            datum_ids, art.len32_dev, art.cum_hi_dev, art.cum_lo_dev,
            art.node_of_dev, top_level=art.top_level, params=self.params,
        )

    def place_nodes_device_at(
        self, datum_ids, version: int, algorithm: str | None = None
    ) -> torch.Tensor:
        """``place_nodes_device`` under a cached version (no host sync)."""
        alg = self._resolve_algorithm(algorithm)
        if self.hierarchical:
            return self.place_replica_pairs_device(datum_ids, 1, version)[1, 0, :]
        return self._nodes_device(alg, self._device_artifact_for(version, alg), datum_ids)

    def place_replica_nodes_device_at(
        self, datum_ids, version: int, n_replicas: int
    ) -> torch.Tensor:
        """``place_replica_nodes_device`` under a cached version (no host
        sync; -1 marks unfilled slots; hierarchical engines: the pair
        planes)."""
        from ..kernels.ops import place_replicas_on_table_device

        if self.hierarchical:
            return self.place_replica_pairs_device(datum_ids, n_replicas, version)
        self._require_asura("place_replica_nodes_device_at")
        art = self._device_artifact_for(version, "asura")
        return place_replicas_on_table_device(
            datum_ids, art.len32_dev, art.node_of_dev, n_replicas,
            top_level=art.top_level, params=self.params, emit_nodes=True,
        )

    # -- migration planner primitives ----------------------------------------

    def diff_nodes_device(self, datum_ids, v_from: int, v_to: int):
        """Two-version placement diff -> ``(moved, src, dst)`` tensors on the
        engine's device: both cached versions in one launch, no host sync."""
        from ..kernels.ops import diff_nodes_on_tables_device

        self._require_asura("diff_nodes_device")
        a = self._device_artifact_for(v_from, "asura")
        b = self._device_artifact_for(v_to, "asura")
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
        each (batch, R) on the engine's device, no host sync: both sets and
        their per-slot alignment in one launch (``moved`` iff the slot's
        owner changed; ``src`` the vacated v-side node; ``src_slot`` its
        v-set position).  Hierarchical engines diff the NODE planes of the
        two-level placement (node ids are globally unique);
        ``diff_replica_domains_device`` adds the domain planes."""
        from ..kernels.ops import diff_replicas_on_tables_device

        if self.hierarchical:
            return self.diff_replica_domains_device(datum_ids, v_from, v_to, n_replicas)[:4]
        self._require_asura("diff_replicas_device")
        a = self._device_artifact_for(v_from, "asura")
        b = self._device_artifact_for(v_to, "asura")
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
        (``core.asura.align_replica_sets``); a hierarchical engine always
        runs the two-level diff through B8's wrapper."""
        if not self.hierarchical:
            self._require_asura("diff_replicas_at")
        ids = self._host_ids(datum_ids)
        if self.backend == "numpy" and not self.hierarchical:
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

    def sharded(self, mesh=None):
        """A ``ShardedSweep`` running this engine's bulk sweeps over a
        ``torch.distributed`` mesh (DESIGN.md section 11): the id stream
        split over the ranks, every rank's own tables, histograms /
        movement matrices / moved counts merged by one all-reduce -- equal
        to the single-card ``*_device`` paths bit for bit.

        ``mesh=None`` spans the whole process group; that sweep is cached,
        and an explicit mesh gets a fresh sweep."""
        from ..launch.placement_mesh import ShardedSweep

        if mesh is not None:
            return ShardedSweep(self, mesh)
        if self._default_sweep is None:
            self._default_sweep = ShardedSweep(self)
        return self._default_sweep

    def addition_numbers_device(
        self, datum_ids, version: int | None = None, n_replicas: int = 1
    ) -> torch.Tensor:
        """Section 2.D ADDITION NUMBERs against a cached version (default:
        current) -> (batch,) int32 on the engine's device, one kernel
        launch and no host sync; -1 means "unknown, treat as candidate"
        (the planner's add-node prefilter)."""
        from ..kernels.ops import addition_numbers_on_table_device

        self._require_asura("addition_numbers_device")
        if version is None:
            version = self.cluster.version
        art = self._device_artifact_for(version, "asura")
        return addition_numbers_on_table_device(
            datum_ids, art.len32_dev, art.node_of_dev, top_level=art.top_level,
            n_replicas=n_replicas, params=self.params,
        )
