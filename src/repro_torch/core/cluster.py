"""STEP 1 of ASURA: node <-> segment assignment (paper sections 2.A, 2.D).

The port's own copy of the reference's host-side cluster state: the same
rules, the same ``to_json`` blob (so ``convert.cluster_from_reference_json``
carries a reference cluster across unchanged), and ``.engine`` builds the
port's ``PlacementEngine`` on the cluster's ``device``.

Rules reproduced faithfully:

  1. a node gets segments in proportion to its capacity (one unit of
     capacity = one full-length segment; the fractional remainder becomes a
     shorter segment, as in the paper's Fig. 3 where 1.5 TB -> segment of
     length 1.0 + segment of length 0.5),
  2. existing node <-> segment correspondences never change,
  3. segments start at integer points; the segment number is the start,
  4. segment length is < 1.0 (we use 1.0 - eps for "full" segments so rule 4
     holds exactly),
  5. additions take the smallest free segment number first (section 2.D --
     this ordering is what makes the ADDITION NUMBER scheme exact).

The table is the *only* state ASURA shares cluster-wide: O(N) floats +
node ids, the paper's kilobyte-order memory claim (Table II).
"""

from __future__ import annotations

import dataclasses
import heapq
import json
from typing import Iterable

import numpy as np

from .asura import DEFAULT_PARAMS, AsuraParams, place_scalar

FULL_SEGMENT = (2.0**32 - 1.0) / 2.0**32  # rule 4: strictly under 1.0 (exact in u32)


@dataclasses.dataclass
class NodeInfo:
    node_id: int
    capacity: float
    segments: list[int] = dataclasses.field(default_factory=list)


class Cluster:
    """Mutable segment-table cluster state with ASURA placement methods."""

    def __init__(self, params: AsuraParams = DEFAULT_PARAMS, *, device=None):
        self.params = params
        self.device = device  # where ``.engine`` places (None: the card)
        self.nodes: dict[int, NodeInfo] = {}
        self._seg_lengths: list[float] = []
        self._seg_to_node: list[int] = []
        self._free_segments: list[int] = []  # min-heap of freed numbers
        self._version = 0
        self._engine = None  # lazy PlacementEngine (one table artifact)

    # -- table views -------------------------------------------------------

    @property
    def version(self) -> int:
        return self._version

    @property
    def engine(self):
        """The cluster's PlacementEngine (created on first placement).

        All batched STEP-2 entry points below route through it, so repeated
        placements at one version share a single cached table artifact
        (one host->device upload)."""
        if self._engine is None:
            from .engine import PlacementEngine  # lazy: avoids import cycle

            self._engine = PlacementEngine(self, device=self.device)
        return self._engine

    def seg_lengths(self) -> np.ndarray:
        return np.asarray(self._seg_lengths, dtype=np.float64)

    def seg_to_node(self) -> np.ndarray:
        return np.asarray(self._seg_to_node, dtype=np.int64)

    def total_capacity(self) -> float:
        return float(sum(n.capacity for n in self.nodes.values()))

    def node_ids(self) -> list[int]:
        return sorted(self.nodes)

    def memory_bytes(self) -> int:
        """Paper Table II accounting: 8 bytes per segment entry."""
        return 8 * len(self._seg_lengths)

    # -- STEP 1 mutations ----------------------------------------------------

    def _alloc_segment(self) -> int:
        if self._free_segments:
            return heapq.heappop(self._free_segments)
        self._seg_lengths.append(0.0)
        self._seg_to_node.append(-1)
        return len(self._seg_lengths) - 1

    def add_node(self, node_id: int, capacity: float) -> list[int]:
        """Assign smallest-free-numbered segments totalling ``capacity``."""
        if node_id in self.nodes:
            raise ValueError(f"node {node_id} already present")
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        info = NodeInfo(node_id=node_id, capacity=float(capacity))
        remaining = float(capacity)
        while remaining > 1e-12:
            length = FULL_SEGMENT if remaining >= 1.0 else remaining
            seg = self._alloc_segment()
            self._seg_lengths[seg] = length
            self._seg_to_node[seg] = node_id
            info.segments.append(seg)
            remaining -= 1.0 if remaining >= 1.0 else remaining
        self.nodes[node_id] = info
        self._version += 1
        return info.segments

    def remove_node(self, node_id: int) -> list[int]:
        """Free the node's segments; numbers become reusable (rule 2 keeps
        every *other* node's correspondence intact)."""
        info = self.nodes.pop(node_id, None)
        if info is None:
            raise KeyError(f"node {node_id} not in cluster")
        for seg in info.segments:
            self._seg_lengths[seg] = 0.0
            self._seg_to_node[seg] = -1
            heapq.heappush(self._free_segments, seg)
        self._version += 1
        return info.segments

    def resize_node(self, node_id: int, new_capacity: float) -> None:
        """Grow/shrink a node's capacity with minimal segment churn."""
        info = self.nodes[node_id]
        if new_capacity <= 0:
            raise ValueError("capacity must be positive")
        # Exact no-op test: a sub-epsilon delta must still update the
        # recorded capacity (the 1e-12 guards below keep the segment churn
        # minimal -- a < 2**-32 length gap is invisible to the u32 table --
        # but skipping the bookkeeping lets repeated tiny resizes accumulate
        # unbounded drift between `capacity` and the true target).
        if new_capacity == info.capacity:
            return
        # Rebuild only this node's fractional tail; full segments are kept.
        lengths = [self._seg_lengths[s] for s in info.segments]
        target = float(new_capacity)
        # Shrink: trim from the last (fractional first) segments.
        while sum(lengths) > target + 1e-12:
            excess = sum(lengths) - target
            if lengths[-1] <= excess + 1e-12:
                seg = info.segments.pop()
                lengths.pop()
                self._seg_lengths[seg] = 0.0
                self._seg_to_node[seg] = -1
                heapq.heappush(self._free_segments, seg)
            else:
                lengths[-1] -= excess
                self._seg_lengths[info.segments[-1]] = lengths[-1]
        # Grow: top up the fractional segment then add new ones.
        if lengths and lengths[-1] < FULL_SEGMENT and sum(lengths) < target - 1e-12:
            add = min(FULL_SEGMENT - lengths[-1], target - sum(lengths))
            lengths[-1] += add
            self._seg_lengths[info.segments[-1]] = lengths[-1]
        while sum(lengths) < target - 1e-12:
            rem = target - sum(lengths)
            length = FULL_SEGMENT if rem >= 1.0 else rem
            seg = self._alloc_segment()
            self._seg_lengths[seg] = length
            self._seg_to_node[seg] = node_id
            info.segments.append(seg)
            lengths.append(length)
        info.capacity = float(new_capacity)
        self._version += 1

    # -- STEP 2 placement ----------------------------------------------------

    def place(self, datum_id: int) -> int:
        """Segment number for one datum (scalar oracle path)."""
        return place_scalar(datum_id, self.seg_lengths(), self.params)

    def place_node(self, datum_id: int) -> int:
        return self._seg_to_node[self.place(datum_id)]

    def place_batch(self, datum_ids) -> np.ndarray:
        return self.engine.place(datum_ids)

    def place_nodes(self, datum_ids) -> np.ndarray:
        return self.engine.place_nodes(datum_ids)

    def place_replicas(self, datum_ids, n_replicas: int) -> np.ndarray:
        """(batch, R) node ids, primary first."""
        return self.engine.place_replica_nodes(datum_ids, n_replicas)

    # -- serialization (the small shared table) -----------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": self._version,
                "seg_lengths": self._seg_lengths,
                "seg_to_node": self._seg_to_node,
                "free": sorted(self._free_segments),
                "nodes": {
                    str(nid): {"capacity": info.capacity, "segments": info.segments}
                    for nid, info in self.nodes.items()
                },
                "params": dataclasses.asdict(self.params),
            }
        )

    @classmethod
    def from_json(cls, blob: str, *, device=None) -> "Cluster":
        data = json.loads(blob)
        cluster = cls(params=AsuraParams(**data["params"]), device=device)
        cluster._version = data["version"]
        cluster._seg_lengths = [float(x) for x in data["seg_lengths"]]
        cluster._seg_to_node = [int(x) for x in data["seg_to_node"]]
        cluster._free_segments = list(data["free"])
        heapq.heapify(cluster._free_segments)
        for nid, info in data["nodes"].items():
            cluster.nodes[int(nid)] = NodeInfo(
                node_id=int(nid),
                capacity=float(info["capacity"]),
                segments=[int(s) for s in info["segments"]],
            )
        return cluster


def make_cluster(
    capacities: Iterable[float], params: AsuraParams = DEFAULT_PARAMS, *, device=None
) -> Cluster:
    """Cluster with nodes 0..N-1 of the given capacities."""
    cluster = Cluster(params=params, device=device)
    for i, cap in enumerate(capacities):
        cluster.add_node(i, cap)
    return cluster


def make_uniform_cluster(
    n_nodes: int, params: AsuraParams = DEFAULT_PARAMS, *, device=None
) -> Cluster:
    return make_cluster([1.0] * n_nodes, params=params, device=device)
