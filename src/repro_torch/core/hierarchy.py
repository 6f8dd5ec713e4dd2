"""Hierarchical ASURA: failure-domain-aware placement (beyond the paper).

The port's own copy of the reference's two-level cluster.  Production
storage needs replica separation across failure domains (racks, pods,
zones); ASURA is composed with itself:

  level 1: a cluster of DOMAINS, each domain's capacity = the sum of its
           nodes' capacities -> the first R distinct-domain hits pick the
           replica domains (paper section 5.A semantics, applied to
           domains),
  level 2: within each chosen domain, an independent ASURA cluster over
           its nodes places the datum (the datum id is salted with the
           domain id, so placements are independent across domains).

Inherited properties: replicas land on R distinct domains (losing a whole
domain loses at most one replica of any datum); load is proportional to
domain capacity and to node capacity within a domain; movement optimality
composes -- adding or removing a NODE moves only data within its domain,
adding or removing a DOMAIN moves only the data it wins or held.

``place`` / ``place_replicas`` are the NumPy oracles (the per-domain host
loop); ``.engine`` is the hierarchical ``PlacementEngine`` on ``device``,
which runs both levels for a whole batch in one launch of kernel B8.
"""

from __future__ import annotations

import numpy as np

from .asura import DEFAULT_PARAMS, AsuraParams, place_batch, place_replicas_batch
from .cluster import Cluster
from .rng import GOLDEN, fmix32_np


class HierarchicalCluster:
    """Two-level ASURA: domains (racks / pods) -> nodes.

    Carries a monotonic ``version`` (bumped by every membership mutation)
    and a lazy ``engine`` built on ``device`` (None: the card), as
    ``Cluster`` does, so the engine keys its two-level artifacts off it."""

    is_hierarchical = True

    def __init__(self, params: AsuraParams = DEFAULT_PARAMS, *, device=None):
        self.params = params
        self.device = device
        self.domains: dict[int, Cluster] = {}
        self._top = Cluster(params=params, device=device)
        self._version = 0
        self._engine = None  # lazy hierarchical PlacementEngine

    @property
    def version(self) -> int:
        return self._version

    @property
    def engine(self):
        """The cluster's hierarchical PlacementEngine (created on first use)."""
        if self._engine is None:
            from .engine import PlacementEngine  # lazy: avoids an import cycle

            self._engine = PlacementEngine(self, device=self.device)
        return self._engine

    # -- membership ----------------------------------------------------------

    def add_domain(self, domain_id: int) -> None:
        if domain_id in self.domains:
            raise ValueError(f"domain {domain_id} exists")
        self.domains[domain_id] = Cluster(params=self.params, device=self.device)
        self._version += 1

    def add_node(self, domain_id: int, node_id: int, capacity: float) -> None:
        if domain_id not in self.domains:
            self.add_domain(domain_id)
        self.domains[domain_id].add_node(node_id, capacity)
        self._sync_domain(domain_id)
        self._version += 1

    def remove_node(self, domain_id: int, node_id: int) -> None:
        self.domains[domain_id].remove_node(node_id)
        self._sync_domain(domain_id)
        self._version += 1

    def remove_domain(self, domain_id: int) -> None:
        del self.domains[domain_id]
        self._top.remove_node(domain_id)
        self._version += 1

    def _sync_domain(self, domain_id: int) -> None:
        """Keep the top-level capacity EXACTLY equal to the domain's node sum.

        Compares against the top cluster's recorded capacity, with no
        tolerance: a tolerance would let repeated sub-epsilon churn drift
        ``_top`` away from the true sum, each step under it, the total
        not."""
        now = self.domains[domain_id].total_capacity()
        info = self._top.nodes.get(domain_id)
        if info is None:
            if now > 0:
                self._top.add_node(domain_id, now)
        elif now == 0:
            self._top.remove_node(domain_id)
        elif now != info.capacity:
            self._top.resize_node(domain_id, now)

    def node_domains(self) -> dict[int, int]:
        """node_id -> domain_id over every node in the hierarchy.

        The engine's hierarchical mode needs node ids GLOBALLY unique
        across domains (replica diffs, movers and the serving path keep a
        flat node-id space); this is the validation view."""
        out: dict[int, int] = {}
        for did, dom in self.domains.items():
            for nid in dom.nodes:
                if nid in out:
                    raise ValueError(
                        f"node id {nid} appears in domains {out[nid]} and "
                        f"{did}; hierarchical placement requires globally "
                        "unique node ids"
                    )
                out[nid] = did
        return out

    # -- placement (NumPy oracles) -------------------------------------------

    def _salt(self, ids: np.ndarray, domain_id: int) -> np.ndarray:
        with np.errstate(over="ignore"):
            return fmix32_np(
                ids.astype(np.uint32) ^ np.uint32((domain_id * GOLDEN) & 0xFFFFFFFF)
            )

    @staticmethod
    def _nodes_of(cluster: Cluster, ids: np.ndarray) -> np.ndarray:
        segs = place_batch(ids, cluster.seg_lengths(), cluster.params)
        return cluster.seg_to_node()[segs]

    def place(self, datum_ids) -> np.ndarray:
        """(batch,) -> (domain_id, node_id) pairs, shape (batch, 2)."""
        ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
        dom_of = self._nodes_of(self._top, ids)
        out = np.empty((ids.size, 2), dtype=np.int64)
        out[:, 0] = dom_of
        for d in np.unique(dom_of):
            rows = dom_of == d
            out[rows, 1] = self._nodes_of(self.domains[int(d)], self._salt(ids[rows], int(d)))
        return out

    def place_replicas(self, datum_ids, n_replicas: int) -> np.ndarray:
        """(batch, R, 2): R replicas on R DISTINCT domains, primary first.
        Raises ``RuntimeError`` when there are fewer than R domains."""
        ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
        top = self._top
        segs = place_replicas_batch(
            ids, top.seg_lengths(), top.seg_to_node(), n_replicas, top.params
        )
        dom_reps = top.seg_to_node()[segs]  # (batch, R)
        out = np.empty((ids.size, n_replicas, 2), dtype=np.int64)
        out[:, :, 0] = dom_reps
        for d in np.unique(dom_reps):
            mask = dom_reps == d  # (batch, R) positions using this domain
            rows = np.nonzero(mask.any(axis=1))[0]
            nodes = self._nodes_of(self.domains[int(d)], self._salt(ids[rows], int(d)))
            for r in range(n_replicas):
                sel = mask[rows, r]
                out[rows[sel], r, 1] = nodes[sel]
        return out

    def total_capacity(self) -> float:
        return self._top.total_capacity()
