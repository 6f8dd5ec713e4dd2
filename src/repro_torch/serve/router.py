"""ASURA session routing across serving replicas, on the card.

The port of the reference's flat ``ReplicaRouter`` for ``algorithm=
"asura"``.  Sessions are sticky (a session's KV cache lives on one
replica); ASURA lets any frontend compute the owner from the O(N) table,
re-routes only a lost replica's sessions, and weights replicas by
capacity through segment lengths.  Routing goes through the cluster's
``PlacementEngine``, so the table is uploaded once per membership
version.  The baselines, hierarchical routing and scale events are not
ported yet.
"""

from __future__ import annotations

import numpy as np

from ..core.cluster import Cluster
from ..core.engine import PlacementEngine


class ReplicaRouter:
    """Routes session ids to replica ids; ``device`` is where placement
    runs (None: the card)."""

    def __init__(
        self,
        replica_capacities: dict[int, float],
        *,
        algorithm: str = "asura",
        device=None,
    ):
        if any(isinstance(v, dict) for v in replica_capacities.values()):
            raise NotImplementedError(
                "hierarchical routing is not ported yet (ROADMAP A6)"
            )
        self.algorithm = PlacementEngine._resolve_algorithm(algorithm)
        self.cluster = Cluster(device=device)
        for rid, cap in replica_capacities.items():
            self.cluster.add_node(rid, cap)
        self.engine = self.cluster.engine

    def route(self, session_ids) -> np.ndarray:
        """session ids -> replica ids (vectorized, table-local)."""
        return self.engine.place_nodes(np.asarray(session_ids, dtype=np.uint32))

    def route_device(self, session_ids):
        """session ids -> replica ids as a device tensor, no host sync."""
        return self.engine.place_nodes_device(session_ids)

    def route_replicas(self, session_ids, n_replicas: int) -> np.ndarray:
        """(sessions, R) replica ids on distinct replicas, primary first."""
        return self.engine.place_replica_nodes(
            np.asarray(session_ids, dtype=np.uint32), n_replicas
        )

    def route_replicas_device(self, session_ids, n_replicas: int):
        """Device-resident ``route_replicas`` (one kernel launch, no host
        sync; -1 marks the practically impossible unfilled slots)."""
        return self.engine.place_replica_nodes_device(session_ids, n_replicas)

    def stream_driver(self, **kwargs):
        """A batched ``RequestStreamDriver`` bound to this router's engine."""
        from .stream import RequestStreamDriver

        return RequestStreamDriver(self.engine, algorithm=self.algorithm, **kwargs)

    @property
    def table_uploads(self) -> int:
        """Table materializations so far (1 per membership version used)."""
        return self.engine.uploads

    def my_sessions(self, replica_id: int, session_ids) -> np.ndarray:
        ids = np.asarray(session_ids, dtype=np.uint32)
        return ids[self.route(ids) == replica_id]


Router = ReplicaRouter
