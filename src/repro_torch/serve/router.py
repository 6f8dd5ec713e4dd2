"""ASURA session routing across serving replicas, on the card.

The port of the reference's flat ``ReplicaRouter``.  Sessions are sticky
(a session's KV cache lives on one replica); ASURA lets any frontend
compute the owner from the O(N) table, re-routes only a lost replica's
sessions, and weights replicas by capacity through segment lengths.
Routing goes through a ``PlacementEngine``, so the table is uploaded once
per membership version.

``Router(algorithm=...)`` swaps the placement algorithm under the same
interface: ``"asura"`` (default, the cluster's own engine), ``"ch"``
(``virtual_nodes`` ring points per replica), ``"wrh"`` or ``"rs"`` route
through a dedicated engine whose default algorithm is the baseline, so
the paper's head-to-head runs on the serving path too, R-way fan-out
included.

Scale events: ``plan_scale_event`` applies a membership change at once and
returns the minimal session moves (under any algorithm);
``begin_scale_migration`` applies it as a LIVE migration
(``migrate.LiveMigration``, ASURA only: it rides on ASURA's dual-version
tables) whose moves drain under per-replica budgets while
``route_migrating`` / ``route_replicas_migrating`` keep every request on a
replica that holds its warm cache.

Failure-domain-aware routing: ``Router({domain: {replica: capacity}})``
builds a ``HierarchicalCluster`` (ASURA only) whose engine routes through
the two-level kernel, so a session's R cache holders lie in R distinct
domains (``route_replicas`` gives the replicas, ``route_replica_pairs``
the (domain, replica) pairs); ``plan_scale_event`` takes ``add=(domain,
replica, capacity)`` / ``remove=(domain, replica)``.  Live scale windows
stay flat-only, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.cluster import Cluster
from ..core.engine import ALGORITHMS, DEFAULT_VIRTUAL_NODES, PlacementEngine
from ..core.hierarchy import HierarchicalCluster


@dataclasses.dataclass
class ScalePlan:
    moved_sessions: dict[int, tuple[int, int]]  # session -> (src, dst)

    @property
    def n_reprefills(self) -> int:
        return len(self.moved_sessions)


class ReplicaRouter:
    """Routes session ids to replica ids; ``device`` is where placement
    runs (None: the card)."""

    def __init__(
        self,
        replica_capacities: dict[int, float],
        *,
        algorithm: str = "asura",
        virtual_nodes: int = DEFAULT_VIRTUAL_NODES,
        device=None,
    ):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}")
        self.hierarchical = any(isinstance(v, dict) for v in replica_capacities.values())
        if self.hierarchical:
            # {domain: {replica: capacity}} -> failure-domain-aware routing
            if algorithm != "asura":
                raise ValueError(
                    "hierarchical routing is ASURA-only (two-level segment "
                    f"tables); got algorithm={algorithm!r}"
                )
            self.cluster = HierarchicalCluster(device=device)
            for did, members in replica_capacities.items():
                for rid, cap in members.items():
                    self.cluster.add_node(did, rid, cap)
        else:
            self.cluster = Cluster(device=device)
            for rid, cap in replica_capacities.items():
                self.cluster.add_node(rid, cap)
        self.algorithm = algorithm
        if algorithm == "asura":
            self.engine = self.cluster.engine
        else:
            # a dedicated engine whose DEFAULT algorithm is the baseline, so
            # every route call dispatches to the baseline kernels
            self.engine = PlacementEngine(
                self.cluster, device=device, algorithm=algorithm,
                virtual_nodes=virtual_nodes,
            )
        self._scale_migration = None  # at most one live window at a time

    def route(self, session_ids) -> np.ndarray:
        """session ids -> replica ids (vectorized, table-local)."""
        return self.engine.place_nodes(np.asarray(session_ids, dtype=np.uint32))

    def route_device(self, session_ids):
        """session ids -> replica ids as a device tensor, no host sync."""
        return self.engine.place_nodes_device(session_ids)

    def route_replicas(self, session_ids, n_replicas: int) -> np.ndarray:
        """(sessions, R) replica ids on distinct replicas, primary first;
        on a hierarchical router the replicas of R distinct domains."""
        out = self.engine.place_replica_nodes(
            np.asarray(session_ids, dtype=np.uint32), n_replicas
        )
        return out[:, :, 1] if self.hierarchical else out

    def route_replica_pairs(self, session_ids, n_replicas: int) -> np.ndarray:
        """(sessions, R, 2) ``(domain, replica)`` pairs, hierarchical routers
        only: a whole-domain outage loses at most one warm copy per
        session."""
        if not self.hierarchical:
            raise ValueError(
                "route_replica_pairs needs a hierarchical router (pass "
                "{domain: {replica: capacity}} capacities)"
            )
        return self.engine.place_replica_pairs(
            np.asarray(session_ids, dtype=np.uint32), n_replicas
        )

    def route_replicas_device(self, session_ids, n_replicas: int):
        """Device-resident ``route_replicas`` -> (sessions, R) int32 (one
        kernel launch, no host sync; -1 marks the practically impossible
        unfilled slots)."""
        out = self.engine.place_replica_nodes_device(session_ids, n_replicas)
        return out[1].T if self.hierarchical else out

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

    def plan_scale_event(self, session_ids, *, add=None, remove=None) -> ScalePlan:
        """Apply a membership change (``add=(replica, capacity)``,
        ``remove=replica``; hierarchical routers ``add=(domain, replica,
        capacity)``, ``remove=(domain, replica)``) at once; return the
        minimal session moves."""
        ids = np.asarray(session_ids, dtype=np.uint32)
        before = self.route(ids)
        if remove is not None:
            if self.hierarchical:
                self.cluster.remove_node(*remove)
            else:
                self.cluster.remove_node(remove)
        if add is not None:
            self.cluster.add_node(*add)
        after = self.route(ids)
        moved = np.nonzero(before != after)[0]
        return ScalePlan({int(ids[i]): (int(before[i]), int(after[i])) for i in moved})

    # -- migration-window serving ----------------------------------------------

    def begin_scale_migration(
        self,
        session_ids,
        *,
        add=None,
        remove=None,
        n_replicas: int = 1,
        egress=None,
        ingress=None,
        clock=None,
        round_seconds: float = 1.0,
        ledger=None,
    ):
        """Apply a membership change as a LIVE migration -> ``LiveMigration``.

        The minimal session moves (cache re-prefills) drain under
        per-replica ingress/egress budgets while ``route_migrating`` keeps
        every request on the replica whose cache is warm: the v owner until
        the session's re-prefill lands, the v+1 owner after.  An add-only
        event runs the ADDITION-NUMBER prefilter (the trace's kernel), so
        only AN candidates pay the two-version diff; the plan is the same
        either way.  With ``n_replicas > 1`` the plan is the per-slot
        replica plan and ``route_replicas_migrating`` serves the
        mixed-version sets.  The v table is pinned in the engine's LRU
        before the cluster mutates.  ``ledger``, if given, takes the
        planner's span and prefilter counters."""
        from ..migrate import LiveMigration, MigrationPlanner

        if self.algorithm != "asura":
            raise ValueError(
                "live scale migrations ride on ASURA's dual-version table "
                f"artifacts; this router routes via {self.algorithm!r} -- "
                "use plan_scale_event for the instantaneous-swap plan"
            )
        if self.hierarchical:
            raise NotImplementedError(
                "live scale-migration windows are flat-router only for "
                "now; hierarchical routers plan instantaneous swaps via "
                "plan_scale_event (the engine's diff_replica_domains_device "
                "gives the per-slot moves for external drivers)"
            )
        live = self._scale_migration
        if live is not None and not (live.done or live.aborted):
            raise RuntimeError("a scale migration is already in flight; drain it first")
        ids = np.asarray(session_ids, dtype=np.uint32)
        self.engine.artifact()  # pin the v table in the LRU before mutating
        v_from = self.cluster.version
        max_new_seg = None
        if remove is not None:
            self.cluster.remove_node(remove)
        if add is not None:
            new_segs = self.cluster.add_node(*add)
            if remove is None:
                max_new_seg = max(new_segs)
        planner = MigrationPlanner(self.engine, ledger=ledger)
        v_to = self.cluster.version
        if n_replicas > 1:
            plan = planner.plan_replicas(ids, v_from, v_to, n_replicas,
                                         max_new_seg=max_new_seg)
        else:
            plan = planner.plan(ids, v_from, v_to, max_new_seg=max_new_seg)
        self._scale_migration = LiveMigration.from_plan(
            self.engine, plan, egress=egress, ingress=ingress, clock=clock,
            round_seconds=round_seconds,
        )
        return self._scale_migration

    def route_migrating(self, session_ids, migration) -> np.ndarray:
        """Window routing: each session to the replica holding its warm
        cache now (v owner while pending, v+1 owner once landed)."""
        return migration.route(np.asarray(session_ids, dtype=np.uint32))

    def route_migrating_device(self, session_ids, migration):
        """Device window routing (no host sync after the per-round view
        refresh)."""
        return migration.route_device(session_ids)

    def route_replicas_migrating(self, session_ids, migration) -> np.ndarray:
        """Window REPLICA routing: (sessions, R) sets, each slot on the side
        of the window that holds its warm cache; pairwise distinct every
        round."""
        return migration.route_replicas(np.asarray(session_ids, dtype=np.uint32))

    def route_replicas_migrating_device(self, session_ids, migration):
        """Device ``route_replicas_migrating`` (no host sync after the
        per-round view refresh)."""
        return migration.route_replicas_device(session_ids)

    def table_blob(self) -> str:
        """The only state frontends need to share (kilobytes): the cluster
        blob, from which ASURA's table and the CH and WRH tables derive.
        Random slicing's interval table is history-dependent -- it lives
        in the engine, not the blob -- so a frontend rebuilt from the blob
        would route differently, and this raises instead."""
        if self.algorithm == "rs":
            raise ValueError(
                "random slicing's interval table is history-dependent and "
                "not captured by the cluster blob; rs frontends must share "
                "the router (or replay the same membership sequence), not "
                "table_blob()"
            )
        return self.cluster.to_json()


Router = ReplicaRouter
