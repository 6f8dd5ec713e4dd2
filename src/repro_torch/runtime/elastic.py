"""Elastic scaling coordinator: minimal-movement membership changes.

The port's copy of the reference coordinator.  Placement runs through the
cluster's port engine (on the card unless the cluster was built with
``device="cpu"``): the planner's two-version diffs (B3 at R=1, B4 at
R>1), the replica sets (B2) and the baselines' lookups (B5-B7).  The
ADDITION-NUMBER prefilter stays the host NumPy trace, as in the
reference.

The coordinator owns the authoritative ASURA ``Cluster`` table (the paper's
temporary-central-node role, section 2.D -- any host can take it over since
the table is tiny and serializable).  On membership events it produces a
``MovePlan``: exactly which datum ids (shards / cache entries / checkpoint
chunks) move where.  ASURA's optimality theorems guarantee the plan is
minimal; tests/test_torch_runtime.py re-verifies against brute force.

Change detection uses the section 2.D metadata:
  * removals: a datum is affected iff one of its REMOVE NUMBERS names a
    segment of the removed node (exact, any capacity mix),
  * additions: candidates are data whose ADDITION NUMBER is <= the assigned
    segment number (the sound "<=" rule; the paper's "==" rule is exact only
    for full-length segment tables -- see DESIGN.md section 7 and
    tests/test_asura_properties.py::test_p5*), then verified by recompute.

The recompute itself runs through the migration planner (DESIGN.md section
8): candidates are diffed against the v and v+1 table artifacts in one
vectorized sweep -- the ``MovePlan`` dict is built from the plan's moved
arrays, not a per-candidate Python loop.  ``add_node_live`` /
``remove_node_live`` return the same change as a ``LiveMigration``: a
throttled, dual-version-served drain instead of an instantaneous swap.

With ``n_replicas > 1`` the coordinator tracks full R-way replica SETS
(section 5.A) and every event plans through the per-slot replica planner
(DESIGN.md section 10): only replicas whose owner actually changed move,
live drains serve mixed-version replica sets via
``LiveMigration.route_replicas``, and a failed node repairs as a
throttled replica migration (exactly its replica mass) instead of full
re-replication.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Cluster
from ..core.asura import DEFAULT_PARAMS, addition_numbers_batch
from ..migrate import LiveMigration, MigrationPlan, MigrationPlanner


@dataclasses.dataclass
class MovePlan:
    """datum id -> (src node, dst node) for every datum that must move."""

    moves: dict[int, tuple[int, int]]

    @property
    def n_moves(self) -> int:
        return len(self.moves)


class ElasticCoordinator:
    def __init__(
        self,
        cluster: Cluster,
        tracked_ids: np.ndarray,
        *,
        algorithm: str = "asura",
        n_replicas: int = 1,
    ):
        self.cluster = cluster
        self.engine = cluster.engine  # shared versioned table artifact
        self.algorithm = algorithm
        self.n_replicas = int(n_replicas)
        if self.n_replicas > 1 and algorithm != "asura":
            raise ValueError(
                "replica-set tracking rides on ASURA's section 5.A "
                f"replication; got algorithm={algorithm!r}"
            )
        self.planner = MigrationPlanner(self.engine)
        self.tracked = np.asarray(tracked_ids, dtype=np.uint32)
        if self.n_replicas > 1:
            # (n, R) replica-node sets, primary first
            self._owners = self.engine.place_replica_nodes(
                self.tracked, self.n_replicas
            )
        else:
            self._owners = self.engine.place_nodes(self.tracked, algorithm=algorithm)
        self._an: np.ndarray | None = None  # lazy ADDITION NUMBER cache
        self._live_migration: LiveMigration | None = None  # in-flight drain
        self._last_revert = None  # (rows, before-sets) of the last replica apply

    # -- metadata ------------------------------------------------------------

    def _addition_numbers(self) -> np.ndarray:
        if self._an is None:
            # Vectorized 2.D metadata: one batched trace over every tracked
            # id (addition_numbers_batch), not a per-id Python loop -- for
            # replica sets, the R-replica trace's AN.
            art = self.engine.artifact()
            self._an = addition_numbers_batch(
                self.tracked,
                self.cluster.seg_lengths(),
                art.node_of,
                self.n_replicas,
                params=getattr(self.cluster, "params", DEFAULT_PARAMS),
            )
        return self._an

    # -- events ---------------------------------------------------------------

    def _apply(self, plan: MigrationPlan, rows: np.ndarray) -> MovePlan:
        """Fold a planner diff over ``rows`` of the tracked set into the
        owner table and a ``MovePlan`` (vectorized dict build).

        Replica mode re-places the CHANGED ids' full sets rather than
        patching moved slots: common nodes can permute positions inside a
        set across versions, so only the fresh v+1 sets are positionally
        authoritative.  The pre-event sets are remembered for
        ``rollback_live``."""
        if self.n_replicas > 1:
            changed = (
                rows[np.unique(plan.index)]
                if plan.n_moves
                else np.zeros(0, dtype=np.int64)
            )
            self._last_revert = (changed, self._owners[changed].copy())
            if len(changed):
                self._owners[changed] = self.engine.place_replica_nodes(
                    self.tracked[changed], self.n_replicas
                )
        else:
            self._owners[rows[plan.index]] = plan.dst
        self._an = None  # ANs shift once their segment is taken; recompute lazily
        return MovePlan(plan.moves_dict())

    def _plan_candidates(self, rows: np.ndarray, v_from: int) -> MigrationPlan:
        """One planner sweep over candidate rows, with the cached owner
        table supplying the v side (one placement per candidate, not two)."""
        if self.n_replicas > 1:
            return self.planner.plan_replicas(
                self.tracked[rows],
                v_from,
                self.cluster.version,
                self.n_replicas,
                known_before=self._owners[rows],
            )
        return self.planner.plan(
            self.tracked[rows],
            v_from,
            self.cluster.version,
            known_src=self._owners[rows],
        )

    def _add_plan(self, node_id: int, capacity: float):
        """Mutate the cluster; diff the AN-candidate rows -> (plan, rows).

        The AN <= f prefilter shrinks the recompute set; the candidates
        are then diffed in one planner sweep."""
        an = self._addition_numbers()
        self.engine.artifact()  # pin the v table in the LRU before mutating
        v_from = self.cluster.version
        new_segs = self.cluster.add_node(node_id, capacity)
        rows = np.nonzero(an <= max(new_segs))[0]
        return self._plan_candidates(rows, v_from), rows

    def _remove_plan(self, node_id: int):
        """Mutate the cluster; diff the victim's rows -> (plan, rows).

        Replica mode: a datum is affected iff the victim is IN its replica
        set -- the vectorized REMOVE-NUMBER test (a remove number names a
        victim segment exactly when the victim owns a replica)."""
        self.engine.artifact()
        v_from = self.cluster.version
        if self.n_replicas > 1:
            rows = np.nonzero((self._owners == node_id).any(axis=1))[0]
        else:
            rows = np.nonzero(self._owners == node_id)[0]
        self.cluster.remove_node(node_id)
        return self._plan_candidates(rows, v_from), rows

    def _baseline_event(self, mutate) -> MovePlan:
        """Movement accounting for a baseline algorithm: pin the current
        artifact, apply the membership change, and diff the tracked set's
        owners across the two cached versions -- the same before/after
        accounting the paper's section 6.D comparison uses, vectorized
        through the engine's versioned ``(algorithm, version)`` LRU."""
        self.engine.artifact(self.algorithm)  # pin the v table in the LRU
        v_from = self.cluster.version
        mutate()
        before = self.engine.place_nodes_at(
            self.tracked, v_from, algorithm=self.algorithm
        )
        after = self.engine.place_nodes(self.tracked, algorithm=self.algorithm)
        rows = np.nonzero(before != after)[0]
        # vectorized dict build (the planner's moves_dict shape) -- no
        # per-row numpy scalar indexing.
        moved_ids = self.tracked[rows].tolist()
        moves = dict(
            zip(moved_ids, zip(before[rows].tolist(), after[rows].tolist()))
        )
        self._owners = after
        return MovePlan(moves)

    def add_node(self, node_id: int, capacity: float) -> MovePlan:
        """Grow the cluster; move only data captured by the new segments."""
        self._check_no_live()
        if self.algorithm != "asura":
            return self._baseline_event(
                lambda: self.cluster.add_node(node_id, capacity)
            )
        return self._apply(*self._add_plan(node_id, capacity))

    def remove_node(self, node_id: int) -> MovePlan:
        """Shrink the cluster; move exactly the data the victim held."""
        self._check_no_live()
        if self.algorithm != "asura":
            return self._baseline_event(lambda: self.cluster.remove_node(node_id))
        return self._apply(*self._remove_plan(node_id))

    # -- live (throttled, dual-version-served) events -------------------------

    def _require_asura_live(self) -> None:
        if self.algorithm != "asura":
            raise ValueError(
                "live (dual-version-served) migrations ride on ASURA's "
                f"table artifacts; this coordinator tracks {self.algorithm!r}"
                " -- use add_node/remove_node for the instantaneous plan"
            )

    def _check_no_live(self) -> None:
        """Dual-version read rules of OVERLAPPING migrations do not compose
        (a second plan's src comes from the eagerly-advanced owner table,
        not from where pending data physically sits) -- one drain at a
        time, like the checkpoint store."""
        live = self._live_migration
        if live is not None and not (live.done or live.aborted):
            raise RuntimeError(
                "a live migration is already in flight; drain or roll it "
                "back before the next membership event"
            )

    def _live(
        self, plan: MigrationPlan, rows: np.ndarray, egress, ingress, clock,
        round_seconds: float,
    ) -> LiveMigration:
        self._apply(plan, rows)  # owner table tracks the post-drain state
        migration = LiveMigration.from_plan(
            self.engine,
            plan,
            egress=egress,
            ingress=ingress,
            clock=clock,
            round_seconds=round_seconds,
        )
        # remembered so rollback_live can revert the owner table rows
        migration.tracked_rows = rows[plan.index]
        if self.n_replicas > 1:
            migration.replica_revert = self._last_revert
        self._live_migration = migration
        return migration

    def add_node_live(
        self,
        node_id: int,
        capacity: float,
        *,
        egress=None,
        ingress=None,
        clock=None,
        round_seconds: float = 1.0,
    ) -> LiveMigration:
        """Grow the cluster as a LIVE migration: the same minimal plan as
        ``add_node``, drained under bandwidth budgets while reads are
        served through the dual-version rule (route via the returned
        migration until it is ``done``)."""
        self._require_asura_live()
        self._check_no_live()
        plan, rows = self._add_plan(node_id, capacity)
        migration = self._live(plan, rows, egress, ingress, clock, round_seconds)
        migration.membership_event = ("add", node_id)
        return migration

    def remove_node_live(
        self,
        node_id: int,
        *,
        egress=None,
        ingress=None,
        clock=None,
        round_seconds: float = 1.0,
    ) -> LiveMigration:
        """Shrink the cluster as a live migration (planned drain / scale-in;
        for a crashed node the drain degenerates to repair traffic -- the
        source copies are gone, but the (src, dst) matrix still bounds the
        per-node repair ingress)."""
        self._require_asura_live()
        self._check_no_live()
        plan, rows = self._remove_plan(node_id)
        migration = self._live(plan, rows, egress, ingress, clock, round_seconds)
        migration.membership_event = ("remove", node_id)
        return migration

    def rollback_live(self, migration: LiveMigration) -> LiveMigration:
        """Roll back one of THIS coordinator's live ADD migrations.

        Beyond ``LiveMigration.rollback``: the owner-table rows the forward
        migration eagerly advanced to v+1 are reverted to their v owners
        (landed rows return via the reverse drain; unlanded rows never
        left), and the membership change itself is reverted NOW -- removing
        the just-added node frees exactly the segments it was assigned, so
        the current table places bit-identically to v and every
        non-migrating consumer immediately plans/routes against the truth.
        The reverse drain keeps routing through the v/v+1 artifacts in the
        LRU regardless.

        Rolling back a REMOVAL is not an inverse operation but a fresh
        scale-out (re-adding the node may be assigned different free
        segments): use ``add_node``/``add_node_live`` instead.
        """
        # Fail BEFORE mutating: stale references (an earlier, already-drained
        # migration) or foreign migrations must not touch cluster state.
        if migration is not self._live_migration or migration.done:
            raise ValueError(
                "can only roll back this coordinator's in-flight migration"
            )
        migration._check_live()
        event = getattr(migration, "membership_event", (None,))
        if event[0] != "add":
            raise ValueError(
                "only add-node migrations roll back exactly; undo a removal "
                "by re-adding the node (a regular add event)"
            )
        if self.n_replicas > 1:
            # whole pre-event sets were remembered (slot patches cannot
            # reconstruct them: common nodes may have permuted positions)
            revert_rows, before_sets = migration.replica_revert
            self._owners[revert_rows] = before_sets
        else:
            self._owners[migration.tracked_rows] = migration.state.plan.src
        self._an = None
        self.cluster.remove_node(event[1])
        migration._coordinator_rollback = True  # bare rollback() is refused
        reverse = migration.rollback()
        self._live_migration = reverse  # the drain in flight is now the reverse
        return reverse

    def remove_numbers_batch(self, datum_ids, n_replicas: int) -> np.ndarray:
        """Vectorized section 2.D REMOVE NUMBERS -> (batch, R) sorted segs.

        One replica-placement sweep on the engine path (cached artifact,
        device backends stay on device) instead of the historical per-id
        scalar trace."""
        return self.engine.remove_numbers_batch(datum_ids, n_replicas)

    def remove_numbers_for(self, datum_id: int, n_replicas: int) -> list[int]:
        return [int(x) for x in self.remove_numbers_batch([datum_id], n_replicas)[0]]

    def owners(self) -> np.ndarray:
        """The tracked owner table: (n,) node ids, or (n, R) replica sets
        when the coordinator tracks replicas."""
        return self._owners.copy()
