"""Migration layer 3: the dual-version serving window.

While a plan drains, the system is BETWEEN versions: some data already
sits at its v+1 owner, the rest still at its v owner.  ``LiveMigration``
owns that window and gives readers one total rule:

    route(id) = v   owner  if id's move is still pending,
                v+1 owner  otherwise (landed, or never had to move)

The "pending" formulation is what makes ROLLBACK free: reversing a
half-landed migration is a new ``LiveMigration`` whose plan is the landed
rows with src/dst and v_from/v_to swapped -- unlanded rows never moved, so
under the reversed rule they fall into the "not in plan -> v owner" case,
which is exactly where they are.

``route_replicas[_device]`` is the per-slot REPLICA rule: each slot of an
id's R-replica set is independently v or v+1 by its own landed bit --

    route_replicas(id)[r] = plan.src of (id, r) while that slot's copy is
                            pending (the vacated v-side node still holding
                            the bytes),
                            v+1 set's slot r     otherwise

-- so every served set is R pairwise-distinct nodes that all hold the
datum at every round.  Rollback swaps slot/src_slot along with src/dst.

Both versions' tables come from the engine's LRU (no re-upload during the
window).  The device paths keep the whole rule on the card:
``route_device`` takes both owners from the two-version diff kernel (B3),
``route_replicas_device`` the v+1 sets from the replica kernel (B2), and a
sorted-membership probe against the per-round pending views supplies the
landed bits -- no host sync after the per-round view refresh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.ops import as_ids
from ..kernels.u32 import as_u32
from ..obs.trace import get_ledger
from .drain import DrainDriver
from .mover import MigrationState, ThrottledMover
from .planner import MigrationPlan

_BOUND: set = set()  # routing configurations the replica rule has served


def probe_trace_count(kind: str = "replica_route") -> int:
    """Bindings of the window's replica read rule to a routing
    configuration so far -- a counter on the process-wide ``obs`` ledger;
    repeated batches at one configuration never add to it."""
    return get_ledger().counter(f"migrate.live.{kind}_traces")


def _member(ids64: torch.Tensor, sorted_pad: torch.Tensor, n) -> torch.Tensor:
    """Membership of u32 ids (int64) in the first ``n`` entries of a
    sorted, sentinel-padded int64 tensor.  ``sorted_pad`` may be (R, P)
    with ``n`` (R, 1), probing every row at once -> (R, batch)."""
    probe = ids64 if sorted_pad.dim() == 1 else ids64.expand(sorted_pad.shape[0], -1)
    pos = torch.searchsorted(sorted_pad, probe.contiguous())
    pos_c = pos.clamp(max=sorted_pad.shape[-1] - 1)
    hit = (pos < n) & (torch.gather(sorted_pad, -1, pos_c) == probe)
    return hit, pos_c


class LiveMigration(DrainDriver):
    """One membership change served THROUGH its throttled drain.

    Wraps the assembled plan (``state.plan``), the landed bitmap
    (``state``) and the budgeted scheduler (``mover``).  The cluster table
    is already at v+1 when this object exists; readers go through
    ``route`` / ``route_device`` until ``done``."""

    def __init__(self, engine, state: MigrationState, mover: ThrottledMover):
        self.engine = engine
        self.state = state
        self.mover = mover
        self.aborted = False

    @classmethod
    def from_plan(
        cls,
        engine,
        plan,
        *,
        egress=None,
        ingress=None,
        clock=None,
        round_seconds: float = 1.0,
        ledger=None,
        metrics=None,
        bytes_per_row: int = 0,
    ) -> "LiveMigration":
        """The standard state + throttled mover around a plan, on the
        engine's device."""
        state = MigrationState(plan, device=engine.device)
        mover = ThrottledMover(
            state,
            egress=egress,
            ingress=ingress,
            clock=clock,
            round_seconds=round_seconds,
            ledger=ledger,
            metrics=metrics,
            bytes_per_row=bytes_per_row,
        )
        return cls(engine, state, mover)

    # -- window state ---------------------------------------------------------

    @property
    def v_from(self) -> int:
        return self.state.plan.v_from

    @property
    def v_to(self) -> int:
        return self.state.plan.v_to

    @property
    def n_replicas(self) -> int:
        return self.state.plan.n_replicas

    @property
    def done(self) -> bool:
        return self.state.done

    def _check_live(self) -> None:
        if self.aborted:
            raise RuntimeError("migration was rolled back; drive the reverse one")

    # -- dual-version read rule ----------------------------------------------

    def route(self, datum_ids) -> np.ndarray:
        """ids -> the node that HOLDS each datum right now (host path); only
        the pending subset pays the second placement under v."""
        self._check_live()
        ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
        owner = self.engine.place_nodes_at(ids, self.v_to)
        pending = self.state.is_pending(ids)
        if pending.any():
            owner[pending] = self.engine.place_nodes_at(ids[pending], self.v_from)
        return owner

    def route_device(self, datum_ids) -> torch.Tensor:
        """Device read rule -> (batch,) int32 nodes, no host sync: both
        owners from one launch of the two-version diff kernel, the landed
        bit from the per-round pending view.  The first call after a round
        pays the view's one upload."""
        self._check_live()
        ids = as_ids(datum_ids, self.engine.device)
        _, src, dst = self.engine.diff_nodes_device(ids, self.v_from, self.v_to)
        sorted_pad, n = self.state.pending_device()
        pending, _ = _member(as_u32(ids), sorted_pad, n)
        return torch.where(pending, src, dst)

    # -- per-slot replica read rule ---------------------------------------------

    def route_replicas(self, datum_ids) -> np.ndarray:
        """ids -> the (batch, R) replica sets that HOLD each datum now.

        Slot r serves its vacated v-side source while its copy is pending
        and the v+1 owner after.  Every set is pairwise-distinct: pending
        sources are vacated nodes, not members of the v+1 set, and distinct
        slots pair with distinct sources (the rank-matched alignment)."""
        self._check_live()
        ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
        owner = self.engine.place_replica_nodes_at(ids, self.v_to, self.n_replicas)
        pending, src = self.state.pending_replicas(ids)
        return np.where(pending, src, owner)

    def route_replicas_device(self, datum_ids) -> torch.Tensor:
        """Device ``route_replicas`` -> (batch, R) int32, no host sync after
        the per-round view refresh: v+1 sets from one replica-kernel launch,
        the per-slot pending probe, one ``where``.  The first batch at a
        routing configuration ``(top_level, s_log2, max_draws, R)`` counts
        one binding (``probe_trace_count``)."""
        self._check_live()
        art = self.engine._device_artifact_for(self.v_to, "asura")
        params = self.engine.params
        statics = (art.top_level, params.s_log2, params.max_draws, self.n_replicas)
        if statics not in _BOUND:
            _BOUND.add(statics)
            get_ledger().incr("migrate.live.replica_route_traces")
        ids = as_ids(datum_ids, self.engine.device)
        ids_pad, src_pad, counts = self.state.pending_replicas_device()
        dst = self.engine.place_replica_nodes_device_at(ids, self.v_to, self.n_replicas)
        hit, pos_c = _member(as_u32(ids), ids_pad, counts)
        src = torch.gather(src_pad, 1, pos_c)
        return torch.where(hit.T, src.T, dst)

    # -- drain control (round/pump/run from the shared DrainDriver loop) ------

    def _advance(self, fn):
        self._check_live()
        return fn()

    def _round(self) -> dict[tuple[int, int], int]:
        return self.mover.round()

    def _pump_rounds(self) -> list[dict[tuple[int, int], int]]:
        # delegate so clock accounting lives in the mover alone
        return self.mover.pump()

    def round_block(self, k: int) -> list[dict[tuple[int, int], int]]:
        """k budgeted rounds (the mover's round block)."""
        self._check_live()
        return self.mover.round_block(k)

    def _pending_desc(self) -> str:
        return f"{self.state.n_pending} rows pending"

    # -- rollback -------------------------------------------------------------

    def rollback(self) -> "LiveMigration":
        """Reverse a half-landed migration; returns the reverse migration.

        The reverse plan is the LANDED rows with src/dst, slot/src_slot and
        v_from/v_to swapped (unlanded rows never moved).  This object
        becomes inert.  Budgets swap roles with the flow direction: the
        forward ingress caps bind the reverse egress and vice versa.  Both
        versions stay in the LRU, so the flap re-uploads nothing; once the
        reverse drain completes the caller may revert the membership
        change itself."""
        self._check_live()
        if getattr(self, "membership_event", None) is not None and not getattr(
            self, "_coordinator_rollback", False
        ):
            # a coordinator's migration carries side state (owner table,
            # membership) that a bare reversal would leave behind
            raise RuntimeError(
                "this migration belongs to an ElasticCoordinator; use "
                "coordinator.rollback_live(migration)"
            )
        plan, landed = self.state.plan, self.state.landed
        reverse_plan = MigrationPlan(
            v_from=plan.v_to,
            v_to=plan.v_from,
            ids=plan.ids[landed],
            src=plan.dst[landed],
            dst=plan.src[landed],
            index=plan.index[landed],
            n_scanned=plan.n_scanned,
            n_replicas=plan.n_replicas,
            slot=plan.src_slot[landed],
            src_slot=plan.slot[landed],
        )
        self.aborted = True
        mover = self.mover
        return LiveMigration.from_plan(
            self.engine,
            reverse_plan,
            egress=mover.ingress,  # reversed flows: receive caps now bind sends
            ingress=mover.egress,
            clock=mover.clock,
            round_seconds=mover.round_seconds,
            ledger=mover.ledger,
            metrics=mover.metrics,
            bytes_per_row=mover.bytes_per_row,
        )
