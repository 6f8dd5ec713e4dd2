"""Migration layer 2: the bandwidth-throttled mover.

Draining a ``MigrationPlan`` all at once would saturate the cluster
network exactly when it is already degraded.  The mover drains the plan in
ROUNDS under per-node ingress/egress budgets:

  * ``MigrationState`` -- the plan plus a landed bitmap (which moves have
    physically completed) and device views of the still-pending ids for
    the dual-version read rule (``live.py``),
  * ``ThrottledMover``  -- each round admits pending rows in plan order
    while both the source's egress budget and the destination's ingress
    budget have headroom, and returns the round's per-(src, dst) movement
    matrix.  The clock is injected, so ``pump()`` runs exactly the rounds
    the elapsed time allows and tests stay deterministic.

Budget admission is conservative: ranks are computed per src group and
per dst group up front (vectorized), and a row is admitted iff BOTH ranks
are within budget -- neither budget is ever exceeded.

``round_block(k)`` is k host rounds.  The reference fuses them into one
device scan to save dispatches; here that scan would be a loop of small
torch ops and a copy back, so the host rule runs as it is.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from .drain import DrainDriver
from .planner import MigrationPlan

_SENTINEL = 0xFFFFFFFF  # pads a sorted pending view (itself a valid id)


def _group_ranks(keys: np.ndarray) -> np.ndarray:
    """Rank of each element within its value group, preserving order:
    ``[7, 3, 7, 7, 2]`` -> ``[0, 0, 1, 2, 0]``."""
    if keys.size == 0:
        return np.zeros(0, dtype=np.int64)
    return _GroupIndex(keys).ranks(np.ones(len(keys), dtype=bool))


class _GroupIndex:
    """Per-round group ranks without per-round sorting.

    The plan's row order never changes -- only the pending mask does -- so
    the stable sort by node and the group boundaries are computed ONCE;
    each round the rank of every flagged row within its group is a
    segmented cumsum over the precomputed order."""

    def __init__(self, keys: np.ndarray):
        self.order = np.argsort(keys, kind="stable")
        sorted_keys = keys[self.order]
        self.is_start = np.empty(len(keys), dtype=bool)
        if len(keys):
            self.is_start[0] = True
            np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=self.is_start[1:])

    def ranks(self, flags: np.ndarray) -> np.ndarray:
        """Rank of each row among the FLAGGED rows of its group (row
        order); meaningful only where ``flags`` is True."""
        if flags.size == 0:
            return np.zeros(0, dtype=np.int64)
        f = flags[self.order].astype(np.int64)
        cum = np.cumsum(f)
        before = cum - f  # flagged rows anywhere before this position
        base = np.maximum.accumulate(np.where(self.is_start, before, 0))
        ranks = np.empty(len(f), dtype=np.int64)
        ranks[self.order] = before - base
        return ranks


def _budget_of(budget, nodes: np.ndarray) -> np.ndarray:
    """Per-row budget array from None (unlimited), a scalar, or a dict
    (missing nodes unlimited; one lookup per DISTINCT node)."""
    no_limit = np.iinfo(np.int64).max
    if budget is None:
        return np.full(len(nodes), no_limit, dtype=np.int64)
    if isinstance(budget, dict):
        uniq, inverse = np.unique(nodes, return_inverse=True)
        caps = np.array([budget.get(int(n), no_limit) for n in uniq], dtype=np.int64)
        return caps[inverse]
    return np.full(len(nodes), int(budget), dtype=np.int64)


class MigrationState:
    """A plan plus its landed bitmap -- the single source of truth for the
    dual-version read rule.

    Rows are per (id, replica_slot); single-owner plans are the R=1 case.
    ``landed[i]`` flips True when row i's replica has arrived at ``dst[i]``
    (and left ``src[i]``); until then readers of that slot go to its v-side
    source.  ``pending_device()`` / ``pending_replicas_device()`` expose the
    still-pending ids as sorted, sentinel-padded tensors on ``device``
    (None: the card), rebuilt once per round, so the serving path probes
    membership with no host sync.  torch has no ``searchsorted`` on
    ``uint32``, so the views carry ids as int64; the ``pos < n`` guard
    stays because the sentinel ``0xFFFFFFFF`` is itself a valid id.
    """

    def __init__(self, plan: MigrationPlan, *, device=None):
        self.plan = plan
        self.device = device  # resolved when a device view is first built
        self.landed = np.zeros(plan.n_moves, dtype=bool)
        self._sorted_pending = None  # host cache for the host read rule
        self._dev_view = None  # (padded sorted pending ids, count)
        self._slot_host = None  # per-slot (sorted ids, src) host cache
        self._slot_dev = None  # per-slot device view (ids, src, counts)

    # -- host views ----------------------------------------------------------

    @property
    def n_pending(self) -> int:
        return int((~self.landed).sum())

    @property
    def done(self) -> bool:
        return self.n_pending == 0

    def pending_ids(self) -> np.ndarray:
        return self.plan.ids[~self.landed]

    def landed_ids(self) -> np.ndarray:
        return self.plan.ids[self.landed]

    def is_pending(self, datum_ids) -> np.ndarray:
        """Vectorized membership of ids in the still-pending move set (a
        sorted pending array cached per round)."""
        ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
        if self._sorted_pending is None:
            self._sorted_pending = np.sort(self.pending_ids())
        pending = self._sorted_pending
        if pending.size == 0:
            return np.zeros(ids.shape, dtype=bool)
        pos = np.searchsorted(pending, ids)
        return (pos < pending.size) & (pending[np.minimum(pos, pending.size - 1)] == ids)

    def mark_landed(self, rows: np.ndarray) -> None:
        """Flip plan rows to landed (the mover calls this per round)."""
        self.landed[rows] = True
        self._sorted_pending = None  # host and device views are stale
        self._dev_view = None
        self._slot_host = None
        self._slot_dev = None

    # -- per-slot views (replica read rule) ------------------------------------

    def _slot_tables(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Per-slot sorted pending ``(ids, src)`` pairs, cached per round
        (within one slot each id appears at most once)."""
        if self._slot_host is None:
            plan = self.plan
            tables = []
            for r in range(plan.n_replicas):
                mask = ~self.landed & (plan.slot == r)
                ids = plan.ids[mask]
                src = plan.src[mask]
                order = np.argsort(ids, kind="stable")
                tables.append((ids[order], src[order]))
            self._slot_host = tables
        return self._slot_host

    def pending_replicas(self, datum_ids) -> tuple[np.ndarray, np.ndarray]:
        """(batch, R) pending mask + aligned v-side sources (host path):
        ``src[b, r]`` is the node holding slot r's bytes while pending."""
        ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
        R = self.plan.n_replicas
        pending = np.zeros((len(ids), R), dtype=bool)
        src = np.zeros((len(ids), R), dtype=np.int64)
        for r, (p_ids, p_src) in enumerate(self._slot_tables()):
            if p_ids.size == 0:
                continue
            pos = np.searchsorted(p_ids, ids)
            pos_c = np.minimum(pos, p_ids.size - 1)
            hit = (pos < p_ids.size) & (p_ids[pos_c] == ids)
            pending[:, r] = hit
            src[hit, r] = p_src[pos_c[hit]]
        return pending, src

    def pending_replicas_device(self):
        """Per-slot device view ``(ids_pad, src_pad, counts)``: (R, P)
        sorted sentinel-padded pending ids per slot (int64), (R, P) their
        int32 v-side sources, (R, 1) int64 live lengths; P is the shared
        next power of two.  Rebuilt after ``mark_landed`` -- one upload per
        round, on the control path."""
        if self._slot_dev is None:
            tables = self._slot_tables()
            n_max = max((len(t[0]) for t in tables), default=0)
            padded_len = 1 << max(0, n_max - 1).bit_length()
            R = self.plan.n_replicas
            ids_pad = np.full((R, padded_len), _SENTINEL, dtype=np.int64)
            src_pad = np.full((R, padded_len), -1, dtype=np.int32)
            counts = np.zeros((R, 1), dtype=np.int64)
            for r, (p_ids, p_src) in enumerate(tables):
                ids_pad[r, : len(p_ids)] = p_ids
                src_pad[r, : len(p_ids)] = p_src
                counts[r, 0] = len(p_ids)
            dev = resolve_device(self.device)
            self._slot_dev = tuple(
                torch.from_numpy(a).to(dev) for a in (ids_pad, src_pad, counts)
            )
        return self._slot_dev

    def pending_device(self):
        """``(sorted_padded_ids, count)``: the pending ids as a sorted int64
        tensor padded to a power of two on the device, and their number
        (a host int).  Rebuilt after ``mark_landed`` -- one upload per
        round, on the control path."""
        if self._dev_view is None:
            pending = np.sort(self.pending_ids()).astype(np.int64)
            n = len(pending)
            padded = np.full(1 << max(0, n - 1).bit_length(), _SENTINEL, dtype=np.int64)
            padded[:n] = pending
            dev = resolve_device(self.device)
            self._dev_view = (torch.from_numpy(padded).to(dev), n)
        return self._dev_view


class ThrottledMover(DrainDriver):
    """Drains a ``MigrationState`` in budgeted rounds.

    ``egress`` / ``ingress``: max rows (replica copies) a node may send /
    receive per round -- None (unlimited), a scalar for every node, or a
    ``{node_id: limit}`` dict (missing nodes unlimited).  ``clock`` is an
    injected time source; ``pump()`` runs however many whole
    ``round_seconds`` periods have elapsed since the last call."""

    def __init__(
        self,
        state: MigrationState,
        *,
        egress=None,
        ingress=None,
        clock: Callable[[], float] | None = None,
        round_seconds: float = 1.0,
        ledger=None,
        metrics=None,
        bytes_per_row: int = 0,
    ):
        self.state = state
        self.egress = egress
        self.ingress = ingress
        self.clock = clock
        self.round_seconds = float(round_seconds)
        # observability (optional): one ledger event per round via the
        # DrainDriver hook; ``bytes_per_row`` prices each (id, slot) row
        self.ledger = ledger
        self.metrics = metrics
        self.bytes_per_row = int(bytes_per_row)
        self.rounds_done = 0
        self._pumped = 0  # clock-paced rounds only (manual round()s excluded)
        self.history: list[dict[tuple[int, int], int]] = []
        self._t0 = clock() if clock is not None else 0.0
        # row order and budgets never change: precompute once
        self._by_src = _GroupIndex(state.plan.src)
        self._by_dst = _GroupIndex(state.plan.dst)
        self._cap_src = _budget_of(egress, state.plan.src)
        self._cap_dst = _budget_of(ingress, state.plan.dst)

    @property
    def done(self) -> bool:
        return self.state.done

    @property
    def next_round_at(self) -> float | None:
        """Clock time the next paced round becomes due (None: no clock or
        already drained) -- event-driven callers (the durability
        simulator) jump their clock straight to it."""
        if self.clock is None or self.done:
            return None
        return self._t0 + (self._pumped + 1) * self.round_seconds

    def _pending_desc(self) -> str:
        return f"{self.state.n_pending} rows pending"

    def _round(self) -> dict[tuple[int, int], int]:
        """One throttled round -> the per-(src, dst) movement matrix."""
        state = self.state
        pending = ~state.landed
        take = (
            pending
            & (self._by_src.ranks(pending) < self._cap_src)
            & (self._by_dst.ranks(pending) < self._cap_dst)
        )
        moved_rows = np.nonzero(take)[0]
        state.mark_landed(moved_rows)
        matrix: dict[tuple[int, int], int] = {}
        if moved_rows.size:
            pairs, counts = np.unique(
                np.stack([state.plan.src[take], state.plan.dst[take]], axis=1),
                axis=0,
                return_counts=True,
            )
            matrix = {(int(s), int(d)): int(c) for (s, d), c in zip(pairs, counts)}
        self.rounds_done += 1
        self.history.append(matrix)
        return matrix

    def _pump_rounds(self) -> list[dict[tuple[int, int], int]]:
        """The injected-clock pacing (0 rounds if none are due); manual
        ``round()`` calls never skip periods the clock has earned."""
        if self.clock is None:
            return [] if self.done else [self._round()]
        due = int(math.floor((self.clock() - self._t0) / self.round_seconds))
        out = []
        while self._pumped < due and not self.done:
            out.append(self._round())
            self._pumped += 1
        return out

    def round_block(self, k: int) -> list[dict[tuple[int, int], int]]:
        """Run k budgeted rounds (exactly k, even once drained); returns
        the k per-round movement matrices (ledger-emitted like any other
        round).  Counts as manual rounds: clock pacing (``pump``) is
        unaffected."""
        k = int(k)
        if k < 1:
            raise ValueError(f"round_block needs k >= 1, got {k}")
        return self._emit_rounds(self._advance(lambda: [self._round() for _ in range(k)]))

    def movement_matrix(self) -> dict[tuple[int, int], int]:
        """Accumulated (src, dst) -> rows moved so far, across all rounds."""
        total: dict[tuple[int, int], int] = {}
        for matrix in self.history:
            for pair, count in matrix.items():
                total[pair] = total.get(pair, 0) + count
        return total
