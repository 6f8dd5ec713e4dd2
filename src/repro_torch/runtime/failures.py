"""Heartbeat-based failure detection (simulated clock).

The port's own copy of the reference module: pure host code.

A node that misses ``timeout`` of heartbeats is declared dead; the caller
(launcher / coordinator) then drives the recovery path:
ElasticCoordinator.remove_node -> checkpoint restore -> resume.  The clock is
injected so tests are deterministic.

``MigrationDriver`` is the live-migration wiring (DESIGN.md sections 8,
10): a detected failure starts a throttled repair ``LiveMigration``
instead of an instantaneous table swap, and the same injected clock that
declared the node dead paces the repair rounds -- repair bandwidth is the
scarce resource (arXiv:1701.00335), so recovery traffic is budgeted
exactly like planned scale events.  With a replica-tracking coordinator
(``ElasticCoordinator(n_replicas=R)``) the repair is a REPLICA repair:
exactly the victim's replica mass re-replicates, per slot, instead of
whole-datum re-replication -- the surviving R-1 copies keep serving
throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ..migrate import DrainDriver


@dataclasses.dataclass
class HeartbeatTracker:
    timeout: float
    clock: Callable[[], float]
    last_seen: dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, node_id: int) -> None:
        self.last_seen[node_id] = self.clock()

    def dead_nodes(self) -> list[int]:
        now = self.clock()
        return [n for n, t in self.last_seen.items() if now - t > self.timeout]


class FailureDetector:
    """Drives detection -> removal -> repair for a checkpoint store or an
    elastic coordinator."""

    def __init__(self, tracker: HeartbeatTracker, on_failure: Callable[[int], None]):
        self.tracker = tracker
        self.on_failure = on_failure
        self.handled: set[int] = set()

    def poll(self) -> list[int]:
        newly_dead = [n for n in self.tracker.dead_nodes() if n not in self.handled]
        for node in newly_dead:
            self.handled.add(node)
            self.on_failure(node)
        return newly_dead

    def clear(self, node_id: int) -> None:
        """Forget a handled node (it recovered / was repaired in place), so
        a LATER failure of the same node is detected and handled again."""
        self.handled.discard(node_id)


class MigrationDriver(DrainDriver):
    """Failure -> throttled repair migration (no instantaneous swap).

    ``start_repair(node_id)`` must produce a ``LiveMigration`` (typically
    ``ElasticCoordinator.remove_node_live`` with the same injected clock;
    on a replica-tracking coordinator that is a per-slot REPLICA repair --
    only the victim's replica mass moves).  ``poll()`` detects deaths and
    queues their repairs; ``pump()`` advances the in-flight repair by the
    rounds its clock says are due and retires it when drained, and
    ``round()``/``run()`` (the shared ``DrainDriver`` loop) drive the
    queue clocklessly -- ``run()`` drains every queued repair.  Repairs
    run ONE AT A TIME in death order -- the dual-version read rules of
    overlapping migrations do not compose (a second plan would source ids
    from mid-flight locations), and the coordinator enforces the same
    single-drain rule.  While a repair is in flight, readers route through
    its rule (``active`` exposes it).
    """

    def __init__(self, tracker: HeartbeatTracker, start_repair: Callable[[int], "object"]):
        self.start_repair = start_repair
        self.queued: list[int] = []  # victims awaiting their repair window
        self.active: list = []  # at most one in-flight repair
        self.completed: list = []
        self._detector = FailureDetector(tracker, self._on_failure)

    def _on_failure(self, node_id: int) -> None:
        self.queued.append(node_id)
        self._start_next()

    def _start_next(self) -> None:
        if not self.active and self.queued:
            self.active.append(self.start_repair(self.queued.pop(0)))

    def poll(self) -> list[int]:
        """Detect new deaths; queue one repair migration per victim."""
        return self._detector.poll()

    def notify_recovered(self, node_id: int) -> None:
        """A repaired-in-place node is healthy again: re-arm detection so
        its NEXT failure queues a fresh repair (long-lived simulations and
        real clusters both re-fail nodes)."""
        self._detector.clear(node_id)

    @property
    def done(self) -> bool:
        return not self.active and not self.queued

    def _pending_desc(self) -> str:
        return f"{len(self.active)} active + {len(self.queued)} queued repairs"

    def _retire(self) -> None:
        for migration in list(self.active):
            if migration.done:
                self.active.remove(migration)
                self.completed.append(migration)
        self._start_next()

    def _round(self) -> dict[tuple[int, int], int]:
        """One clockless round of the in-flight repair (starting the next
        queued one if needed); an idle driver's round is an empty matrix,
        like the mover's."""
        self._start_next()
        if not self.active:
            return {}
        matrix = self.active[0].round()
        self._retire()
        return matrix

    def _pump_rounds(self) -> list[dict[tuple[int, int], int]]:
        """Advance the in-flight repair; returns the rounds' matrices."""
        matrices: list[dict[tuple[int, int], int]] = []
        for migration in list(self.active):
            matrices.extend(migration.pump())
        self._retire()
        return matrices
