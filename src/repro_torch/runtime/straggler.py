"""Straggler mitigation: speculative backup tasks for slow shard work.

The port's own copy of the reference module: pure host code.

Because shard payloads are recomputable from shard ids (data/pipeline.py) and
placement is a pure function of the table, ANY host can execute a backup copy
of a slow host's shard task.  The mitigator tracks per-task progress and
dispatches a backup to the least-loaded healthy host once a task exceeds
``threshold`` x the running median duration (MapReduce-style speculation).
First completion wins; duplicates are idempotent by construction
(deterministic task outputs keyed by shard id).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass
class TaskState:
    shard_id: int
    host: int
    started: float
    done: bool = False
    backup_host: Optional[int] = None


class StragglerMitigator:
    def __init__(self, clock: Callable[[], float], threshold: float = 2.0):
        self.clock = clock
        self.threshold = threshold
        self.tasks: dict[int, TaskState] = {}
        self.durations: list[float] = []

    def start(self, shard_id: int, host: int) -> None:
        self.tasks[shard_id] = TaskState(shard_id, host, self.clock())

    def complete(self, shard_id: int) -> None:
        t = self.tasks[shard_id]
        if not t.done:
            t.done = True
            self.durations.append(self.clock() - t.started)

    def _median(self) -> float:
        if not self.durations:
            return float("inf")
        s = sorted(self.durations)
        return s[len(s) // 2]

    def stragglers(self) -> list[TaskState]:
        med = self._median()
        now = self.clock()
        return [
            t
            for t in self.tasks.values()
            if not t.done
            and t.backup_host is None
            and now - t.started > self.threshold * med
        ]

    def dispatch_backups(self, healthy_hosts: list[int], load: dict[int, int]) -> list[tuple[int, int]]:
        """Returns (shard_id, backup_host) pairs; updates state."""
        out = []
        for t in self.stragglers():
            candidates = [h for h in healthy_hosts if h != t.host]
            if not candidates:
                continue
            backup = min(candidates, key=lambda h: load.get(h, 0))
            t.backup_host = backup
            load[backup] = load.get(backup, 0) + 1
            out.append((t.shard_id, backup))
        return out
