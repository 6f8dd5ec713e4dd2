"""ASURA STEP 1 in NumPy: the segment tables a membership history gives.

The rules of the paper's section 2.A and 2.D, as the benchmark reads
them, worked out from the capacities and the order of the membership
changes alone:

  1. a node holds segments in proportion to its capacity: one unit of
     capacity is one full segment of length ``1 - 2**-32`` (under 1, as
     rule 4 asks), and the fractional remainder a shorter one;
  2. a segment once given to a node stays with it;
  3. a new segment takes the smallest free segment number;
  4. a resized node keeps its full segments and rebuilds its tail: it
     sheds segments from the last one on to shrink, and to grow it tops
     up its last segment to full length and then takes new segments.

A table is what the kernels read: lengths as ``round(length * 2**32)``
(at most ``2**32 - 1``), the owner of every segment (-1 on a hole) and
the top level ``L`` of the ladder, the least with ``2**(s + L) >= n``
for ``n`` the last occupied segment's number plus its length.

``HierarchyModel`` composes two such tables, as a rack-aware cluster
does: a table of racks whose capacities are the sums of their nodes'
(kept equal to the sum after every change, in the order the nodes
changed), and one table per rack over its nodes.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

FULL = (2.0**32 - 1.0) / 2.0**32
EPS = 1e-12


class TableModel:
    """One segment table under a history of node additions, removals and
    resizes (owners are node ids)."""

    def __init__(self, s_log2: int = 1):
        self.s_log2 = s_log2
        self.lengths: list[float] = []
        self.owner: list[int] = []
        self.free: list[int] = []
        self.segments: dict[int, list[int]] = {}
        self.capacity: dict[int, float] = {}

    def _take(self) -> int:
        if self.free:
            return heapq.heappop(self.free)
        self.lengths.append(0.0)
        self.owner.append(-1)
        return len(self.lengths) - 1

    def _give(self, node: int, length: float) -> None:
        seg = self._take()
        self.lengths[seg] = length
        self.owner[seg] = node
        self.segments[node].append(seg)

    def _drop(self, seg: int) -> None:
        self.lengths[seg] = 0.0
        self.owner[seg] = -1
        heapq.heappush(self.free, seg)

    def add(self, node: int, capacity: float) -> None:
        if node in self.segments or capacity <= 0:
            raise ValueError(f"cannot add node {node} with capacity {capacity}")
        self.segments[node] = []
        remaining = float(capacity)
        while remaining > EPS:
            whole = remaining >= 1.0
            self._give(node, FULL if whole else remaining)
            remaining -= 1.0 if whole else remaining
        self.capacity[node] = float(capacity)

    def remove(self, node: int) -> None:
        for seg in self.segments.pop(node):
            self._drop(seg)
        del self.capacity[node]

    def resize(self, node: int, capacity: float) -> None:
        if capacity == self.capacity[node]:
            return
        segs = self.segments[node]
        lengths = [self.lengths[s] for s in segs]
        target = float(capacity)
        while sum(lengths) > target + EPS:
            excess = sum(lengths) - target
            if lengths[-1] <= excess + EPS:
                self._drop(segs.pop())
                lengths.pop()
            else:
                lengths[-1] -= excess
                self.lengths[segs[-1]] = lengths[-1]
        if lengths and lengths[-1] < FULL and sum(lengths) < target - EPS:
            lengths[-1] += min(FULL - lengths[-1], target - sum(lengths))
            self.lengths[segs[-1]] = lengths[-1]
        while sum(lengths) < target - EPS:
            rest = target - sum(lengths)
            length = FULL if rest >= 1.0 else rest
            self._give(node, length)
            lengths.append(length)
        self.capacity[node] = float(capacity)

    def total(self) -> float:
        return float(sum(self.capacity.values()))

    def arrays(self) -> tuple[np.ndarray, np.ndarray, int]:
        """``(len32, owner, top)``: u32 lengths as uint32, owners as
        int64, and the ladder's top level."""
        lengths = np.asarray(self.lengths, dtype=np.float64)
        len32 = np.minimum(np.round(lengths * 2.0**32), 2.0**32 - 1).astype(np.uint32)
        occupied = np.nonzero(lengths > 0)[0]
        last = int(occupied[-1])
        upper = last + float(lengths[last])
        top = max(0, int(math.ceil(math.log2(max(upper, 1.0)))) - self.s_log2)
        return len32, np.asarray(self.owner, dtype=np.int64), top


class HierarchyModel:
    """Racks of nodes: a table of racks and one table per rack."""

    def __init__(self, s_log2: int = 1):
        self.s_log2 = s_log2
        self.racks = TableModel(s_log2)
        self.nodes: dict[int, TableModel] = {}

    def add(self, rack: int, node: int, capacity: float) -> None:
        if rack not in self.nodes:
            self.nodes[rack] = TableModel(self.s_log2)
        self.nodes[rack].add(node, capacity)
        self._sync(rack)

    def remove(self, rack: int, node: int) -> None:
        self.nodes[rack].remove(node)
        self._sync(rack)

    def _sync(self, rack: int) -> None:
        now = self.nodes[rack].total()
        if rack not in self.racks.capacity:
            if now > 0:
                self.racks.add(rack, now)
        elif now == 0:
            self.racks.remove(rack)
        elif now != self.racks.capacity[rack]:
            self.racks.resize(rack, now)

    def rack_ids(self) -> list[int]:
        return sorted(self.racks.capacity)
