"""The ``bulk`` driver: one call places the whole population's R-replica
sets (``PlacementEngine.place_replica_nodes_device``; on a rack-aware
cluster ``place_replica_pairs_device``), calls back to back with
``in_flight`` of them queued, the window ending in a synchronize.

Mix parameters: ``in_flight``, ``profiled``.
"""

from __future__ import annotations

from collections import deque

import torch

from chipbench.harness import bounds, inputs, judge
from chipbench.harness.cells import CONTROL_NUMBER, Cell, mark, sync
from chipbench.reference.asura import Counts
from chipbench.reference.placement import flat_sets, rack_sets


class Driver(Cell):
    """Whole-population replica placement, calls back to back."""

    def setup(self) -> None:
        self.cluster = self.build_cluster()
        self.engine = self.cluster.engine
        self.ids = inputs.population(self.n, self.seed, self.dev)
        if self.racks:
            self.call = lambda: self.engine.place_replica_pairs_device(self.ids, self.R)
        else:
            self.call = lambda: self.engine.place_replica_nodes_device(self.ids, self.R)
        self.in_flight = int(self.traffic["in_flight"])
        # as many outputs alive at once as the window holds (those in
        # flight, the one waited for, the sampled one), so that the window
        # allocates nothing new
        held = [self.call() for _ in range(self.in_flight + 2)]
        sync(self.dev)
        del held
        self.ring: deque = deque()
        self.kept = None

    def install_control(self) -> None:
        model = self.reference_model()
        kw = dict(device=self.dev, number=CONTROL_NUMBER, **self.place_kw())
        place = rack_sets if self.racks else flat_sets
        self.call = lambda: place(self.ids, model, self.R, **kw).to(torch.int32)

    def unit(self, i: int) -> None:
        out = self.call()
        self.ring.append((out, mark(self.dev)))
        if i == self.sampled:
            self.kept = out
        if len(self.ring) > self.in_flight:
            self.ring.popleft()[1].synchronize()

    def summarize(self) -> None:
        self.last = self.ring[-1][0]
        self.ring.clear()
        self.attempted = self.units * self.n
        self.e2e["placed_ids_per_s"] = self.timed * self.n / self.elapsed

    def release(self) -> None:
        self.tables = self.engine.hier_artifact() if self.racks else self.engine.artifact()
        del self.cluster, self.engine, self.call

    def judge(self) -> dict:
        model = self.reference_model()
        kw = self.place_kw()
        if self.racks:
            c = (Counts(), Counts())
            want = rack_sets(self.ids, model, self.R, device=self.dev,
                             counts=c if self.trace else None, **kw)
            checks = {
                "tables": judge.rack_tables(self.tables, model),
                "sampled_racks": judge.differ(self.kept[0], want[0]),
                "sampled_nodes": judge.differ(self.kept[1], want[1]),
                "last_racks": judge.differ(self.last[0], want[0]),
                "last_nodes": judge.differ(self.last[1], want[1]),
            }
            if self.trace:
                rl, _, _ = model.racks.arrays()
                rows = [model.nodes[r].arrays()[0] for r in model.rack_ids()]
                nb, ops = bounds.rack_replicas(
                    self.n, self.R, len(rl), sum(len(r) for r in rows),
                    max(len(r) for r in rows), len(rows), c[0], c[1])
                self.least["B8"] = bounds.least_seconds(nb, ops)
        else:
            c = Counts()
            want = flat_sets(self.ids, model, self.R, device=self.dev,
                             counts=c if self.trace else None, **kw)
            checks = {
                "tables": judge.flat_table(self.tables, model),
                "sampled_sets": judge.differ(self.kept, want),
                "last_sets": judge.differ(self.last, want),
            }
            if self.trace:
                nb, ops = bounds.replicas(self.n, self.R, len(model.arrays()[0]), c)
                self.least["B2"] = bounds.least_seconds(nb, ops)
        return checks
