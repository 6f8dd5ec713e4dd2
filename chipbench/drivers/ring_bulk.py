"""The ``ring_bulk`` driver: the ``bulk`` driver's calls, window and metric
on a consistent-hashing ring.  The engine is
``PlacementEngine(cluster, algorithm=..., virtual_nodes=...)`` with the
configuration's ``algorithm`` (``"ch"``) and ``virtual_nodes``; one call
places the whole population's R-replica sets
(``place_replica_nodes_device``), calls back to back with ``in_flight``
of them queued, the window ending in a synchronize.  The judge holds the
ring the kernel read and the sets of the sampled and the last call to
``reference/ring.py``.

Mix parameters: ``in_flight``, ``profiled``.
"""

from __future__ import annotations

from collections import deque

import torch

from chipbench.harness import bounds, inputs, judge, ring_bounds, spec
from chipbench.harness.cells import CONTROL_NUMBER, sync
from chipbench.reference.asura import M32
from chipbench.reference.ring import Counts, ring, ring_sets

bulk = spec.load("drivers", "bulk")


def ring_tables(art, points: torch.Tensor, owners: torch.Tensor) -> int:
    """Entries of the device ring (points, owners) that differ from the
    reference's; the lane padding past the ring must send a lookup to the
    wrap target (point 0xFFFFFFFF, the first point's owner)."""
    n = int(points.shape[0])
    got_points, got_owners = art.keys_dev, art.vals_dev
    bad = judge.differ(got_points[:n], points) + judge.differ(got_owners[:n], owners)
    pad_points, pad_owners = got_points[n:], got_owners[n:]
    bad += judge.differ(pad_points, torch.full(pad_points.shape, M32, dtype=torch.int64))
    bad += judge.differ(pad_owners, torch.full(pad_owners.shape, int(owners[0]), dtype=torch.int64))
    return bad


class Driver(bulk.Driver):
    """Whole-population replica placement on a consistent-hashing ring."""

    def setup(self) -> None:
        from repro_torch.core import PlacementEngine

        algorithm = self.config["algorithm"]
        if algorithm != "ch" or self.racks:
            raise ValueError(f"ring_bulk runs a flat 'ch' cluster, not "
                             f"{self.config['layout']!r} {algorithm!r}")
        self.cluster = self.build_cluster()
        self.engine = PlacementEngine(self.cluster, device=self.dev, algorithm=algorithm,
                                      virtual_nodes=int(self.config["virtual_nodes"]))
        self.ids = inputs.population(self.n, self.seed, self.dev)
        self.call = lambda: self.engine.place_replica_nodes_device(self.ids, self.R)
        self.in_flight = int(self.traffic["in_flight"])
        # as many outputs alive at once as the window holds, as in ``bulk``
        held = [self.call() for _ in range(self.in_flight + 2)]
        sync(self.dev)
        del held
        self.ring: deque = deque()
        self.kept = None

    def reference_ring(self) -> tuple[torch.Tensor, torch.Tensor]:
        nodes = [node for _, node, _ in self.layout()]
        return ring(nodes, int(self.config["virtual_nodes"]), device=self.dev)

    def install_control(self) -> None:
        points, owners = self.reference_ring()
        self.call = lambda: ring_sets(self.ids, points, owners, self.R,
                                      number=CONTROL_NUMBER).to(torch.int32)

    def judge(self) -> dict:
        points, owners = self.reference_ring()
        c = Counts()
        want = ring_sets(self.ids, points, owners, self.R, counts=c if self.trace else None)
        checks = {
            "tables": ring_tables(self.tables, points.cpu(), owners.cpu()),
            "sampled_sets": judge.differ(self.kept, want),
            "last_sets": judge.differ(self.last, want),
        }
        if self.trace:
            nb, ops = ring_bounds.fanout(self.n, self.R, int(points.shape[0]), c)
            self.least["FANOUT"] = bounds.least_seconds(nb, ops)
        return checks
