"""What every driver shares, and the driver a traffic mix names.

A traffic mix (``traffic/<mix>.json``) names its driver by ``driver``:
the file ``drivers/<driver>.py``, whose class ``Driver`` subclasses
``Cell`` here.  A configuration names its capacity law by
``capacity_law.kind``: the file ``laws/<kind>.py``.  Both are found by
name, so a new driver or law is a new file and edits nothing here.

A driver builds the program's objects from the configuration and the
seed (``setup``), runs the measured window (``window``, which calls its
``unit`` again and again), lets go of what the judge does not read
(``release``) and compares what the window produced with the plain
reference (``judge``, a dict of counts whose limit is 0).  Its
``install_control`` puts the reference, computed with the control's
number (``CONTROL_NUMBER``), in the program's place after ``setup``.  It
records every number the metrics read: the end-to-end values, host spans
around its calls into the program, and with ``trace`` a profile of the
window's first ``profiled`` units and the least time of the checked
unit's kernels.
"""

from __future__ import annotations

import time

import torch

from chipbench.harness import inputs, spec
from chipbench.harness.trace import Profile
from chipbench.reference.tables import HierarchyModel, TableModel

# the control's ASURA number: formed and tested in float32, the precision
# below the configurations' exact u32 fixed point
CONTROL_NUMBER = "float32"


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Done:
    def synchronize(self) -> None:
        pass


def mark(dev):
    """An event recorded on the current stream (a no-op on the CPU)."""
    if dev.type != "cuda":
        return _Done()
    e = torch.cuda.Event()
    e.record()
    return e


class Cell:
    """The cluster of the configuration, the population and the measured
    window's bookkeeping."""

    kind = "cell"  # the driver's file name, set by ``make``

    def __init__(self, config: dict, traffic: dict, seed: int, dev, trace: bool):
        self.config, self.traffic = config, traffic
        self.seed, self.dev, self.trace = int(seed), dev, bool(trace)
        self.R = int(config["replicas"])
        self.n = int(config["population"])
        self.profiled = int(traffic.get("profiled", 8))
        self.e2e: dict[str, float] = {}
        self.spans: dict[str, list[float]] = {}
        self.least: dict[str, float] = {}
        self.profile: Profile | None = None
        self.attempted = 0
        pick = inputs.rng(seed, 5)
        self.sampled = int(pick.integers(0, self.profiled))

    # -- the program's cluster -------------------------------------------------

    @property
    def racks(self) -> bool:
        return self.config["layout"] == "racks"

    def capacities(self, n: int, stream: int):
        """``n`` capacities drawn from the configuration's law."""
        law = self.config["capacity_law"]
        return spec.load("laws", law["kind"]).draw(law, n, inputs.rng(self.seed, stream))

    def layout(self) -> list[tuple[int, int, float]]:
        """(rack, node, capacity) in the order the nodes join (rack -1: a
        flat cluster)."""
        c = self.config
        if self.racks:
            per = int(c["nodes_per_rack"])
            n_nodes = int(c["racks"]) * per
        else:
            n_nodes = int(c["nodes"])
        caps = self.capacities(n_nodes, 1)
        if self.racks:
            return [(node // per, node, float(caps[node])) for node in range(n_nodes)]
        return [(-1, node, float(caps[node])) for node in range(n_nodes)]

    def build_cluster(self):
        from repro_torch.core import AsuraParams, HierarchicalCluster, make_cluster

        c = self.config
        params = AsuraParams(s_log2=int(c["s_log2"]), max_draws=int(c["max_draws"]))
        joins = self.layout()
        if self.racks:
            cluster = HierarchicalCluster(params, device=self.dev)
            for rack, node, cap in joins:
                cluster.add_node(rack, node, cap)
        else:
            cluster = make_cluster([cap for _, _, cap in joins], params, device=self.dev)
        self.n_nodes = len(joins)
        return cluster

    def reference_model(self):
        s = int(self.config["s_log2"])
        model = HierarchyModel(s) if self.racks else TableModel(s)
        for rack, node, cap in self.layout():
            if self.racks:
                model.add(rack, node, cap)
            else:
                model.add(node, cap)
        return model

    def place_kw(self) -> dict:
        return dict(s_log2=int(self.config["s_log2"]), max_draws=int(self.config["max_draws"]))

    # -- the window ------------------------------------------------------------

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def window(self, seconds: float) -> None:
        """Run units until ``seconds`` have passed, and at least the
        sampled one (and, traced, the profiled ones)."""
        self.least_units = max(self.sampled + 1, self.profiled if self.trace else 1)
        units = 0
        if self.trace:  # the profiled units first; the profiler's reading is not timed
            with Profile(self.dev) as self.profile:
                self.unit(-1)  # a primer: the profiler's first buffers fall outside the window
                while units < self.profiled:
                    with self.profile.unit():
                        self.unit(units)
                    units += 1
        first = units
        self.unit_s: list[float] = []  # each timed unit's host time, for the result's spread
        t0 = now = time.perf_counter()
        while True:
            self.unit(units)
            units += 1
            then, now = now, time.perf_counter()
            self.unit_s.append(now - then)
            if now - t0 >= seconds and units >= self.least_units:
                break
        self.finish()
        self.elapsed = time.perf_counter() - t0
        self.units = units
        self.timed = units - first
        self.summarize()

    def finish(self) -> None:
        sync(self.dev)

    def release(self) -> None:
        """Drop the program's objects that the judge does not read."""


def make(config: dict, traffic: dict, seed: int, dev, trace: bool) -> Cell:
    """The driver that ``traffic`` names, set up for nothing yet."""
    cls = spec.load("drivers", traffic["driver"]).Driver
    cell = cls(config, traffic, seed, dev, trace)
    cell.kind = traffic["driver"]
    return cell
