"""The ``scale`` driver: membership changes on a flat cluster, alternately
adding a node (its capacity drawn once from the configuration's law) and
removing it again, each planned over every tracked id with
``MigrationPlanner.plan_replicas_stream`` and its moved rows counted on
the device.

Mix parameters: ``chunk``, ``fuse``, ``warmup``, ``profiled``.
"""

from __future__ import annotations

import time
import types

import torch

from chipbench.harness import bounds, inputs, judge
from chipbench.harness.cells import CONTROL_NUMBER, Cell, sync
from chipbench.reference.asura import Counts
from chipbench.reference.placement import align, flat_sets


class _Planner:
    """A scale event's diff over the control's replica sets, in the
    planner's place (one chunk of the whole population)."""

    def __init__(self, cell, model):
        self.cell, self.model = cell, model

    def plan_replicas_stream(self, chunks, v_from, v_to, R, fuse=1):
        c = self.cell
        ids = torch.cat(list(chunks))
        kw = dict(device=c.dev, number=CONTROL_NUMBER, **c.place_kw())
        before = flat_sets(ids, self.before, R, **kw)
        after = flat_sets(ids, self.model.arrays(), R, **kw)
        yield (ids, *align(before, after))


class _Cluster:
    """Membership changes applied to the reference's own table model."""

    def __init__(self, model, planner):
        self.model, self.planner, self.version = model, planner, 0

    def add_node(self, node, cap):
        self.planner.before = self.model.arrays()
        self.model.add(node, cap)
        self.version += 1

    def remove_node(self, node):
        self.planner.before = self.model.arrays()
        self.model.remove(node)
        self.version += 1


class _Engine:
    """The reference's tables as an artifact the judge can read."""

    def __init__(self, cluster):
        self.cluster = cluster

    def artifact(self):
        len32, owner, top = self.cluster.model.arrays()
        cum = torch.cumsum(torch.from_numpy(len32.astype("int64")), 0)
        return types.SimpleNamespace(
            version=self.cluster.version, len32=len32, node_of=owner, top_level=top,
            len32_dev=torch.from_numpy(len32.astype("int64")),
            node_of_dev=torch.from_numpy(owner), cum_hi_dev=cum >> 32, cum_lo_dev=cum & 0xFFFFFFFF,
        )


class Driver(Cell):
    """Alternate scale events: add a node, then remove it again."""

    def setup(self) -> None:
        from repro_torch.migrate import MigrationPlanner

        t = self.traffic
        if self.racks:
            raise ValueError("the scale driver changes a flat cluster's membership")
        self.cluster = self.build_cluster()
        self.engine = self.cluster.engine
        self.planner = MigrationPlanner(self.engine)
        self.ids = inputs.population(self.n, self.seed, self.dev)
        chunk = int(t["chunk"])
        self.chunks = [self.ids[i : i + chunk] for i in range(0, self.n, chunk)]
        self.fuse = int(t["fuse"])
        self.node = self.n_nodes  # the joining node's id
        self.cap = float(self.capacities(1, 2)[0])
        self.history: list[dict] = []
        self.kept: dict[str, dict] = {}
        self.engine.artifact()
        # warm-up events keep their outputs until all have run, so that the
        # allocator holds the sets the window keeps alive at once
        for _ in range(int(t.get("warmup", 2))):
            self.event(window=False)
        sync(self.dev)
        for rec in self.history:
            rec["outs"] = rec["art"] = None

    def install_control(self) -> None:
        planner = _Planner(self, self.reference_model())
        self.cluster = _Cluster(planner.model, planner)
        self.engine = _Engine(self.cluster)
        self.planner = planner
        self.history = []
        self.kept = {}

    def event(self, window: bool) -> dict:
        e = len(self.history)
        adding = e % 2 == 0
        self.engine.artifact()  # the version before the change stays cached
        v = self.cluster.version
        t0 = time.perf_counter()
        if adding:
            self.cluster.add_node(self.node, self.cap)
        else:
            self.cluster.remove_node(self.node)
        art = self.engine.artifact()
        t1 = time.perf_counter()
        total = torch.zeros((), dtype=torch.int64, device=self.dev)
        outs = []
        for _, moved, src, dst, src_slot in self.planner.plan_replicas_stream(
            self.chunks, v, art.version, self.R, fuse=self.fuse
        ):
            total += moved.sum()
            outs.append((moved, src, dst, src_slot))
        moved = int(total)
        t2 = time.perf_counter()
        rec = dict(adding=adding, moved=moved, window=window,
                   len32=art.len32, node_of=art.node_of, top=art.top_level,
                   art=art, outs=outs, table_s=t1 - t0, event_s=t2 - t0)
        self.history.append(rec)
        if e > 0 and window:  # only the newest event keeps its outputs and device tables
            prev = self.history[e - 1]
            if prev is not self.kept.get("sampled"):
                prev["outs"] = prev["art"] = None
        return rec

    def unit(self, i: int) -> None:
        rec = self.event(window=True)
        if i == self.sampled:
            self.kept["sampled"] = rec
        if i >= self.profiled:
            self.span("table", rec["table_s"])
            self.span("plan", rec["event_s"] - rec["table_s"])

    def summarize(self) -> None:
        self.kept["last"] = self.history[-1]
        self.attempted = self.units
        self.e2e["plan_ms"] = 1e3 * self.elapsed / self.timed

    def release(self) -> None:
        del self.planner, self.engine, self.cluster

    def judge(self) -> dict:
        kw = self.place_kw()
        model = self.reference_model()
        checks = {"tables": 0, "sampled_moved": 0, "sampled_src": 0, "sampled_dst": 0,
                  "sampled_src_slot": 0, "sampled_count": 0, "wrong_way_rows": 0}
        targets = {id(rec): name for name, rec in self.kept.items()}
        for rec in self.history:
            before = model.arrays()
            if rec["adding"]:
                model.add(self.node, self.cap)
            else:
                model.remove(self.node)
            checks["tables"] += judge.flat_table_host(rec["len32"], rec["node_of"], rec["top"], model)
            name = targets.get(id(rec))
            if name is None:
                continue
            after = model.arrays()
            checks["tables"] += judge.flat_table(rec["art"], model)
            cb, ca = Counts(), Counts()
            old = flat_sets(self.ids, before, self.R, device=self.dev, counts=cb, **kw)
            new = flat_sets(self.ids, after, self.R, device=self.dev, counts=ca, **kw)
            want = align(old, new)
            got = [torch.cat([o[f] for o in rec["outs"]]) for f in range(4)]
            pre = "sampled" if name == "sampled" else "last"
            for f, field in enumerate(("moved", "src", "dst", "src_slot")):
                checks[f"{pre}_{field}"] = checks.get(f"{pre}_{field}", 0) + judge.differ(got[f], want[f])
            checks[f"{pre}_count"] = abs(rec["moved"] - int(want[0].sum()))
            m = got[0]
            side = got[2] if rec["adding"] else got[1]
            checks["wrong_way_rows"] += int((m & (side.to(torch.int64) != self.node)).sum())
            if self.trace and name == "sampled":
                nb, ops = bounds.diff_replicas(self.n, self.R, (len(before[0]), len(after[0])), cb, ca)
                self.least["B4"] = bounds.least_seconds(nb, ops)
            rec["outs"] = None
        pairs = [(self.history[i], self.history[i + 1]) for i in range(0, len(self.history) - 1, 2)]
        checks["pair_counts"] = sum(a["moved"] != b["moved"] for a, b in pairs)
        return checks
