"""The ``serve`` driver: a closed loop of one client.  Batches from a pool
of YCSB requests drawn in set-up go through
``RequestStreamDriver.route_batch``, each waited for before the next.

Mix parameters: ``batch``, ``pool_batches``, ``policy``, ``warmup``,
``profiled`` and the YCSB key chooser's (``harness/ycsb.py``).
"""

from __future__ import annotations

import statistics
import time

import torch

from chipbench.harness import inputs, judge
from chipbench.harness.cells import CONTROL_NUMBER, Cell, sync
from chipbench.harness.ycsb import scrambled_zipfian
from chipbench.reference.placement import flat_sets, serve_batch, service_rate
from chipbench.reference.threefry import stream_key


class _Server:
    """The serving rule over the control's replica sets, in the driver's
    place."""

    def __init__(self, cell, model):
        self.cell, self.model = cell, model
        self.counts = torch.zeros(cell.n_nodes, dtype=torch.int64, device=cell.dev)
        self.queue = torch.zeros_like(self.counts)
        self.step = 0
        self.key = stream_key(cell.stream_seed)
        self.service = service_rate(cell.batch, cell.n_nodes)

    def route_batch(self, ids):
        owners = flat_sets(ids, self.model, self.cell.R, device=self.cell.dev,
                           number=CONTROL_NUMBER, **self.cell.place_kw())
        chosen, self.counts, self.queue = serve_batch(owners, self.key, self.step, self.counts,
                                                      self.queue, self.service)
        self.step += 1
        return chosen


class Driver(Cell):
    """A closed loop of one client over a pool of YCSB request batches."""

    def setup(self) -> None:
        from repro_torch.serve import RequestStreamDriver

        t = self.traffic
        self.batch = int(t["batch"])
        self.cluster = self.build_cluster()
        self.engine = self.cluster.engine
        self.stream_seed = inputs.stream_seed(self.seed)
        self.driver = RequestStreamDriver(
            self.engine, batch=self.batch, n_replicas=self.R, policy=t["policy"],
            seed=self.stream_seed,
        )
        self.pool = self.make_pool()
        self.restart()
        for i in range(int(t.get("warmup", 2))):
            self.serve(i, "start" if i == 0 else None)
        sync(self.dev)
        self.latency: list[float] = []

    def restart(self) -> None:
        self.order: list[int] = []  # the pool batch of each batch served, in stream order
        self.records: dict[str, dict] = {}

    def install_control(self) -> None:
        self.driver = _Server(self, self.reference_model())
        self.restart()
        self.serve(0, "start")

    def make_pool(self) -> list[torch.Tensor]:
        """``pool_batches`` batches of request ids, keys from YCSB's
        scrambled zipfian, drawn on the device from the seed."""
        t = self.traffic
        pop = inputs.population(self.n, self.seed, self.dev).view(torch.int32)
        g = inputs.device_generator(self.seed, 6, self.dev)
        pool = []
        for _ in range(int(t["pool_batches"])):
            u = torch.rand(self.batch, dtype=torch.float64, generator=g, device=self.dev)
            keys = scrambled_zipfian(u, self.n, t)
            pool.append(pop[keys].view(torch.uint32))
        return pool

    def serve(self, i: int, keep: str | None):
        p = i % len(self.pool)
        t0 = time.perf_counter()
        chosen = self.driver.route_batch(self.pool[p])
        t1 = time.perf_counter()
        record = dict(step=len(self.order), chosen=chosen, counts=self.driver.counts,
                      queue=self.driver.queue)
        self.order.append(p)
        if keep is not None:
            self.records[keep] = record
        self.records["last"] = record
        return t0, t1

    def unit(self, i: int) -> None:
        t0, t1 = self.serve(i, "sampled" if i == self.sampled else None)
        sync(self.dev)
        t2 = time.perf_counter()
        self.latency.append(t2 - t0)
        if i >= self.profiled:
            self.span("route_batch", t1 - t0)

    def summarize(self) -> None:
        lat = sorted(self.latency)
        self.attempted = self.units * self.batch
        self.e2e["served_ids_per_s"] = self.timed * self.batch / self.elapsed
        self.e2e["serve_batch_p95_ms"] = 1e3 * statistics.quantiles(lat, n=20)[-1] if len(lat) > 1 else 1e3 * lat[0]

    def release(self) -> None:
        self.tables = self.engine.artifact()
        del self.driver, self.engine, self.cluster

    def judge(self) -> dict:
        """The reference serves every batch of the stream again from its own
        empty state; the recorded batches' choices, counts and queues (the
        last batch's are the program's final state) are compared."""
        model = self.reference_model()
        kw = self.place_kw()
        key = stream_key(self.stream_seed)
        service = service_rate(self.batch, self.n_nodes)
        checks = {"tables": judge.flat_table(self.tables, model)}
        at = {}
        for name, rec in self.records.items():
            at.setdefault(rec["step"], []).append((name, rec))
        owners: dict[int, torch.Tensor] = {}
        counts = torch.zeros(self.n_nodes, dtype=torch.int64, device=self.dev)
        queue = counts
        for step, p in enumerate(self.order):
            if p not in owners:
                owners[p] = flat_sets(self.pool[p], model, self.R, device=self.dev, **kw)
            chosen, counts, queue = serve_batch(owners[p], key, step, counts, queue, service)
            for name, rec in at.get(step, ()):
                checks[f"{name}_chosen"] = judge.differ(rec["chosen"], chosen)
                checks[f"{name}_counts"] = judge.differ(rec["counts"], counts)
                checks[f"{name}_queues"] = judge.differ(rec["queue"], queue)
        return checks
