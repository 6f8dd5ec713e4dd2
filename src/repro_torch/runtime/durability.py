"""Event-driven durability simulation: years of failures in virtual time.

Why this exists: the hierarchical placement mode (DESIGN.md section 14)
claims failure-domain awareness buys DURABILITY -- that spreading R
replicas over R distinct racks turns a correlated whole-rack outage from a
data-loss event into a degraded-redundancy event.  This module measures
that claim with the repo's own recovery machinery instead of a closed-form
approximation: node and whole-domain failures arrive as counter-based
exponential draws on a virtual clock, each victim is repaired IN PLACE by
re-replicating its held rows through the existing ``MigrationDriver`` +
``ThrottledMover`` stack (detection via ``HeartbeatTracker``, one repair
in flight at a time, ingress-budgeted rounds), and an object is LOST the
instant every one of its R copies is simultaneously unavailable --
including copies whose restoring row has not yet landed mid-repair, so the
serialized repair queue after a correlated domain failure is exactly the
vulnerability window it is in production systems.

The failure trace is a pure function of (topology, seed, rates): two
placement policies over the same node set -- flat R-way vs domain-aware --
replay IDENTICAL failure times, so every durability delta is attributable
to placement alone (``compare_policies``).

The port's copy of the reference simulator.  The owners matrices come
out of the port engines once -- the flat policy's from the replica
kernel (B2), the domain-aware one's from the two-level kernel (B8), on
the card unless ``device="cpu"`` -- and the movement fractions from the
replica diffs (B4, and the two-level diff).  The event loop is host
NumPy, as in the reference: a few vectorized masks per failure.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np

from ..core.cluster import Cluster
from ..core.hierarchy import HierarchicalCluster
from ..core.rng import GOLDEN, KMULT, fmix32_np
from ..migrate import MigrationPlan, ThrottledMover
from ..migrate.mover import MigrationState
from .failures import HeartbeatTracker, MigrationDriver

SECONDS_PER_YEAR = 365.25 * 86_400.0


# -- deterministic failure trace ---------------------------------------------


def _u01_stream(seed: int, stream_id: int, n: int) -> np.ndarray:
    """n uniform (0, 1) draws for one entity's counter-based stream.

    Same fmix32 construction as the placement draws (core.rng): draw k of
    stream ``stream_id`` is ``fmix32(fmix32(seed ^ stream_id * GOLDEN) ^
    (k * KMULT))`` -- reproducible, order-free, and independent of every
    other stream.  The +0.5 offset keeps draws strictly inside (0, 1) so
    ``log`` below never sees 0.
    """
    with np.errstate(over="ignore"):
        base = fmix32_np(
            np.uint32(seed & 0xFFFFFFFF)
            ^ (np.uint32(stream_id & 0xFFFFFFFF) * np.uint32(GOLDEN))
        )
        ctrs = (np.arange(n, dtype=np.uint32) * np.uint32(KMULT)) ^ base
        return (fmix32_np(ctrs).astype(np.float64) + 0.5) * 2.0**-32


def _arrivals(seed: int, stream_id: int, mttf_s: float, horizon_s: float) -> np.ndarray:
    """Poisson arrival times in (0, horizon) for one failure stream."""
    if mttf_s <= 0 or not math.isfinite(mttf_s):
        return np.zeros(0, dtype=np.float64)
    # Draw enough exponentials to cross the horizon with slack, extend in
    # the (astronomically unlikely) case the batch still falls short.
    n = max(8, int(horizon_s / mttf_s * 2) + 8)
    while True:
        gaps = -np.log(_u01_stream(seed, stream_id, n)) * mttf_s
        times = np.cumsum(gaps)
        if times[-1] >= horizon_s:
            return times[times < horizon_s]
        n *= 2


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    time: float  # seconds since simulation start
    kind: str  # "node" | "domain"
    target: int  # node id, or domain id (kills every member node)


def failure_trace(
    node_domain: dict[int, int],
    *,
    years: float,
    mttf_node_years: float,
    mttf_domain_years: float,
    seed: int = 0,
) -> list[FailureEvent]:
    """The deterministic failure schedule for a topology.

    Every node and every domain gets an independent counter-based
    exponential stream keyed by (seed, entity id), so the trace depends
    only on the TOPOLOGY -- two placement policies over the same nodes
    replay the same failures.  Domain events model correlated outages
    (shared switch / PDU): every member node fails at the same instant.
    """
    horizon = years * SECONDS_PER_YEAR
    events: list[FailureEvent] = []
    for nid in sorted(node_domain):
        for t in _arrivals(seed, 2 * nid + 1, mttf_node_years * SECONDS_PER_YEAR, horizon):
            events.append(FailureEvent(float(t), "node", int(nid)))
    for did in sorted(set(node_domain.values())):
        for t in _arrivals(seed ^ 0x5BD1E995, 2 * did, mttf_domain_years * SECONDS_PER_YEAR, horizon):
            events.append(FailureEvent(float(t), "domain", int(did)))
    events.sort(key=lambda e: (e.time, e.kind, e.target))
    return events


# -- the event loop ----------------------------------------------------------


@dataclasses.dataclass
class DurabilityReport:
    years: float
    n_objects: int
    n_replicas: int
    n_nodes: int
    node_failures: int  # node-scoped failure events applied
    domain_failures: int  # correlated whole-domain events applied
    loss_incidents: int  # failure events that destroyed >= 1 object
    objects_lost: int  # distinct objects with all R copies gone
    rows_repaired: int  # (object, slot) copies re-replicated
    bytes_repaired: int
    repairs_completed: int
    max_repair_queue: int  # worst-case victims awaiting their window

    @property
    def data_loss_probability(self) -> float:
        return self.objects_lost / self.n_objects if self.n_objects else 0.0


class DurabilitySimulator:
    """Replay a failure trace against one placement's static owners matrix.

    ``owners`` is (n_objects, R) int node ids -- each row an object's
    replica set under the policy being scored.  ``node_domain`` maps every
    node to its failure domain.  Copies become unavailable when their node
    fails and come back row by row as the victim's repair lands them; an
    object whose R copies are simultaneously unavailable is lost for good
    (its rows leave the repair universe -- there is nothing to source).
    """

    def __init__(
        self,
        owners: np.ndarray,
        node_domain: dict[int, int],
        *,
        repair_ingress_rows: int = 2_000,
        round_seconds: float = 60.0,
        detect_timeout: float = 30.0,
        bytes_per_row: int = 1 << 22,
        ledger=None,
    ):
        self.owners = np.asarray(owners, dtype=np.int64)
        if self.owners.ndim != 2:
            raise ValueError("owners must be (n_objects, n_replicas)")
        self.node_domain = dict(node_domain)
        self.n_objects, self.n_replicas = self.owners.shape
        self.repair_ingress_rows = int(repair_ingress_rows)
        self.round_seconds = float(round_seconds)
        self.detect_timeout = float(detect_timeout)
        self.bytes_per_row = int(bytes_per_row)
        self.ledger = ledger
        self.now = 0.0
        self.alive: set[int] = set(self.node_domain)
        # copy_ok[o, r]: object o's slot-r copy is live on its owner
        self.copy_ok = np.ones(self.owners.shape, dtype=bool)
        self.lost = np.zeros(self.n_objects, dtype=bool)
        self.loss_incidents = 0
        self.rows_repaired = 0
        self.repairs_completed = 0
        self.max_repair_queue = 0
        self.node_failures = 0
        self.domain_failures = 0
        self.tracker = HeartbeatTracker(timeout=self.detect_timeout, clock=lambda: self.now)
        self.driver = MigrationDriver(self.tracker, self._start_repair)
        self._victim_of: dict[int, int] = {}  # id(mover) -> node id
        for nid in self.alive:
            self.tracker.beat(nid)

    # -- repair wiring (the existing migrate/runtime stack) -------------------

    def _start_repair(self, victim: int):
        """Victim -> a ThrottledMover restoring every row it held.

        The plan's unit is the (object, slot) row, dst = the victim
        (repair-in-place), src = a surviving holder of the same object --
        the mover's ingress budget on the victim is the repair bandwidth,
        and its injected clock is the simulation clock, so repair DURATION
        is rows / bandwidth in virtual time.
        """
        obj, slot = np.nonzero((self.owners == victim) & ~self.lost[:, None])
        # Source each row from a currently-live copy of the same object;
        # rows with no live source are exactly the lost objects (already
        # accounted) -- nothing to restore.
        ok = self.copy_ok[obj]
        ok[np.arange(obj.size), slot] = False  # not from the dead copy itself
        has_src = ok.any(axis=1)
        obj, slot, ok = obj[has_src], slot[has_src], ok[has_src]
        src_slot = np.argmax(ok, axis=1).astype(np.int32)
        plan = MigrationPlan(
            v_from=0,
            v_to=0,
            ids=obj.astype(np.uint32),
            src=self.owners[obj, src_slot],
            dst=np.full(obj.size, victim, dtype=np.int64),
            index=np.arange(obj.size, dtype=np.int64),
            n_scanned=self.n_objects,
            n_replicas=self.n_replicas,
            slot=slot.astype(np.int32),
            src_slot=src_slot,
        )
        mover = ThrottledMover(
            MigrationState(plan),
            ingress=self.repair_ingress_rows,
            clock=lambda: self.now,
            round_seconds=self.round_seconds,
            ledger=self.ledger,
            bytes_per_row=self.bytes_per_row,
        )
        self._victim_of[id(mover)] = victim
        return mover

    # -- availability bookkeeping ---------------------------------------------

    def _absorb(self, mover) -> None:
        state = mover.state
        landed = state.landed
        if landed.any():
            self.copy_ok[
                state.plan.ids[landed].astype(np.int64), state.plan.slot[landed]
            ] = True

    def _absorb_landed(self) -> None:
        """Fold repairs' landed rows back into copy_ok: the in-flight
        mover's partial progress AND any mover the driver retired inside
        its own pump (retirement precedes this hook)."""
        for mover in self.driver.active:
            self._absorb(mover)
        self._retire_completed()

    def _retire_completed(self) -> None:
        for mover in self.driver.completed:
            victim = self._victim_of.pop(id(mover), None)
            if victim is None:
                continue  # already processed on an earlier pass
            self._absorb(mover)
            self.repairs_completed += 1
            self.rows_repaired += int(mover.state.landed.sum())
            self.alive.add(victim)
            self.tracker.beat(victim)
            self.driver.notify_recovered(victim)  # re-arm its detection

    def _pump_to(self, t: float) -> None:
        """Advance virtual time to ``t``, draining due repair rounds.

        The queue is SERIALIZED, so time must step through it: each pass
        pumps the in-flight repair's due rounds (a finished one retires
        and the next queued victim's repair starts at that instant), then
        jumps the clock straight to the next round boundary -- no
        round-by-round polling across the (weeks-long) quiet gaps, but
        queued repairs still run back to back in virtual time instead of
        waiting for the next failure to be observed.
        """
        while True:
            self.driver.pump()
            self._absorb_landed()
            if self.driver.done:
                break
            active = self.driver.active
            if not active:
                continue  # a queued repair just started; pump it next pass
            next_due = active[0].next_round_at
            if next_due is None or next_due > t:
                break
            self.now = next_due
        self.now = t
        for nid in self.alive:
            self.tracker.beat(nid)

    def _fail_nodes(self, victims: Iterable[int]) -> None:
        newly = [v for v in victims if v in self.alive]
        if not newly:
            return
        for v in newly:
            self.alive.discard(v)  # stops beating -> tracker flags it
        mask = np.isin(self.owners, newly)
        self.copy_ok[mask] = False
        fresh = ~self.copy_ok.any(axis=1) & ~self.lost
        if fresh.any():
            self.loss_incidents += 1
            self.lost |= fresh
        # Detection: the victims miss ``detect_timeout`` of heartbeats,
        # then the driver queues their serialized repairs.  The survivors
        # kept beating through the detection window.
        self.now += self.detect_timeout * 1.001
        for nid in self.alive:
            self.tracker.beat(nid)
        self.driver.poll()
        self.max_repair_queue = max(
            self.max_repair_queue, len(self.driver.queued) + len(self.driver.active)
        )

    # -- entry point -----------------------------------------------------------

    def run(self, events: list[FailureEvent], *, years: float) -> DurabilityReport:
        for ev in events:
            self._pump_to(ev.time)
            if ev.kind == "node":
                self.node_failures += 1
                self._fail_nodes([ev.target])
            else:
                self.domain_failures += 1
                self._fail_nodes(
                    [n for n, d in self.node_domain.items() if d == ev.target]
                )
        # drain the tail: every queued repair completes after the last event
        self.now += self.round_seconds
        while not self.driver.done:
            self.driver.round()
            self._absorb_landed()
        return DurabilityReport(
            years=years,
            n_objects=self.n_objects,
            n_replicas=self.n_replicas,
            n_nodes=len(self.node_domain),
            node_failures=self.node_failures,
            domain_failures=self.domain_failures,
            loss_incidents=self.loss_incidents,
            objects_lost=int(self.lost.sum()),
            rows_repaired=self.rows_repaired,
            bytes_repaired=self.rows_repaired * self.bytes_per_row,
            repairs_completed=self.repairs_completed,
            max_repair_queue=self.max_repair_queue,
        )


# -- policy comparison (the benchmark's core) ---------------------------------


def _topology_clusters(topology: dict[int, dict[int, float]], device=None):
    """(flat Cluster, HierarchicalCluster) over the same node ids, their
    engines on ``device`` (None: the card)."""
    flat = Cluster(device=device)
    hier = HierarchicalCluster(device=device)
    for did, members in topology.items():
        for nid, cap in members.items():
            flat.add_node(nid, cap)
            hier.add_node(did, nid, cap)
    return flat, hier


def compare_policies(
    topology: dict[int, dict[int, float]],
    *,
    n_objects: int = 50_000,
    n_replicas: int = 3,
    years: float = 10.0,
    mttf_node_years: float = 4.0,
    mttf_domain_years: float = 25.0,
    seed: int = 0,
    repair_ingress_rows: int = 2_000,
    round_seconds: float = 60.0,
    detect_timeout: float = 30.0,
    bytes_per_row: int = 1 << 22,
    device=None,
) -> dict[str, DurabilityReport]:
    """Flat R-way vs domain-aware placement under IDENTICAL failure traces.

    ``topology`` is {domain: {node: capacity}}.  Both policies place the
    same ``n_objects`` ids over the same nodes; the flat policy ignores
    domains (so a correlated domain failure can take out all R copies of
    an object whose replicas happened to co-reside), the hierarchical
    policy pins the R copies to R distinct domains (at most one copy per
    domain event).  Returns ``{"flat": report, "hier": report}``.  The
    owners are placed on ``device`` (None: the card).
    """
    flat, hier = _topology_clusters(topology, device)
    node_domain = hier.node_domains()
    ids = np.arange(n_objects, dtype=np.uint32)
    owners_flat = flat.engine.place_replica_nodes(ids, n_replicas)
    owners_hier = hier.engine.place_replica_pairs(ids, n_replicas)[:, :, 1]
    events = failure_trace(
        node_domain,
        years=years,
        mttf_node_years=mttf_node_years,
        mttf_domain_years=mttf_domain_years,
        seed=seed,
    )
    out: dict[str, DurabilityReport] = {}
    for name, owners in (("flat", owners_flat), ("hier", owners_hier)):
        sim = DurabilitySimulator(
            owners,
            node_domain,
            repair_ingress_rows=repair_ingress_rows,
            round_seconds=round_seconds,
            detect_timeout=detect_timeout,
            bytes_per_row=bytes_per_row,
        )
        out[name] = sim.run(events, years=years)
    return out


def movement_on_node_add(
    topology: dict[int, dict[int, float]],
    *,
    n_objects: int = 50_000,
    n_replicas: int = 3,
    add_domain: int | None = None,
    add_capacity: float = 1.0,
    device=None,
) -> dict[str, float]:
    """Fraction of replica rows moved by one node add, per policy.

    The "equal movement cost" half of the durability headline: domain
    awareness must not give back ASURA's minimal-movement property.  Both
    policies add the SAME node (same id, same capacity; the hierarchical
    one inside ``add_domain``, default: the first domain) and the moved
    fraction is rows-moved / total replica rows, via each engine's fused
    replica diff on ``device`` (None: the card).
    """
    flat, hier = _topology_clusters(topology, device)
    if add_domain is None:
        add_domain = sorted(topology)[0]
    new_id = max(hier.node_domains()) + 1
    ids = np.arange(n_objects, dtype=np.uint32)
    out: dict[str, float] = {}

    flat.engine.artifact()
    v0 = flat.version
    flat.add_node(new_id, add_capacity)
    moved, _, _, _ = flat.engine.diff_replicas_at(ids, v0, flat.version, n_replicas)
    out["flat"] = float(np.asarray(moved).sum()) / (n_objects * n_replicas)

    hier.engine.hier_artifact()
    w0 = hier.version
    hier.add_node(add_domain, new_id, add_capacity)
    moved_h, _, _, _ = hier.engine.diff_replicas_at(ids, w0, hier.version, n_replicas)
    out["hier"] = float(np.asarray(moved_h).sum()) / (n_objects * n_replicas)
    return out


__all__ = [
    "DurabilityReport",
    "DurabilitySimulator",
    "FailureEvent",
    "compare_policies",
    "failure_trace",
    "movement_on_node_add",
]
