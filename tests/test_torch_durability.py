"""The port's durability simulator against the reference, on the CPU.

Each test of ``tests/test_durability.py`` runs on both packages: the same
failure traces, and ``DurabilityReport``s, lost / copy masks and movement
fractions compared with ``==``.  The port places its owners with its own
engines on ``device="cpu"`` (the replica kernel's twin for the flat
policy, the two-level kernel's twin for the domain-aware one); the event
loop is host NumPy in both.
"""

import numpy as np
import pytest

from repro.runtime import durability as jdur
from repro_torch.runtime.durability import (
    SECONDS_PER_YEAR,
    DurabilityReport,
    DurabilitySimulator,
    FailureEvent,
    compare_policies,
    failure_trace,
    movement_on_node_add,
)

TOPO = {d: {d * 4 + i: 1.0 for i in range(4)} for d in range(6)}
NODE_DOMAIN = {n: d for d, members in TOPO.items() for n in members}


def _j_events(events):
    return [jdur.FailureEvent(e.time, e.kind, e.target) for e in events]


def _same_report(got: DurabilityReport, want) -> None:
    assert type(got).__name__ == type(want).__name__
    assert vars(got) == vars(want)


# ---------------------------------------------------------------------------
# The deterministic failure trace
# ---------------------------------------------------------------------------


def test_trace_deterministic_sorted_and_bounded():
    kw = dict(years=5.0, mttf_node_years=3.0, mttf_domain_years=15.0, seed=3)
    t1 = failure_trace(NODE_DOMAIN, **kw)
    t2 = failure_trace(NODE_DOMAIN, **kw)
    assert t1 == t2  # pure function of (topology, rates, seed)
    assert [(e.time, e.kind, e.target) for e in t1] == [
        (e.time, e.kind, e.target) for e in jdur.failure_trace(NODE_DOMAIN, **kw)]
    times = [e.time for e in t1]
    assert times == sorted(times)
    assert all(0.0 <= t < 5.0 * SECONDS_PER_YEAR for t in times)
    kinds = {e.kind for e in t1}
    assert kinds <= {"node", "domain"}
    assert "node" in kinds and "domain" in kinds
    for e in t1:
        pool = NODE_DOMAIN if e.kind == "node" else set(NODE_DOMAIN.values())
        assert e.target in pool


def test_trace_changes_with_seed():
    kw = dict(years=5.0, mttf_node_years=3.0, mttf_domain_years=15.0)
    assert failure_trace(NODE_DOMAIN, seed=1, **kw) != failure_trace(
        NODE_DOMAIN, seed=2, **kw)


# ---------------------------------------------------------------------------
# Single-simulator behavior, each run on both packages
# ---------------------------------------------------------------------------


def _both(owners, events, **kw):
    """(port simulator, port report), after checking the reference's
    simulator on the same owners and events gives the same report and
    the same final masks."""
    sim = DurabilitySimulator(np.asarray(owners), NODE_DOMAIN, **kw)
    report = sim.run(events, years=1.0)
    jsim = jdur.DurabilitySimulator(np.asarray(owners), NODE_DOMAIN, **kw)
    _same_report(report, jsim.run(_j_events(events), years=1.0))
    assert np.array_equal(sim.copy_ok, jsim.copy_ok)
    assert np.array_equal(sim.lost, jsim.lost)
    return sim, report


def test_single_node_failure_repairs_without_loss():
    owners = np.array([[0, 4], [1, 5], [2, 6], [0, 8], [1, 9], [3, 4]])
    sim, report = _both(owners, [FailureEvent(3600.0, "node", 0)])
    assert report.objects_lost == 0
    assert report.loss_incidents == 0
    assert report.repairs_completed == 1
    assert report.rows_repaired == int((owners == 0).sum())
    assert report.bytes_repaired == report.rows_repaired * sim.bytes_per_row
    assert np.all(sim.copy_ok)


def test_simultaneous_loss_of_all_copies_is_final():
    owners = np.array([[0, 1], [2, 3]])
    sim, report = _both(owners, [
        FailureEvent(3600.0, "node", 0),
        FailureEvent(3600.0, "node", 1),
        FailureEvent(7200.0, "node", 2),
    ])
    assert report.objects_lost == 1
    assert report.loss_incidents == 1
    assert bool(sim.lost[0]) and not bool(sim.lost[1])
    assert np.all(sim.copy_ok[1])


def test_staggered_failures_survive_when_repair_lands_between():
    owners = np.array([[0, 1], [2, 3]])
    _, report = _both(owners, [
        FailureEvent(3600.0, "node", 0),
        FailureEvent(3600.0 + 7 * 86_400.0, "node", 1),
    ])
    assert report.objects_lost == 0
    assert report.repairs_completed == 2


def test_repaired_node_refails_and_is_repaired_again():
    owners = np.array([[0, 4], [0, 5], [1, 6]])
    sim, report = _both(owners, [
        FailureEvent(3600.0, "node", 0),
        FailureEvent(30 * 86_400.0, "node", 0),
    ])
    assert report.node_failures == 2
    assert report.repairs_completed == 2
    assert report.objects_lost == 0
    assert np.all(sim.copy_ok)
    assert report.rows_repaired == 4


def test_domain_event_kills_every_member_node():
    owners = np.array([[0, 1], [2, 4]])
    sim, report = _both(owners, [FailureEvent(3600.0, "domain", 0)])
    assert report.domain_failures == 1
    assert report.objects_lost == 1
    assert not bool(sim.lost[1])


def test_serialized_repair_queue_is_tracked():
    owners = np.tile(np.arange(8).reshape(-1, 1), (1, 2)) % 4 + np.array([[0, 4]])
    _, report = _both(owners, [FailureEvent(3600.0, "domain", 0)])
    assert report.max_repair_queue == 4
    assert report.repairs_completed == 4


# ---------------------------------------------------------------------------
# The headline comparison and the movement half
# ---------------------------------------------------------------------------


def test_compare_policies_headline_and_determinism():
    kw = dict(
        n_objects=4_000, n_replicas=3, years=10.0,
        mttf_node_years=3.0, mttf_domain_years=15.0, seed=7,
    )
    reports = compare_policies(TOPO, device="cpu", **kw)
    want = jdur.compare_policies(TOPO, **kw)
    for name in ("flat", "hier"):
        _same_report(reports[name], want[name])
    flat, hier = reports["flat"], reports["hier"]
    assert (flat.node_failures, flat.domain_failures) == (
        hier.node_failures, hier.domain_failures)
    assert flat.domain_failures > 0
    assert hier.objects_lost < flat.objects_lost
    assert hier.loss_incidents < flat.loss_incidents
    assert hier.objects_lost == 0
    assert abs(hier.rows_repaired - flat.rows_repaired) < 0.1 * flat.rows_repaired
    again = compare_policies(TOPO, device="cpu", **kw)
    assert again["flat"] == flat
    assert again["hier"] == hier


@pytest.mark.parametrize("add_domain,add_capacity", [(None, 1.0), (4, 1.5)])
def test_movement_on_node_add_parity(add_domain, add_capacity):
    kw = dict(n_objects=4_000, n_replicas=3, add_domain=add_domain,
              add_capacity=add_capacity)
    moved = movement_on_node_add(TOPO, device="cpu", **kw)
    assert moved == jdur.movement_on_node_add(TOPO, **kw)
    assert 0.0 < moved["flat"] < 0.25
    assert 0.0 < moved["hier"] < 0.25
    assert moved["hier"] < 2.0 * moved["flat"] + 0.02
