"""The batched stream served THROUGH a live migration, against the reference.

The port's ``RequestStreamDriver.serve_migrating`` and
``superstep_migrating`` must equal the reference driver's batch for batch
(ids, chosen nodes, counts, queue history, metrics slab), and at every
batch of every round

  * the served sets equal the host read rule bit for bit,
  * every served set is R pairwise-distinct nodes on one side or the
    other of the version window,
  * every chosen node comes from its served set,

with one binding of the window's read rule per routing configuration and
no host read of a device value after the per-round view refresh.  On the
CPU the port runs its plain-torch twins; ``test_torch_gpu.py`` holds the
card's run to this CPU run.  Exact equality throughout.
"""

import numpy as np
import pytest
import torch

import repro_torch.migrate.live as live
from repro.obs import MetricsRegistry as JaxMetrics
from repro.serve import Router as JaxRouter
from repro_torch.obs import MetricsRegistry, TraceLedger, get_ledger, maybe_span, set_ledger
from repro_torch.serve import Router

N_NODES = 8
R = 3
SESSIONS = 20_000


def _window(router_cls, *, metrics=None, **kw):
    router = router_cls({i: 1.0 for i in range(N_NODES)}, **kw)
    sessions = np.arange(SESSIONS, dtype=np.uint32)
    mig = router.begin_scale_migration(
        sessions, add=(N_NODES, 1.0), n_replicas=R,
        egress={n: 60 for n in range(N_NODES + 1)},
    )
    assert mig.state.plan.n_moves > 120, "plan too small to span rounds"
    driver = router.stream_driver(
        batch=1024, n_keys=1 << 14, n_replicas=R, policy="pow2", seed=5,
        n_bins=N_NODES + 1, metrics=metrics,
    )
    return router, mig, driver


def _port(**kw):
    return _window(Router, device="cpu", **kw)


def test_batched_stream_through_mid_drain_window():
    _, jm, jd = _window(JaxRouter)
    router, mig, driver = _port()
    engine = router.engine
    v0, v1 = mig.v_from, mig.v_to
    rounds = 0
    while not mig.done and rounds < 6:
        assert mig.round() == jm.round()
        rounds += 1
        for _ in range(2):  # two batches per round
            ids_t, chosen_t = driver.serve_migrating(mig)
            ids_j, chosen_j = jd.serve_migrating(jm)
            assert ids_t.dtype == torch.uint32 and chosen_t.dtype == torch.int32
            ids, chosen = ids_t.numpy(), chosen_t.numpy()
            assert np.array_equal(ids, np.asarray(ids_j))
            assert np.array_equal(chosen, np.asarray(chosen_j))
            served = mig.route_replicas_device(ids_t).numpy()
            assert np.array_equal(served, mig.route_replicas(ids))
            assert np.array_equal(served, np.asarray(jm.route_replicas_device(ids)))
            for a in range(R):
                for b in range(a + 1, R):
                    assert (served[:, a] != served[:, b]).all()
            v_set = engine.place_replica_nodes_at(ids, v0, R)
            v1_set = engine.place_replica_nodes_at(ids, v1, R)
            union_hit = (served[:, :, None] == v_set[:, None, :]).any(-1) | (
                served[:, :, None] == v1_set[:, None, :]
            ).any(-1)
            assert union_hit.all(), "served a node on neither side of the window"
            assert (chosen[:, None] == served).any(axis=1).all()
    assert rounds > 1, "window drained in one round; nothing mid-drain tested"
    assert np.array_equal(driver.counts.numpy(), np.asarray(jd.counts))
    assert np.array_equal(driver.qhist.numpy(), np.asarray(jd.qhist))
    if not mig.done:
        mig.run()
    assert driver.load_counts().sum() == driver.steps_done * driver.batch


@pytest.mark.parametrize("k", [1, 4])
def test_superstep_migrating_matches_reference_and_serve_migrating(k):
    """``superstep_migrating(k)`` equals k ``serve_migrating`` calls of a
    second port driver and the reference's ``superstep_migrating(k)``."""
    _, jm, jd = _window(JaxRouter)
    _, ma, d_step = _port()
    _, mb, d_super = _port()
    for _ in range(2):  # two mid-drain rounds, the same pending view each side
        ma.round()
        mb.round()
        jm.round()
        ids_a, chosen_a = zip(*[d_step.serve_migrating(ma) for _ in range(k)])
        ids_b, chosen_b = d_super.superstep_migrating(mb, k)
        ids_j, chosen_j = jd.superstep_migrating(jm, k)
        assert ids_b.shape == (k, 1024)
        assert torch.equal(torch.stack(ids_a), ids_b)
        assert torch.equal(torch.stack(chosen_a), chosen_b)
        assert np.array_equal(ids_b.numpy(), np.asarray(ids_j))
        assert np.array_equal(chosen_b.numpy(), np.asarray(chosen_j))
    for name in ("counts", "queue", "qhist"):
        assert torch.equal(getattr(d_step, name), getattr(d_super, name))
        assert np.array_equal(getattr(d_super, name).numpy(), np.asarray(getattr(jd, name)))
    assert d_step.steps_done == d_super.steps_done == 2 * k
    with pytest.raises(ValueError):
        d_super.superstep_migrating(mb, 0)


def test_instrumented_slab_through_window_matches_reference():
    """The routed and served counters of the metrics slab equal the
    reference's; the window route has no kernel stats, so the ladder
    histogram stays untouched, as in the reference."""
    jmet, tmet = JaxMetrics(), MetricsRegistry(device="cpu")
    _, jm, jd = _window(JaxRouter, metrics=jmet)
    _, mig, driver = _port(metrics=tmet)
    for _ in range(3):
        jm.round()
        mig.round()
        jd.serve_migrating(jm)
        driver.serve_migrating(mig)
    jd.superstep_migrating(jm, 2)
    driver.superstep_migrating(mig, 2)
    want, got = jmet.snapshot(), tmet.snapshot()
    assert got.keys() == want.keys()
    for name in want:
        assert np.array_equal(np.asarray(got[name]), np.asarray(want[name])), name
    assert int(np.asarray(got["asura.ladder_depth"]).sum()) == 0
    assert int(np.asarray(got["serve.served"]).sum()) == 5 * 1024


def test_window_binding_stable_and_no_host_reads(monkeypatch):
    """After the per-round view refresh, serving batches bind the read rule
    once per configuration and read no device value on the host."""
    _, mig, driver = _port()
    mig.round()
    driver.serve_migrating(mig)  # warm: binding + the round's view upload
    bindings = live.probe_trace_count()
    assert bindings >= 1
    reads: list = []

    def tripwire(name):
        real = getattr(torch.Tensor, name)

        def wrapped(self, *a, **k):
            reads.append(name)
            return real(self, *a, **k)

        return wrapped

    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, tripwire(name))
    for _ in range(3):
        driver.serve_migrating(mig)
    driver.superstep_migrating(mig, 2)
    monkeypatch.undo()
    assert not reads, f"mid-round serving read the device on the host: {reads}"
    assert live.probe_trace_count() == bindings, "repeated batches rebound the rule"


def test_serve_migrating_requires_matching_replication_and_bins():
    router, mig, driver = _port()
    bad = router.stream_driver(batch=256, n_keys=1 << 12, n_replicas=2, n_bins=N_NODES + 1)
    with pytest.raises(ValueError, match="R=2"):
        bad.serve_migrating(mig)
    narrow = router.stream_driver(batch=256, n_keys=1 << 12, n_replicas=R, n_bins=N_NODES + 1)
    narrow.n_bins = N_NODES  # the new node has no load bin
    with pytest.raises(ValueError, match="load bins"):
        narrow.serve_migrating(mig)
    mig.run()
    # a drained window still serves (pending sets empty, all v+1)
    ids, chosen = driver.serve_migrating(mig)
    served = mig.route_replicas_device(ids).numpy()
    assert np.array_equal(
        served, driver.engine.place_replica_nodes_at(ids.numpy(), mig.v_to, R)
    )
    assert (chosen.numpy()[:, None] == served).any(axis=1).all()


def test_process_ledger_and_maybe_span():
    """``set_ledger`` swaps the process-wide ledger ``probe_trace_count``
    reads; ``maybe_span`` records a span only when given a ledger."""
    fresh = TraceLedger()
    prev = set_ledger(fresh)
    try:
        assert get_ledger() is fresh and live.probe_trace_count() == 0
        with maybe_span(fresh, "migrate.window", rounds=3):
            pass
        with maybe_span(None, "migrate.window"):
            pass
    finally:
        assert set_ledger(prev) is fresh
    [event] = fresh.events("span")
    assert event["name"] == "migrate.window" and event["rounds"] == 3
