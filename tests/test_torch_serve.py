"""The port's serving stack against the reference's, bit for bit.

  * threefry2x32 words equal ``jax.random`` (the reference's partitionable
    ``fold_in(fold_in(key, step), lane)`` then ``bits``), lanes >= 2**31
    included;
  * ``RequestStreamDriver`` equals the reference driver over 3 steps for
    every policy and every traffic law: chosen nodes, counts, queue, the
    queue ring and the metrics slab; ``superstep(k)`` equals k steps;
  * ``Router`` equals the reference router; the metrics slab and the trace
    ledger keep the reference's semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PlacementEngine as JEngine
from repro.core import make_cluster as j_make_cluster
from repro.obs import MetricsRegistry as JMetrics
from repro.obs import TraceLedger as JLedger
from repro.serve import RequestStreamDriver as JDriver
from repro.serve import Router as JRouter
from repro.serve import TrafficModel as JTraffic
from repro.serve.stream import select_replica as j_select
from repro_torch import convert
from repro_torch.core import PlacementEngine
from repro_torch.obs import MetricsRegistry, TraceLedger
from repro_torch.serve import LAWS, POLICIES, RequestStreamDriver, Router, TrafficModel
from repro_torch.serve.stream import select_replica
from repro_torch.serve.traffic import fold_in, prng_key

CAPS = [0.5, 1.5, 1.0, 2.0, 0.75, 1.25, 1.0, 0.6, 1.9, 1.1, 0.8, 1.4]
CFG = dict(batch=512, n_keys=1000, n_replicas=3, seed=5)


def _pair(instrumented=True, **kw):
    """(reference driver, port driver on the CPU, their registries or
    None) on the same cluster."""
    ref_c = j_make_cluster(CAPS)
    ref_c.remove_node(4)  # a dead node: its bin stays in the layout
    c = convert.cluster_from_reference_json(ref_c.to_json())
    jm, tm = (JMetrics(), MetricsRegistry(device="cpu")) if instrumented else (None, None)
    jd = JDriver(JEngine(ref_c, backend="ref"), metrics=jm, **kw)
    td = RequestStreamDriver(PlacementEngine(c, device="cpu"), metrics=tm, **kw)
    return jd, td, jm, tm


def _assert_same_state(jd, td, jm, tm):
    assert np.array_equal(np.asarray(jd.counts), td.counts.numpy())
    assert np.array_equal(np.asarray(jd.queue), td.queue.numpy())
    assert np.array_equal(np.asarray(jd.qhist), td.qhist.numpy())
    js, ts = jm.snapshot(), tm.snapshot()
    assert js.keys() == ts.keys()
    for name in js:
        assert np.array_equal(np.asarray(js[name]), np.asarray(ts[name])), name


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 1), (2**31 - 1, 1000)])
def test_threefry_words_match_jax(seed, step):
    lanes = np.array([0, 1, 2, 511, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1],
                     dtype=np.uint32)
    want = np.asarray(JTraffic.lane_words(
        jax.random.PRNGKey(seed), jnp.int32(step), jnp.asarray(lanes), 2))
    got = TrafficModel.lane_words(prng_key(seed), step,
                                  torch.from_numpy(lanes.astype(np.int64)), 2)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed,step", [(-5, 0), (0, 1000)])
def test_one_word_a_lane_matches_jax_on_a_ragged_range(seed, step):
    """The n_words=1 form ``route_batch`` and ``sample_ranks`` use, over
    lanes that cross 2**31 and 2**32 (a mesh rank's global lanes)."""
    lanes = np.arange(2**31 - 700, 2**31 + 301, dtype=np.int64)
    lanes = np.concatenate([lanes, lanes + 2**31 - 300])
    want = np.asarray(JTraffic.lane_words(
        jax.random.PRNGKey(seed), jnp.int32(step), jnp.asarray(lanes.astype(np.uint32)), 1))
    got = TrafficModel.lane_words(prng_key(seed), step, torch.from_numpy(lanes), 1)
    assert got.shape == (lanes.shape[0], 1)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_cpu_lanes_take_the_twin_and_launch_no_kernel():
    from repro_torch.kernels import LAUNCHES

    before = LAUNCHES["lane_words"]  # 0 in a process that has no card
    _, td, _, _ = _pair(policy="pow2", law="zipf", **CFG)
    td.step()
    td.superstep(2)
    td.route_batch(np.arange(700, dtype=np.uint32))
    TrafficModel(100).sample_ranks(1, 300, batch=128, device="cpu")
    assert LAUNCHES["lane_words"] == before


def test_lane_words_refuses_a_device_that_is_neither_cuda_nor_cpu():
    with pytest.raises(ValueError, match="cuda or cpu"):
        TrafficModel.lane_words(prng_key(0), 0, torch.arange(4, device="meta"), 1)


@pytest.mark.parametrize("case", ["int32 lanes", "2-D lanes", "strided lanes", "three words",
                                  "key over u32", "cpu lanes", "not a tensor"])
def test_lane_words_cuda_checks_its_operands_before_any_launch(case):
    from repro_torch.kernels import LAUNCHES, lane_words_cuda

    key, lanes, n_words = fold_in(prng_key(0), 0), torch.arange(8, dtype=torch.int64), 1
    error, before = ValueError, LAUNCHES["lane_words"]
    if case == "int32 lanes":
        lanes, error = lanes.to(torch.int32), TypeError
    elif case == "2-D lanes":
        lanes = lanes.view(2, 4)
    elif case == "strided lanes":
        lanes = lanes[::2]
    elif case == "three words":
        n_words = 3
    elif case == "key over u32":
        key = (key[0], 2**32)
    elif case == "not a tensor":
        lanes, error = list(range(8)), TypeError
    with pytest.raises(error):
        lane_words_cuda(key, lanes, n_words)
    assert LAUNCHES["lane_words"] == before


def test_prng_key_and_fold_in_match_jax():
    for seed in (0, 3, 2**31 - 1, -5):
        key = jax.random.PRNGKey(seed)
        assert prng_key(seed) == tuple(int(x) for x in np.asarray(key))
        for data in (0, 1, 2**31 + 3):
            want = np.asarray(jax.random.fold_in(key, np.uint32(data)))
            assert fold_in(prng_key(seed), data) == tuple(int(x) for x in want)
    with pytest.raises(ValueError):
        prng_key(2**31)


@pytest.mark.parametrize("law", LAWS)
def test_traffic_model_matches_reference(law):
    j, t = JTraffic(5000, law=law, seed=2), TrafficModel(5000, law=law, seed=2)
    assert np.array_equal(j.thresholds, t.thresholds)
    assert np.array_equal(j.pmf, t.pmf)
    assert j.id_salt == t.id_salt
    if law == "zipf":
        assert np.array_equal(j.sample_ranks(9, 3000, batch=1024),
                              t.sample_ranks(9, 3000, batch=1024, device="cpu"))
    ranks = np.arange(5000, dtype=np.uint32)
    ids = TrafficModel.ids_from_ranks(torch.from_numpy(ranks.astype(np.int64)), t.id_salt)
    assert np.array_equal(ids.numpy().astype(np.uint32), j.rank_to_id_np(ranks))


@pytest.mark.parametrize("policy", POLICIES)
def test_select_replica_matches_reference(policy):
    rng = np.random.default_rng(4)
    owners = rng.integers(0, 40, (2000, 3)).astype(np.int32)
    owners[rng.random((2000, 3)) < 0.1] = -1  # unfilled slots
    sel = rng.integers(0, 2**32, 2000, dtype=np.uint32)
    counts = rng.integers(0, 100, 40).astype(np.int32)
    want = np.asarray(j_select(jnp.asarray(owners), jnp.asarray(sel),
                               jnp.asarray(counts), policy=policy, n_replicas=3))
    got = select_replica(torch.from_numpy(owners), torch.from_numpy(sel.astype(np.int64)),
                         torch.from_numpy(counts), policy=policy, n_replicas=3)
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# select and count: the kernel SC's rule, its twin and its wrapper's checks
# ---------------------------------------------------------------------------

_BIG = 2**31 - 1


def _sc_lane(row, w, counts, policy, R):
    """One lane of ``csrc/serve.cu``'s ``pick``, in Python ints: the u32
    slot arithmetic and the load of a candidate (2**31 - 1 for -1)."""
    def load(x):
        return int(counts[x]) if 0 <= x < len(counts) else _BIG

    chosen = -1
    if policy != "primary" and R > 1:
        s = w % R
        chosen = int(row[s])
        if policy == "pow2":
            other = int(row[(s + 1 + (w >> 16) % (R - 1)) % R])
            if load(other) < load(chosen):
                chosen = other
    return chosen if chosen >= 0 else max(int(row[0]), 0)


@pytest.mark.parametrize("R", [1, 2, 3, 5])
@pytest.mark.parametrize("policy", POLICIES)
def test_select_count_twin_matches_the_reference_and_the_kernels_lane_rule(policy, R):
    """The twin equals the reference's ``select_replica`` then a bincount
    of the lanes below ``n_valid``, added into the histogram it is given;
    the kernel's per-lane rule (modelled in Python) picks the same nodes,
    -1 slots, fully invalid rows and ties included."""
    from repro_torch.serve.stream import select_count_twin

    rng = np.random.default_rng(R)
    n, n_bins, n_valid = 1500, 40, 1300
    owners = rng.integers(0, n_bins, (n, R)).astype(np.int32)
    owners[rng.random((n, R)) < 0.15] = -1
    owners[rng.random(n) < 0.03] = -1
    sel = rng.integers(0, 2**32, n, dtype=np.uint32)
    counts = rng.integers(0, 6, n_bins).astype(np.int32)  # many ties
    start = rng.integers(0, 9, n_bins).astype(np.int32)
    hist = torch.from_numpy(start.copy())
    got = select_count_twin(torch.from_numpy(owners), torch.from_numpy(sel.astype(np.int64)),
                            torch.from_numpy(counts), hist, policy=policy, n_replicas=R,
                            n_valid=n_valid)
    want = np.asarray(j_select(jnp.asarray(owners), jnp.asarray(sel), jnp.asarray(counts),
                               policy=policy, n_replicas=R))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(hist.numpy(), start + np.bincount(want[:n_valid], minlength=n_bins))
    model = [_sc_lane(owners[i], int(sel[i]), counts, policy, R) for i in range(n)]
    assert np.array_equal(np.asarray(model), want)


def test_count_update_twin_wraps_clamps_and_hands_the_histogram_back_zeroed():
    from repro_torch.serve.stream import count_update_twin

    hist = torch.tensor([3, 0, 10, 1], dtype=torch.int32)
    counts = torch.tensor([1, 2, 2**31 - 5, 0], dtype=torch.int32)
    queue = torch.tensor([5, 0, 1, 2**31 - 1], dtype=torch.int32)
    service = torch.full((4,), 4, dtype=torch.int32)
    qhist = torch.zeros((3, 4), dtype=torch.int32)
    held = (counts, queue)
    new_counts, new_queue = count_update_twin(hist, counts, queue, service, qhist[1])
    assert new_counts.tolist() == [4, 2, -(2**31) + 5, 1]
    assert new_queue.tolist() == [4, 0, 7, 2**31 - 4]  # 2**31 - 1 + 1 wraps, - 4 wraps back
    assert qhist[1].tolist() == new_queue.tolist() and not qhist[0].any()
    assert not hist.any()
    assert held[0].tolist() == [1, 2, 2**31 - 5, 0] and held[1].tolist() == [5, 0, 1, 2**31 - 1]


@pytest.mark.parametrize("path", ["step", "superstep", "route_batch", "instrumented step"])
def test_counts_and_queue_held_after_a_batch_are_unchanged_after_the_next(path):
    """``counts`` and ``queue`` are new tensors every batch: a caller that
    keeps batch k's still reads batch k's after batch k + 1."""
    _, td, _, _ = _pair(instrumented=path.startswith("instrumented"), policy="pow2",
                        law="zipf", **CFG)
    ids = np.arange(700, dtype=np.uint32) * 7919

    def serve():
        if path == "route_batch":
            td.route_batch(ids)
        elif path == "superstep":
            td.superstep(2)
        else:
            td.step()

    serve()
    held = (td.counts, td.queue)
    copies = [t.clone() for t in held]
    serve()
    for t, c in zip(held, copies):
        assert torch.equal(t, c)
    assert td.counts is not held[0] and td.queue is not held[1]
    assert not torch.equal(td.counts, held[0])


def test_cpu_select_and_count_add_no_launch():
    from repro_torch.kernels import LAUNCHES

    before = {k: LAUNCHES[k] for k in ("select_count", "count_update")}  # 0 without a card
    _, td, _, _ = _pair(policy="pow2", law="zipf", **CFG)
    td.step()
    td.superstep(2)
    td.route_batch(np.arange(700, dtype=np.uint32))
    assert {k: LAUNCHES[k] for k in before} == before


def test_select_count_refuses_a_device_that_is_neither_cuda_nor_cpu():
    from repro_torch.serve.stream import count_update, select_count

    meta = dict(device="meta", dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        select_count(torch.empty((4, 3), **meta), torch.empty(4, device="meta",
                     dtype=torch.int64), torch.empty(5, **meta), torch.empty(5, **meta),
                     policy="pow2", n_replicas=3, n_valid=4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        count_update(*(torch.empty(5, **meta) for _ in range(5)))


SC_BAD = ["int64 owners", "1-D owners", "owners of another R", "not a tensor", "int32 words",
          "short words", "words on another device", "int64 counts", "short hist",
          "strided counts", "no bins", "R = 0", "n_valid -1", "n_valid past n",
          "unknown policy", "cpu operands"]


@pytest.mark.parametrize("case", SC_BAD)
def test_select_count_cuda_checks_its_operands_before_any_launch(case):
    from repro_torch.kernels import LAUNCHES, select_count_cuda

    owners = torch.zeros((8, 3), dtype=torch.int32)
    sel = torch.zeros(8, dtype=torch.int64)
    counts, hist = torch.zeros(10, dtype=torch.int32), torch.zeros(10, dtype=torch.int32)
    kw = dict(policy="pow2", n_replicas=3, n_valid=8)
    error, before = ValueError, LAUNCHES["select_count"]
    if case == "int64 owners":
        owners, error = owners.long(), TypeError
    elif case == "1-D owners":
        owners = owners[:, 0]
    elif case == "owners of another R":
        kw["n_replicas"] = 2
    elif case == "not a tensor":
        owners, error = owners.tolist(), TypeError
    elif case == "int32 words":
        sel, error = sel.int(), TypeError
    elif case == "short words":
        sel = sel[:7]
    elif case == "words on another device":
        sel = sel.to("meta")
    elif case == "int64 counts":
        counts, error = counts.long(), TypeError
    elif case == "short hist":
        hist = hist[:9]
    elif case == "strided counts":
        counts = torch.zeros(20, dtype=torch.int32)[::2]
    elif case == "no bins":
        counts, hist = counts[:0], hist[:0]
    elif case == "R = 0":
        owners, kw["n_replicas"] = owners[:, :0], 0
    elif case == "n_valid -1":
        kw["n_valid"] = -1
    elif case == "n_valid past n":
        kw["n_valid"] = 9
    elif case == "unknown policy":
        kw["policy"] = "least"
    with pytest.raises(error):
        select_count_cuda(owners, sel, counts, hist, **kw)
    assert LAUNCHES["select_count"] == before


@pytest.mark.parametrize("case", ["int64 hist", "short queue", "2-D counts", "strided row",
                                  "not a tensor", "cpu operands"])
def test_count_update_cuda_checks_its_operands_before_any_launch(case):
    from repro_torch.kernels import LAUNCHES, count_update_cuda

    ops = [torch.zeros(10, dtype=torch.int32) for _ in range(5)]
    error, before = ValueError, LAUNCHES["count_update"]
    if case == "int64 hist":
        ops[0], error = ops[0].long(), TypeError
    elif case == "short queue":
        ops[2] = ops[2][:9]
    elif case == "2-D counts":
        ops[1] = ops[1].view(2, 5)
    elif case == "strided row":
        ops[4] = torch.zeros((10, 2), dtype=torch.int32)[:, 0]
    elif case == "not a tensor":
        ops[3], error = ops[3].tolist(), TypeError
    with pytest.raises(error):
        count_update_cuda(*ops)
    assert LAUNCHES["count_update"] == before


# ---------------------------------------------------------------------------
# the serving driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "policy,law",
    [(p, "zipf") for p in POLICIES] + [("pow2", law) for law in LAWS if law != "zipf"],
)
def test_driver_matches_reference(policy, law):
    jd, td, jm, tm = _pair(policy=policy, law=law, **CFG)
    assert td.n_bins == jd.n_bins and td.service_rate == jd.service_rate
    for _ in range(3):
        want = np.asarray(jd.step())
        got = td.step()
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    _assert_same_state(jd, td, jm, tm)
    assert td.load_skew() == jd.load_skew()
    assert td.queue_p99() == jd.queue_p99()


def test_superstep_equals_steps():
    _, a, _, ma = _pair(policy="pow2", law="zipf", **CFG)
    _, b, _, mb = _pair(policy="pow2", law="zipf", **CFG)
    chosen = torch.stack([a.step() for _ in range(4)])
    assert torch.equal(b.superstep(4), chosen)
    for name in ("counts", "queue", "qhist"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    sa, sb = ma.snapshot(), mb.snapshot()
    for name in sa:
        assert np.array_equal(np.asarray(sa[name]), np.asarray(sb[name])), name
    assert a.steps_done == b.steps_done == 4
    with pytest.raises(ValueError):
        b.superstep(0)


def test_driver_accounting_and_tripwires():
    _, td, _, tm = _pair(policy="random", law="hotset", **CFG)
    first = [td.step() for _ in range(3)]
    assert td.step_traces == 1 and td.engine.uploads == 1
    counts = td.load_counts()
    assert counts.sum() == 3 * CFG["batch"]
    hist = np.bincount(torch.cat(first).numpy(), minlength=td.n_bins)
    assert np.array_equal(counts, hist)
    assert counts[4] == 0  # the removed node serves nothing
    assert np.array_equal(tm.snapshot()["serve.served"].astype(np.int64), counts)
    td.reset()
    again = [td.step() for _ in range(3)]
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    td.engine.cluster.add_node(4, 1.0)  # new version, same ladder statics
    td.step()
    assert td.step_traces == 1 and td.engine.uploads == 2
    snap = td.snapshot()
    assert snap["steps"] == 4
    assert td.ledger.events("serve.snapshot")[-1]["steps"] == 4
    # a node outside the load planes: the port refuses on the host (the
    # reference would drop its requests from the counts)
    td.engine.cluster.add_node(td.n_bins, 1.0)
    with pytest.raises(ValueError, match="n_bins"):
        td.step()


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


def test_router_matches_reference():
    caps = {i: c for i, c in enumerate(CAPS)}
    jr, tr = JRouter(caps), Router(caps, device="cpu")
    sessions = np.random.default_rng(8).integers(0, 2**32, 3000, dtype=np.uint32)
    assert np.array_equal(tr.route(sessions), jr.route(sessions))
    assert np.array_equal(tr.route_device(sessions).numpy(),
                          np.asarray(jr.route_device(sessions)))
    assert np.array_equal(tr.route_replicas(sessions, 3), jr.route_replicas(sessions, 3))
    for _ in range(3):
        got = tr.route_replicas_device(sessions, 3)
    assert np.array_equal(got.numpy(), np.asarray(jr.route_replicas_device(sessions, 3)))
    assert tr.table_uploads == 1
    assert np.array_equal(tr.my_sessions(2, sessions), jr.my_sessions(2, sessions))
    # a membership change: one more upload, still equal
    for r in (jr, tr):
        r.cluster.remove_node(3)
        r.cluster.add_node(50, 1.0)
    assert tr.cluster.to_json() == jr.cluster.to_json()
    assert np.array_equal(tr.route_replicas(sessions, 2), jr.route_replicas(sessions, 2))
    assert tr.table_uploads == 2
    topo = {0: {1: 1.0}, 1: {2: 1.0, 3: 0.5}}  # {domain: {replica: capacity}}
    assert np.array_equal(Router(topo, device="cpu").route(sessions), JRouter(topo).route(sessions))
    with pytest.raises(ValueError, match="algorithm must be one of"):
        Router(caps, algorithm="straw", device="cpu")


def test_router_stream_driver_matches_reference():
    caps = {i: c for i, c in enumerate(CAPS)}
    jd = JRouter(caps).stream_driver(policy="pow2", **CFG)
    td = Router(caps, device="cpu").stream_driver(policy="pow2", **CFG)
    for _ in range(2):
        assert np.array_equal(td.step().numpy(), np.asarray(jd.step()))


# ---------------------------------------------------------------------------
# telemetry copies
# ---------------------------------------------------------------------------


def test_metrics_slab_is_u32_and_drains_once():
    jm, tm = JMetrics(), MetricsRegistry(device="cpu")
    for reg in (jm, tm):
        reg.counter("c")
        reg.histogram("h", 4)
        assert reg.histogram("h", 4) == "h"
        with pytest.raises(ValueError):
            reg.histogram("h", 5)
    js = jm.add(jm.slab(), "c", jnp.uint32(2**32 - 1))
    js = jm.add(js, "c", 3)
    js = jm.add_hist(js, "h", jnp.asarray([1, 2, 3], jnp.uint32))
    jm.set_slab(js)
    ts = tm.add(tm.slab(), "c", 2**32 - 1)
    tm.add(ts, "c", torch.tensor(3))
    tm.add_hist(ts, "h", torch.tensor([1, 2, 3], dtype=torch.int32))
    tm.counter("late")  # growth keeps the live windows
    jm.counter("late")
    a, b = jm.snapshot(), tm.snapshot()
    assert a.keys() == b.keys()
    for name in a:
        assert np.array_equal(np.asarray(a[name]), np.asarray(b[name])), name
    assert b["c"] == 2  # mod 2**32
    assert int(tm.slab().sum()) == 0  # drained
    off = MetricsRegistry(enabled=False, device="cpu")
    off.counter("x")
    assert off.names == () and off.snapshot() == {}


def test_trace_ledger_matches_reference():
    ticks = iter(range(100))
    clock = lambda: float(next(ticks))  # noqa: E731
    jl, tl = JLedger(clock=clock), TraceLedger(clock=clock)
    for led in (jl, tl):
        led.incr("engine.uploads")
        led.incr("engine.uploads", 2)
        led.event("engine.upload", "asura", version=np.int64(3))
        with led.span("build", version=1):
            pass
    assert tl.counters == jl.counters == {"engine.uploads": 3}
    strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"} for e in evs]  # noqa: E731
    assert strip(tl.events()) == strip(jl.events())
    assert tl.prometheus_text().replace("repro_torch_", "") == \
        jl.prometheus_text().replace("repro_", "")


# ---------------------------------------------------------------------------
# the small surface: rank_to_id_np, slab size / set_slab / bucket_add,
# route_batch, superstep_traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 9])
def test_rank_to_id_np_matches_reference(seed):
    ranks = np.random.default_rng(seed).integers(0, 2**32, 5000, dtype=np.uint32)
    got = TrafficModel(1000, seed=seed).rank_to_id_np(ranks)
    assert got.dtype == np.uint32
    assert np.array_equal(got, JTraffic(1000, seed=seed).rank_to_id_np(ranks))
    dev = TrafficModel.ids_from_ranks(torch.from_numpy(ranks.astype(np.int64)),
                                      TrafficModel(1000, seed=seed).id_salt)
    assert np.array_equal(dev.numpy(), got.astype(np.int64))


def test_metrics_size_set_slab_and_bucket_add_match_reference():
    jm, tm = JMetrics(), MetricsRegistry(device="cpu")
    for reg in (jm, tm):
        reg.counter("c")
        reg.histogram("h", 5)
        assert reg.size == 6
    idx = [0, 4, 9, -3, 2, 2]  # clipped into [0, 4]
    js = jm.bucket_add(jm.slab(), "h", jnp.asarray(idx), jnp.uint32(2**32 - 1))
    js = jm.bucket_add(js, "h", jnp.asarray([1, 1]), jnp.asarray([5, 7]))
    jm.set_slab(js)
    ts = tm.bucket_add(tm.slab(), "h", torch.tensor(idx), 2**32 - 1)
    ts = tm.bucket_add(ts, "h", torch.tensor([1, 1]), torch.tensor([5, 7]))
    tm.set_slab(ts)
    a, b = jm.snapshot(), tm.snapshot()
    for name in a:
        assert np.array_equal(np.asarray(a[name]), np.asarray(b[name])), name
    assert b["h"].tolist() == [2**32 - 2, 12, 2**32 - 2, 0, 2**32 - 2]  # mod 2**32
    assert b["c"] == 0
    fresh = torch.zeros(tm.size, dtype=torch.int64)
    tm.set_slab(fresh)
    assert tm.slab() is fresh


# a two-level cluster: 3 failure domains of 4 nodes each
TOPO = {d: {100 + 4 * d + i: 1.0 + 0.25 * i + 0.5 * (d % 2) for i in range(4)}
        for d in range(3)}


@pytest.mark.parametrize(
    "kind,instrumented",
    [("asura", True), ("asura", False), ("ch", True), ("ch", False), ("hier", False)],
    ids=["True", "False", "ch-True", "ch-False", "hier-False"],
)
def test_route_batch_matches_reference(kind, instrumented):
    kw = dict(policy="pow2", law="zipf", **CFG)
    if kind == "hier":
        jd, td = JRouter(TOPO).stream_driver(**kw), Router(TOPO, device="cpu").stream_driver(**kw)
    else:
        jd, td, jm, tm = _pair(instrumented, algorithm=kind, **kw)
    rng = np.random.default_rng(3)
    td.step()
    jd.step()
    for n in (1000, 700, 1):
        ids = rng.integers(0, 2**32, n, dtype=np.uint32)
        got, want = td.route_batch(ids), np.asarray(jd.route_batch(ids))
        assert got.dtype == torch.int32 and got.shape == (n,)
        assert np.array_equal(got.numpy(), want)
    assert td.load_counts().sum() == CFG["batch"] + 1701  # pad lanes never count
    assert np.array_equal(td.counts.numpy(), np.asarray(jd.counts))
    assert np.array_equal(td.qhist.numpy(), np.asarray(jd.qhist))
    if instrumented:
        _assert_same_state(jd, td, jm, tm)
    # 1000 and 700 share the 1024 bucket; 1 is its own
    assert td.step_traces == jd.step_traces == 1 + 2
    td.route_batch(torch.arange(600, dtype=torch.int64))
    assert td.step_traces == 3


def test_superstep_traces_count_distinct_k():
    jd, td, _, _ = _pair(policy="pow2", law="zipf", **CFG)
    for k in (2, 2, 3):
        assert np.array_equal(td.superstep(k).numpy(), np.asarray(jd.superstep(k)))
    assert td.superstep_traces == jd.superstep_traces == 2
