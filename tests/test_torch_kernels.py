"""The port's placement kernels against the reference, bit for bit.

On the CPU the wrappers run their plain-torch twins, which are held here
to the reference's jnp refs, its Pallas kernels (interpret mode) and its
NumPy oracles with exact equality -- the whole stack is integer math, so
the tolerance is zero.  The CUDA kernels themselves are held to the twins
on the card by ``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_cluster, make_uniform_cluster
from repro.core.asura import (
    AsuraParams,
    place_batch,
    place_batch_u32,
    place_replicas_u32,
    resolve_tail_np,
    tail_cumsum_halves,
)
from repro.core.rng import draw_u32_np
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import LAUNCHES, ref
from repro_torch.kernels.asura_place import place_fused_cuda, place_replicas_cuda
from repro_torch.kernels.u32 import add32, as_u32, mul32, mulhi32, shl32, to_u32

CLUSTERS = {
    "uniform_small": [1.0] * 4,
    "uniform_128": [1.0] * 128,
    "mixed": [0.3, 1.7, 2.0, 0.9, 1.0, 0.5],
    "one_node_frac": [0.6],
    "heavy_tail": [4.0] + [0.25] * 20,
}
TOP_LEVELS = (0, 5, 19)


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


def _t(a):
    """NumPy -> torch, u32 arrays as uint32 tensors."""
    return torch.from_numpy(np.array(a))


def _table_with_top(top_level: int, seed: int = 0):
    """(len32, node_of) whose ladder top level is ``top_level`` (s_log2=1):
    the upper bound lands in (2**top, 2**(top+1)]."""
    rng = np.random.default_rng(seed)
    n = {0: 2, 5: 50, 19: 2**19 + 5}[top_level]
    lengths = rng.uniform(0.3, 0.999, n)
    assert AsuraParams().level_for(n - 1 + lengths[-1]) == top_level
    len32 = np.round(lengths * 2**32).astype(np.uint32)
    node_of = (np.arange(n) % max(2, n // 3)).astype(np.int32)
    return len32, node_of


def _tail_tables(len32):
    hi, lo = tail_cumsum_halves(len32)
    return _t(hi), _t(lo)


# ---------------------------------------------------------------------------
# the u32 rule and the hashes
# ---------------------------------------------------------------------------


def test_u32_helpers_exact():
    rng = np.random.default_rng(1)
    a = np.concatenate([[0, 1, 2**31 - 1, 2**31, 2**32 - 1],
                        rng.integers(0, 2**32, 5000)]).astype(np.uint64)
    b = np.concatenate([[2**32 - 1, 0, 2**31, 7, 2**32 - 1],
                        rng.integers(0, 2**32, 5000)]).astype(np.uint64)
    ta, tb = _t(a.astype(np.int64)), _t(b.astype(np.int64))
    m = np.uint64(0xFFFFFFFF)
    assert np.array_equal(add32(ta, tb).numpy().astype(np.uint64), (a + b) & m)
    assert np.array_equal(mul32(ta, tb).numpy().astype(np.uint64), (a * b) & m)
    assert np.array_equal(shl32(ta, 13).numpy().astype(np.uint64), (a << np.uint64(13)) & m)
    hi = [(int(x) * int(y)) >> 32 for x, y in zip(a, b)]
    assert mulhi32(ta, tb).tolist() == hi
    u = to_u32(ta)
    assert u.dtype == torch.uint32
    assert np.array_equal(u.numpy(), a.astype(np.uint32))
    assert np.array_equal(as_u32(u).numpy(), a.astype(np.int64))
    assert np.array_equal(as_u32(u.view(torch.int32)).numpy(), a.astype(np.int64))


@pytest.mark.parametrize("level", [0, 3, 30, 31])
def test_fmix32_and_draw_match_reference(level):
    ids = _ids(4096, seed=level)
    ctr = _ids(4096, seed=level + 100)
    want = np.asarray(jref.draw_u32(jnp.asarray(ids), level, jnp.asarray(ctr)))
    got = ref.draw_u32(as_u32(_t(ids)), level, as_u32(_t(ctr)))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert np.array_equal(want, draw_u32_np(ids, level, ctr))
    got_t = ref.draw_u32(as_u32(_t(ids)), torch.full((4096,), level), as_u32(_t(ctr)))
    assert np.array_equal(got_t.numpy().astype(np.uint32), want)
    fm = ref.fmix32(as_u32(_t(ids))).numpy().astype(np.uint32)
    assert np.array_equal(fm, np.asarray(jref.fmix32(jnp.asarray(ids))))


# ---------------------------------------------------------------------------
# the ladder, single placement and the tail
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_level", TOP_LEVELS)
def test_next_asura_matches_reference(top_level):
    """Three successive draws, the third with half the lanes inactive:
    k, frac, counters and depth equal the reference's lockstep ladder."""
    n = 1000
    ids = _ids(n, seed=top_level)
    j_ctr = jnp.zeros((top_level + 1, n), jnp.uint32)
    t_ctr = torch.zeros((top_level + 1, n), dtype=torch.int64)
    active = np.arange(n) % 2 == 0
    for draw in range(3):
        act = active if draw == 2 else None
        jk, jf, j_ctr, jd = jref.next_asura(
            jnp.asarray(ids), j_ctr, top_level, 1, emit_depth=True,
            active=None if act is None else jnp.asarray(act),
        )
        tk, tf, t_ctr, td = ref.next_asura(
            as_u32(_t(ids)), t_ctr, top_level, 1, emit_depth=True,
            active=None if act is None else _t(act),
        )
        assert np.array_equal(tk.numpy(), np.asarray(jk))
        assert np.array_equal(tf.numpy(), np.asarray(jf).astype(np.int64))
        assert np.array_equal(td.numpy(), np.asarray(jd))
        assert np.array_equal(t_ctr.numpy(), np.asarray(j_ctr).astype(np.int64))


@pytest.mark.parametrize("top_level", TOP_LEVELS)
def test_place_ref_matches_reference(top_level):
    len32, _ = _table_with_top(top_level)
    ids = _ids(1500, seed=top_level)
    want = np.asarray(jref.place_ref(jnp.asarray(ids), jnp.asarray(len32),
                                     top_level=top_level))
    got = ref.place_ref(_t(ids), _t(len32), top_level=top_level)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, place_batch_u32(ids, len32, top_level))


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_place_fused_twin_matches_numpy(name):
    c = make_cluster(CLUSTERS[name])
    len32, top = jops.table_prep(c.seg_lengths())
    n_segs = len(c.seg_lengths())
    len32 = np.asarray(len32)[:n_segs]
    node_of = c.seg_to_node().astype(np.int32)
    ids = _ids(2048, seed=len(name))
    want = place_batch(ids, c.seg_lengths())
    hi, lo = _tail_tables(len32)
    for emit in (False, True):
        got = place_fused_cuda(_t(ids), _t(len32), hi, lo, _t(node_of),
                               top_level=top, emit_nodes=emit)
        assert np.array_equal(got.numpy(), node_of[want] if emit else want)


@pytest.mark.parametrize("max_draws", [0, 1])
def test_forced_tail_matches_numpy(max_draws):
    """max_draws=0 sends every lane through the tail (on the 100-node table
    h * T needs up to 95 bits); max_draws=1 leaves a mixed population."""
    params = AsuraParams(max_draws=max_draws)
    c = (make_uniform_cluster(100, params=params) if max_draws == 0
         else make_cluster([0.1, 0.2, 0.05], params=params))
    ids = _ids(2048, seed=max_draws)
    want = place_batch(ids, c.seg_lengths(), params)
    len32, top = jops.table_prep(c.seg_lengths(), params)
    len32 = np.asarray(len32)[: len(c.seg_lengths())]
    hi, lo = _tail_tables(len32)
    node_of = c.seg_to_node().astype(np.int32)
    for emit in (False, True):
        got = place_fused_cuda(_t(ids), _t(len32), hi, lo, _t(node_of),
                               top_level=top, max_draws=max_draws, emit_nodes=emit)
        assert np.array_equal(got.numpy(), node_of[want] if emit else want)


def test_place_fused_wrapper_matches_pallas_partial_tail():
    """The CPU wrapper equals the reference's fused Pallas kernel (interpret
    mode) on a mixed converged / tail-resolved population, nodes out."""
    params = AsuraParams(max_draws=1)
    c = make_cluster([0.1, 0.2, 0.05, 0.9, 0.4], params=params)
    ids = _ids(2048, seed=11)
    len32_j, top = jops.table_prep(c.seg_lengths(), params)
    node_j = jops.node_table_prep(c.seg_to_node())
    hi_j, lo_j = jops.tail_prep(len32_j)
    want = np.asarray(jops.place_on_table_device(
        ids, len32_j, hi_j, lo_j, node_j, top_level=top, params=params,
        use_pallas=True, emit_nodes=True,
    ))
    n_segs = len(c.seg_lengths())
    len32 = np.asarray(len32_j)[:n_segs]
    hi, lo = _tail_tables(len32)
    got = place_fused_cuda(
        _t(ids), _t(len32), hi, lo, _t(c.seg_to_node().astype(np.int32)),
        top_level=top, max_draws=1, emit_nodes=True,
    )
    assert np.array_equal(got.numpy(), want)
    segs = place_batch(ids, c.seg_lengths(), params)
    assert np.array_equal(want, c.seg_to_node()[segs])


def test_resolve_tail_matches_numpy_with_holes():
    rng = np.random.default_rng(5)
    lengths = rng.uniform(0.0, 0.999, 300)
    lengths[rng.random(300) < 0.3] = 0.0  # holes: zero-length segments
    len32 = np.round(lengths * 2**32).astype(np.uint32)
    ids = _ids(3000, seed=6)
    segs = np.where(rng.random(3000) < 0.5, -1, 7).astype(np.int64)
    want = resolve_tail_np(ids, segs, len32, 8)
    hi, lo = _tail_tables(len32)
    got = ref.resolve_tail_dev(_t(ids), _t(segs), hi, lo, 8)
    assert np.array_equal(got.numpy(), want)
    assert (len32[want[segs < 0]] > 0).all()


# ---------------------------------------------------------------------------
# replication (section 5.A) and its stats vector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_level,R", [(5, 1), (5, 2), (5, 3), (19, 2)])
def test_place_replicas_ref_matches_reference(top_level, R):
    len32, node_of = _table_with_top(top_level, seed=R)
    ids = _ids(1000, seed=R)
    kw = dict(top_level=top_level, s_log2=1, max_draws=128, n_replicas=R)
    want, want_hist = jref.place_replicas_ref(
        jnp.asarray(ids), jnp.asarray(len32), jnp.asarray(node_of),
        emit_stats=True, **kw,
    )
    got, hist = ref.place_replicas_ref(_t(ids), _t(len32), _t(node_of),
                                       emit_stats=True, **kw)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(hist.numpy(), np.asarray(want_hist).astype(np.int64))
    assert np.array_equal(
        got.numpy(), place_replicas_u32(ids, len32, node_of, R, top_level)
    )


@pytest.mark.parametrize("R,emit_nodes", [(1, True), (2, False), (3, True)])
def test_place_replicas_wrapper_matches_pallas_and_stats(R, emit_nodes):
    """The CPU wrapper equals the reference's Pallas kernel (interpret
    mode), and its stats vector equals the reference's fused ref's."""
    c = make_cluster(CLUSTERS["heavy_tail"])
    len32_j, top = jops.table_prep(c.seg_lengths())
    node_j = jops.node_table_prep(c.seg_to_node())
    ids = _ids(2048, seed=R)
    want = np.asarray(jops.place_replicas_on_table_device(
        ids, len32_j, node_j, R, top_level=top, use_pallas=True,
        emit_nodes=emit_nodes,
    ))
    want_out, want_stats = jops._place_replicas_fused_ref(
        jnp.asarray(ids), len32_j, node_j, top_level=top, s_log2=1,
        max_draws=128, n_replicas=R, emit_nodes=emit_nodes, emit_stats=True,
    )
    assert np.array_equal(want, np.asarray(want_out))
    n_segs = len(c.seg_lengths())
    got, stats = place_replicas_cuda(
        _t(ids), _t(np.asarray(len32_j)[:n_segs]),
        _t(c.seg_to_node().astype(np.int32)), top_level=top, n_replicas=R,
        emit_nodes=emit_nodes, emit_stats=True,
    )
    assert got.dtype == torch.int32 and stats.dtype == torch.uint32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(stats.numpy(), np.asarray(want_stats))


from repro.kernels.asura_place import place_replicas_pallas  # noqa: E402
from test_torch_launch import stats_warp_summed  # noqa: E402


@pytest.mark.parametrize("name,R,max_draws", [
    ("heavy_tail", 3, 128), ("mixed", 1, 128), ("uniform_128", 12, 128),
    ("heavy_tail", 3, 1), ("one_node_frac", 3, 4),
])
def test_seeded_ladder_model_matches_place_replicas_pallas(name, R, max_draws):
    """The model of B2's lane on its seeded register ladder
    (``tests/test_torch_launch.py``) gives the reference's
    ``place_replicas_pallas`` rows (interpret mode), and its warp-summed
    stats vector the reference's fused ref's."""
    c = make_cluster(CLUSTERS[name])
    len32_j, top = jops.table_prep(c.seg_lengths())
    node_j = jops.node_table_prep(c.seg_to_node())
    ids = _ids(256, seed=R + max_draws)
    kw = dict(top_level=top, s_log2=1, max_draws=max_draws, n_replicas=R)
    want = np.asarray(place_replicas_pallas(jnp.asarray(ids), len32_j, node_j,
                                            rows_per_block=2, **kw))
    _, want_stats = jops._place_replicas_fused_ref(
        jnp.asarray(ids), len32_j, node_j, emit_nodes=False, emit_stats=True, **kw)
    n_segs = len(c.seg_lengths())
    table = (np.asarray(len32_j)[:n_segs], c.seg_to_node().astype(np.int32), top)
    rows, stats = stats_warp_summed(ids, table, max_draws=max_draws, R=R, K=6, seeds=5)
    assert np.array_equal(np.array(rows), want)
    assert stats == np.asarray(want_stats).astype(np.int64).tolist()


def test_place_replicas_wrapper_rejects_a_draw_cap_past_int32():
    """B2 counts its draws in int32, as the reference's loop does."""
    len32, _, _, node_of, top = _small_tables()
    for max_draws, R in ((2**30, 2), (2**31, 1), (2**29, 5)):
        with pytest.raises(ValueError):
            place_replicas_cuda(_t(_ids(16)), len32, node_of, top_level=top,
                                max_draws=max_draws, n_replicas=R)


def test_nonconverged_slots_counted_per_slot():
    """R above the number of distinct nodes: unfilled slots are -1 and the
    stats' last entry counts SLOTS over (batch, R), as the reference does."""
    c = make_cluster([1.0, 0.7])
    len32_j, top = jops.table_prep(c.seg_lengths())
    node_j = jops.node_table_prep(c.seg_to_node())
    ids = _ids(300, seed=9)
    kw = dict(top_level=top, s_log2=1, max_draws=4, n_replicas=3,
              emit_nodes=True, emit_stats=True)
    want, want_stats = jops._place_replicas_fused_ref(
        jnp.asarray(ids), len32_j, node_j, **kw
    )
    n_segs = len(c.seg_lengths())
    got, stats = place_replicas_cuda(
        _t(ids), _t(np.asarray(len32_j)[:n_segs]),
        _t(c.seg_to_node().astype(np.int32)), **kw,
    )
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(stats.numpy(), np.asarray(want_stats))
    assert int(stats[-1]) == int((got < 0).sum()) >= 300


def test_wide_r_matches_numpy():
    """R = 12 (above the kernel's register rows) on the CPU twin."""
    c = make_uniform_cluster(40)
    len32, top = jops.table_prep(c.seg_lengths())
    ids = _ids(500, seed=12)
    want = place_replicas_u32(ids, np.asarray(len32)[:40], c.seg_to_node(), 12, top)
    got = place_replicas_cuda(
        _t(ids), _t(np.asarray(len32)[:40]), _t(c.seg_to_node().astype(np.int32)),
        top_level=top, n_replicas=12,
    )
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# wrapper contract
# ---------------------------------------------------------------------------


def _small_tables():
    c = make_cluster(CLUSTERS["mixed"])
    len32, top = jops.table_prep(c.seg_lengths())
    n = len(c.seg_lengths())
    len32 = np.asarray(len32)[:n]
    hi, lo = _tail_tables(len32)
    return _t(len32), hi, lo, _t(c.seg_to_node().astype(np.int32)), top


def test_wrappers_check_their_inputs():
    len32, hi, lo, node_of, top = _small_tables()
    ids = _t(_ids(16))
    with pytest.raises(TypeError):
        place_fused_cuda(ids.to(torch.int64), len32, hi, lo, node_of, top_level=top)
    with pytest.raises(TypeError):
        place_fused_cuda(ids, len32, hi, lo, node_of.to(torch.int64), top_level=top)
    with pytest.raises(ValueError):
        place_fused_cuda(ids, len32, hi[:-1], lo, node_of, top_level=top)
    with pytest.raises(ValueError):
        place_fused_cuda(ids.reshape(4, 4), len32, hi, lo, node_of, top_level=top)
    with pytest.raises(ValueError):
        place_fused_cuda(ids, len32, hi, lo, node_of, top_level=31)
    with pytest.raises(ValueError):
        place_replicas_cuda(ids, len32, node_of, top_level=top, n_replicas=0)
    with pytest.raises(ValueError):
        place_replicas_cuda(ids[::2], len32, node_of, top_level=top)


def test_cpu_calls_take_the_twin_and_launch_nothing():
    len32, hi, lo, node_of, top = _small_tables()
    before = dict(LAUNCHES)
    ids = _t(_ids(64))
    out = place_fused_cuda(ids, len32, hi, lo, node_of, top_level=top)
    out_r = place_replicas_cuda(ids, len32, node_of, top_level=top, n_replicas=2)
    assert out.shape == (64,) and out_r.shape == (64, 2)
    assert LAUNCHES == before


# ---------------------------------------------------------------------------
# the two-version diffs (B3, B4), alignment and ADDITION NUMBERs
# ---------------------------------------------------------------------------

from repro.core import PlacementEngine as JaxEngine  # noqa: E402
from repro.core.asura import align_replica_sets as jax_align  # noqa: E402
from repro_torch.convert import cluster_from_reference_json  # noqa: E402
from repro_torch.core.asura import align_replica_sets  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.asura_place import diff_nodes_cuda, diff_replicas_cuda  # noqa: E402
from repro.kernels.asura_place import diff_replicas_pallas  # noqa: E402

DIFF_CASES = ("add", "holes", "reuse", "top")


def _diff_event(case: str, params=AsuraParams()):
    """(jax engine, port engine, v0, v1) around one membership event on a
    14-node cluster of one fractional segment each (top level 3):

      * ``add``   -- a node of capacity 1.0 appends a segment;
      * ``holes`` -- a removal leaves a length-0 hole (node -1);
      * ``reuse`` -- from the holed table, an add reuses the freed number;
      * ``top``   -- an add of capacity 3.0 lifts the top level to 4.

    Both engines hold v0 in their LRU before the cluster mutates."""
    caps = np.random.default_rng(7).uniform(0.5, 0.99, 14)
    jc = make_cluster(caps, params=params)
    if case == "reuse":
        jc.remove_node(5)
    tc = cluster_from_reference_json(jc.to_json(), device="cpu")
    je = JaxEngine(jc, backend="pallas")
    je.artifact()
    tc.engine.artifact()
    v0 = jc.version
    for c in (jc, tc):
        if case == "holes":
            c.remove_node(5)
        else:
            c.add_node(14, {"add": 1.0, "reuse": 0.7, "top": 3.0}[case])
    assert tc.seg_lengths().tolist() == jc.seg_lengths().tolist()
    return je, tc.engine, v0, jc.version


def _tops(te, v0, v1):
    return te.artifact_for(v0).top_level, te.artifact_for(v1).top_level


def test_diff_events_cover_the_table_shapes():
    for case in DIFF_CASES:
        _, te, v0, v1 = _diff_event(case)
        a, b = te.artifact_for(v0), te.artifact_for(v1)
        if case == "add":
            assert b.n_segs == a.n_segs + 1
        if case == "holes":
            assert a.n_segs == b.n_segs and (b.node_of == -1).sum() == 1
        if case == "reuse":
            assert a.n_segs == b.n_segs and (a.node_of == -1).sum() == 1
            assert (b.node_of == -1).sum() == 0
        assert (a.top_level != b.top_level) == (case == "top")


@pytest.mark.parametrize("case,max_draws", [(c, 128) for c in DIFF_CASES] + [("add", 1)])
def test_diff_nodes_wrapper_matches_pallas(case, max_draws):
    """The CPU wrapper of B3 equals the reference's ``diff_nodes_pallas``
    (interpret mode, through its engine); max_draws=1 forces a tail."""
    je, te, v0, v1 = _diff_event(case, AsuraParams(max_draws=max_draws))
    ids = _ids(2048, seed=len(case) + max_draws)
    _, j_src, j_dst = je.diff_nodes_device(ids, v0, v1)
    a, b = te._device_artifact_for(v0), te._device_artifact_for(v1)
    top_a, top_b = _tops(te, v0, v1)
    got = diff_nodes_cuda(
        _t(ids), a.len32_dev, a.cum_hi_dev, a.cum_lo_dev, a.node_of_dev,
        b.len32_dev, b.cum_hi_dev, b.cum_lo_dev, b.node_of_dev,
        top_a=top_a, top_b=top_b, max_draws=max_draws,
    )
    assert got.shape == (2, 2048) and got.dtype == torch.int32
    assert np.array_equal(got[0].numpy(), np.asarray(j_src))
    assert np.array_equal(got[1].numpy(), np.asarray(j_dst))
    moved, src, dst = te.diff_nodes_device(_t(ids), v0, v1)
    assert torch.equal(moved, src != dst) and torch.equal(src, got[0])
    if max_draws == 1:
        tail = ref.place_ref(_t(ids), a.len32_dev, top_level=top_a, max_draws=1)
        assert (tail < 0).any()


@pytest.mark.parametrize("R", [1, 3, 12])
@pytest.mark.parametrize("case", DIFF_CASES)
def test_diff_replicas_wrapper_matches_pallas(case, R):
    """The CPU wrapper of B4 equals the reference's
    ``diff_replicas_pallas`` (interpret mode), and the port's alignment
    equals the reference engine's (moved, src, dst, src_slot)."""
    je, te, v0, v1 = _diff_event(case)
    ids = _ids(1024, seed=R + len(case))
    a, b = te._device_artifact_for(v0), te._device_artifact_for(v1)
    top_a, top_b = _tops(te, v0, v1)
    sets = diff_replicas_cuda(
        _t(ids), a.len32_dev, a.node_of_dev, b.len32_dev, b.node_of_dev,
        top_a=top_a, top_b=top_b, n_replicas=R,
    )
    assert sets.shape == (2, 1024, R) and sets.dtype == torch.int32
    ja, jb = je._device_artifact_for(v0), je._device_artifact_for(v1)
    j_sets = np.asarray(diff_replicas_pallas(
        jnp.asarray(ids), ja.len32_dev, ja.node_of_dev, jb.len32_dev,
        jb.node_of_dev, top_a=top_a, top_b=top_b, n_replicas=R,
        rows_per_block=8,  # one block of 1024 ids, no padding
    ))
    assert np.array_equal(sets.numpy(), j_sets)
    want = je.diff_replicas_device(ids, v0, v1, R)
    got = te.diff_replicas_device(_t(ids), v0, v1, R)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert torch.equal(got[2], sets[1])


# ---------------------------------------------------------------------------
# the diff kernels' one walk for both tables (B3, B4), modelled in NumPy
# (tests/test_torch_launch.py), against the reference's two walks
# ---------------------------------------------------------------------------

from repro.kernels.asura_place import diff_nodes_pallas  # noqa: E402
from test_torch_launch import diff_lane  # noqa: E402

# (case, tables swapped, max_draws): the four events, the top-change
# event with B before A (the top goes down), and the add's forced tail
JOINT_CASES = [(c, False, 128) for c in DIFF_CASES] + [("top", True, 128), ("add", False, 1)]
JOINT_IDS = 256


def _joint_tables(case, swap, max_draws):
    """(reference engine artifacts A, B with device tables; their
    (len32, node_of, top) as the model takes them)."""
    je, te, v0, v1 = _diff_event(case, AsuraParams(max_draws=max_draws))
    vs = (v1, v0) if swap else (v0, v1)
    arts = [je._device_artifact_for(v) for v in vs]
    tables = [(np.asarray(x.len32_dev), np.asarray(x.node_of_dev), te.artifact_for(v).top_level)
              for x, v in zip(arts, vs)]
    if case == "top":
        assert tables[0][2] - tables[1][2] == (1 if swap else -1)
    return arts, tables


@pytest.mark.parametrize("case,swap,max_draws", JOINT_CASES)
def test_joint_walk_model_matches_diff_nodes_pallas(case, swap, max_draws):
    """The model of B3's one walk, with each table's tail and gather, gives
    the reference's ``diff_nodes_pallas`` rows (interpret mode)."""
    (ja, jb), tables = _joint_tables(case, swap, max_draws)
    ids = _ids(JOINT_IDS, seed=len(case) + 2 * swap + max_draws)
    want = np.asarray(diff_nodes_pallas(
        jnp.asarray(ids), ja.len32_dev, ja.cum_hi_dev, ja.cum_lo_dev, ja.node_of_dev,
        jb.len32_dev, jb.cum_hi_dev, jb.cum_lo_dev, jb.node_of_dev,
        top_a=tables[0][2], top_b=tables[1][2], max_draws=max_draws,
        rows_per_block=JOINT_IDS // 128,
    ))
    segs = np.array([diff_lane(int(i), tables, max_draws=max_draws) for i in ids]).T
    if max_draws == 1:
        assert (segs < 0).any()
    for t, (len32, node_of, top) in enumerate(tables):
        assert np.array_equal(node_of[resolve_tail_np(ids, segs[t], len32, top)], want[t])


@pytest.mark.parametrize("R", [1, 3, 12])
@pytest.mark.parametrize("case,swap,max_draws", JOINT_CASES[:5])
def test_joint_walk_model_matches_diff_replicas_pallas(case, swap, max_draws, R):
    """The model of B4's one walk gives the reference's
    ``diff_replicas_pallas`` node sets (interpret mode)."""
    (ja, jb), tables = _joint_tables(case, swap, max_draws)
    ids = _ids(JOINT_IDS, seed=R + len(case) + 2 * swap)
    want = np.asarray(diff_replicas_pallas(
        jnp.asarray(ids), ja.len32_dev, ja.node_of_dev, jb.len32_dev, jb.node_of_dev,
        top_a=tables[0][2], top_b=tables[1][2], n_replicas=R,
        rows_per_block=JOINT_IDS // 128,
    ))
    got = np.array([diff_lane(int(i), tables, max_draws=max_draws, R=R) for i in ids])
    assert np.array_equal(got.transpose(1, 0, 2), want)


def test_diff_replicas_wrapper_rejects_a_draw_cap_past_int32():
    """B4 counts each table's draws in int32, as the reference's loop does."""
    _, te, v0, v1 = _diff_event("add")
    a, b = te._device_artifact_for(v0), te._device_artifact_for(v1)
    with pytest.raises(ValueError):
        diff_replicas_cuda(_t(_ids(16)), a.len32_dev, a.node_of_dev, b.len32_dev,
                           b.node_of_dev, top_a=a.top_level, top_b=b.top_level,
                           max_draws=2**30, n_replicas=2)


# ---------------------------------------------------------------------------
# B4 with the alignment as its epilogue: the wrapper's checks and CPU route
# ---------------------------------------------------------------------------

from repro_torch.kernels.asura_place import diff_replicas_aligned_cuda  # noqa: E402
from test_torch_launch import ALIGN_ROWS, align_epilogue, align_rows_random  # noqa: E402


def _aligned_operands(case="add"):
    """(ids, B4's four tables, their tops) around one diff event."""
    _, te, v0, v1 = _diff_event(case)
    a, b = te._device_artifact_for(v0), te._device_artifact_for(v1)
    tabs = (a.len32_dev, a.node_of_dev, b.len32_dev, b.node_of_dev)
    return tabs, dict(top_a=a.top_level, top_b=b.top_level)


@pytest.mark.parametrize("fault,error,match", [
    ("ids int64", TypeError, "ids must be torch.uint32"),
    ("node table int64", TypeError, "node_a must be torch.int32"),
    ("table on another device", ValueError, "len32_b is on meta"),
    ("ids not contiguous", ValueError, "ids must be contiguous"),
    ("no replicas", ValueError, "n_replicas must be >= 1"),
    ("draw cap past int32", ValueError, "max_draws \\* n_replicas"),
    ("meta device", ValueError, "runs on cuda or cpu, not meta"),
])
def test_diff_replicas_aligned_wrapper_checks_its_operands(fault, error, match):
    tabs, kw = _aligned_operands()
    args = [_t(_ids(64)), *tabs]
    kw.update(n_replicas=3)
    if fault == "ids int64":
        args[0] = args[0].to(torch.int64)
    elif fault == "node table int64":
        args[2] = args[2].to(torch.int64)
    elif fault == "table on another device":
        args[3] = args[3].to("meta")
    elif fault == "ids not contiguous":
        args[0] = torch.stack([args[0], args[0]], 1)[:, 0]
    elif fault == "no replicas":
        kw.update(n_replicas=0)
    elif fault == "draw cap past int32":
        kw.update(max_draws=2**30, n_replicas=2)
    elif fault == "meta device":
        args = [t.to("meta") for t in args]
    before = dict(LAUNCHES)
    with pytest.raises(error, match=match):
        diff_replicas_aligned_cuda(*args, **kw)
    assert LAUNCHES == before


@pytest.mark.parametrize("R", [1, 3, 12])
@pytest.mark.parametrize("case", DIFF_CASES)
def test_diff_replicas_aligned_cpu_route_is_the_two_step(case, R):
    """On CPU tables the aligned wrapper returns the twin's sets aligned by
    ``ops.align_replica_sets`` -- what the flat replica diff computed in two
    steps -- and the flat diff returns it; neither counts a launch."""
    tabs, kw = _aligned_operands(case)
    ids = _t(_ids(1024, seed=R + len(case)))
    before = dict(LAUNCHES)
    got = diff_replicas_aligned_cuda(ids, *tabs, n_replicas=R, **kw)
    sets = diff_replicas_cuda(ids, *tabs, n_replicas=R, **kw)
    want = ops.align_replica_sets(sets[0], sets[1])
    flat = ops.diff_replicas_on_tables_device(ids, *tabs, n_replicas=R, **kw)
    assert got[0].dtype == torch.bool and all(t.shape == (1024, R) for t in got)
    for g, w, f in zip(got, want, flat):
        assert g.dtype == w.dtype == f.dtype and torch.equal(g, w) and torch.equal(f, w)
    assert "diff_replicas_aligned" in LAUNCHES and LAUNCHES == before


def _hold_alignments(before, after):
    """The port's plain alignment, its host spec, the reference's host spec
    and jnp twin, and the epilogue's model (both forms) agree on every row."""
    R = after.shape[1]
    t = [x.numpy() for x in ops.align_replica_sets(_t(before), _t(after))]
    assert t[0].dtype == np.bool_ and np.array_equal(t[2], after)
    for moved, src, src_slot in (align_replica_sets(before, after), jax_align(before, after)):
        for got, want in ((moved, t[0]), (src, t[1]), (src_slot, t[3])):
            assert np.array_equal(got, want)
    j_dev = jops._align_replica_sets(jnp.asarray(before), jnp.asarray(after), n_replicas=R)
    for got, want in zip(t, j_dev):
        assert np.array_equal(got, np.asarray(want))
    for rows in (False, True):
        model = [align_epilogue(b, a, rows=rows) for b, a in zip(before.tolist(), after.tolist())]
        for f in range(4):
            assert np.array_equal(np.array([m[f] for m in model]), t[f])


@pytest.mark.parametrize("name", list(ALIGN_ROWS))
def test_align_replica_sets_on_adversarial_rows_matches_reference(name):
    """Rows the kernel's epilogue has to reproduce: everything or nothing
    moved, common nodes permuted, -1 slots filled or left, more new slots
    than lost ones."""
    _hold_alignments(*(np.array([row], dtype=np.int32) for row in ALIGN_ROWS[name]))


@pytest.mark.parametrize("R", [1, 3, 5, 9, 12])
def test_align_replica_sets_on_random_partial_rows_matches_reference(R):
    _hold_alignments(*align_rows_random(R, 500, 100 + R))


def test_align_replica_sets_matches_reference():
    """The port's host spec and device twin of the per-slot alignment equal
    the reference's, on sets with shared, moved and reordered members."""
    rng = np.random.default_rng(3)
    n, R = 4000, 4
    before = np.stack([rng.permutation(9)[:R] for _ in range(n)])
    after = before.copy()
    swap = rng.random(n) < 0.5
    after[swap] = after[swap][:, ::-1]  # same members, other positions
    for i in np.nonzero(rng.random(n) < 0.6)[0]:
        fresh = np.setdiff1d(np.arange(9, 14), after[i])
        after[i, rng.integers(R)] = rng.choice(fresh)
    want = jax_align(before, after)
    host = align_replica_sets(before, after)
    for h, w in zip(host, want):
        assert np.array_equal(h, w)
    j_dev = jops._align_replica_sets(jnp.asarray(before), jnp.asarray(after), n_replicas=R)
    t_dev = ops.align_replica_sets(_t(before), _t(after))
    for t, j in zip(t_dev, j_dev):
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert np.array_equal(t_dev[0].numpy(), want[0])


@pytest.mark.parametrize("R", [1, 3])
def test_addition_numbers_ref_matches_reference(R):
    c = make_cluster(np.random.default_rng(R).uniform(0.5, 1.5, 16))
    len32, top = jops.table_prep(c.seg_lengths())
    n_segs = len(c.seg_lengths())
    len32 = np.asarray(len32)[:n_segs]
    node_of = c.seg_to_node().astype(np.int32)
    ids = _ids(2048, seed=R)
    for extra in (0, 2):
        want = np.asarray(jref.addition_numbers_ref(
            jnp.asarray(ids), jnp.asarray(len32), jnp.asarray(node_of),
            top_level=top + extra, n_replicas=R,
        ))
        got = ref.addition_numbers_ref(_t(ids), _t(len32), _t(node_of),
                                       top_level=top + extra, n_replicas=R)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert (want >= 0).any() and (want < 0).any()  # both kinds of lane


# ---------------------------------------------------------------------------
# the bounded placement kernel (B9): no tail, no gather
# ---------------------------------------------------------------------------

from repro.kernels.asura_place import place_pallas  # noqa: E402
from repro_torch.kernels.asura_place import place_cuda  # noqa: E402


@pytest.mark.parametrize("max_draws", [128, 1])
@pytest.mark.parametrize("name", ["mixed", "heavy_tail"])
def test_place_wrapper_matches_place_pallas(name, max_draws):
    """The CPU wrapper (``place_ref``) equals the reference's ``place_pallas``
    (interpret mode) and its jnp body, -1 lanes included: with max_draws=1
    a share of the lanes does not converge."""
    params = AsuraParams(max_draws=max_draws)
    c = make_cluster(CLUSTERS[name], params=params)
    len32_j, top = jops.table_prep(c.seg_lengths(), params)  # lane-padded
    ids = _ids(4096, seed=max_draws + len(name))
    kw = dict(top_level=top, s_log2=params.s_log2, max_draws=max_draws)
    want = np.asarray(place_pallas(jnp.asarray(ids), len32_j, interpret=True, **kw))
    body = np.asarray(jref.place_ref(jnp.asarray(ids), len32_j, **kw))
    got = place_cuda(_t(ids), _t(np.asarray(len32_j)), **kw)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(body, want)
    # the real table length gives the same segments as the lane-padded one
    n_segs = len(c.seg_lengths())
    assert np.array_equal(place_cuda(_t(ids), _t(np.asarray(len32_j)[:n_segs]), **kw).numpy(), want)
    assert ((want < 0).any() == (max_draws == 1)) and (want >= 0).any()
    assert np.array_equal(want, place_batch_u32(ids, np.asarray(len32_j), top, params))


def test_place_wrapper_checks_and_launches_nothing_on_cpu():
    len32, _, _, _, top = _small_tables()
    ids = _t(_ids(32))
    before = dict(LAUNCHES)
    assert place_cuda(ids, len32, top_level=top).shape == (32,)
    assert place_cuda(ids[:0], len32, top_level=top).shape == (0,)
    assert LAUNCHES == before
    with pytest.raises(TypeError):
        place_cuda(ids.to(torch.int64), len32, top_level=top)
    with pytest.raises(TypeError):
        place_cuda(ids, len32.view(torch.int32), top_level=top)
    with pytest.raises(ValueError):
        place_cuda(ids, len32, top_level=31)
    with pytest.raises(ValueError):
        place_cuda(ids, len32, top_level=top, max_draws=-1)
