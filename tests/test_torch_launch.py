"""The redesigned kernels' host-side choices and algorithms, without a card.

``repro_torch.kernels.launch`` restates, as pure functions of sizes, the
plan the CH / RS launcher computes: the index stride, its shared memory
and the persistent grid.  The card holds the launcher to these functions
(``test_torch_gpu.py``); here they are held to the sizes of the
deployments ``chip_smoke.py`` runs and to their own definitions.  NumPy
models of the algorithms the kernels changed check, lane by lane,
that counting one bucket after the sampled index lands where
``searchsorted`` lands (duplicates across bucket boundaries and padding
included), that the ladder with its top K counters in registers (B3, B4,
B8) draws exactly what a counter per level draws, that the diff
kernels' one walk for both tables (B3, B4) gives what two walks give,
that the ladder which also keeps its register levels' seeds (B1, B2,
B9) draws the generator's numbers, with B2's stats vector read from it
and summed per warp as the kernel sums it, and that the ADDITION-NUMBER
kernel's rounds (the levels above the table hashed level-major, their
stops as bit masks) give each lane the sequential trace's number.
"""

import numpy as np
import pytest

from repro_torch.core.rng import GOLDEN, KMULT, draw_u32_np, draw_u32_scalar, fmix32_scalar
from repro_torch.kernels import build, launch

BUDGET_KEYS = launch.INDEX_BUDGET // launch.KEY_BYTES


@pytest.mark.parametrize("n_keys,shift", [
    (1, 0), (128, 0),
    (4096, 0),  # an RS table at build (4096 nodes)
    (12_288, 0),  # the RS table after an add and a removal, lane-padded
    (BUDGET_KEYS, 0), (BUDGET_KEYS + 1, 1),
    (409_600, 4),  # the CH ring of 4096 nodes at 100 virtual nodes: S = 16
    (1_000_064, 6),  # 10,000 nodes, lane-padded: S = 64
    (2**31 - 1, 17),
])
def test_index_shift_at_deployment_sizes(n_keys, shift):
    assert launch.index_shift(n_keys) == shift
    assert launch.index_bytes(n_keys) <= launch.INDEX_BUDGET


@pytest.mark.parametrize("n_keys", [1, 3, 1000, 28_928, 28_929, 57_857, 409_600, 409_601,
                                    777_777, 1_000_064, 5_000_000])
def test_index_stride_is_the_least_that_fits(n_keys):
    shift = launch.index_shift(n_keys)
    S, m = 1 << shift, launch.index_entries(n_keys)
    assert (m - 1) * S < n_keys <= m * S  # every key in exactly one bucket
    assert launch.index_bytes(n_keys) == 4 * m <= launch.INDEX_BUDGET
    if shift:
        assert 4 * -(-n_keys // (S // 2)) > launch.INDEX_BUDGET


def test_index_shift_rejects_an_empty_table():
    with pytest.raises(ValueError):
        launch.index_shift(0)


@pytest.mark.parametrize("n,block,sms,bps,grid", [
    (1, 512, 132, 2, 1),
    (65_536 * 3, 512, 132, 2, 264),  # a serving batch's fan-out: capped
    (65_536, 256, 132, 2, 256),  # one pass: no more blocks than ids need
    (2**24, 256, 132, 2, 264),
    (2**24, 512, 114, 3, 342),
    (0, 256, 132, 2, 0),
])
def test_persistent_grid(n, block, sms, bps, grid):
    assert launch.persistent_grid(n, block, sms, bps) == grid


@pytest.mark.parametrize("sms,bps", [(0, 2), (132, 0)])
def test_persistent_grid_needs_a_resident_block(sms, bps):
    with pytest.raises(ValueError):
        launch.persistent_grid(1024, 256, sms, bps)


def test_plans_compose_the_choices():
    p = launch.baseline_plan("ch", 2**24, 409_600, 132, 2)
    assert p == dict(shift=4, smem=102_400, block=launch.SEARCH_THREADS, blocks_per_sm=2,
                     sms=132, grid=264)
    p = launch.baseline_plan("rs", 1000, 12_288, 132, 4)
    assert (p["shift"], p["smem"], p["grid"]) == (0, 49_152, 2)
    p = launch.baseline_plan("wrh", 2**20, 4096, 0, 0)
    assert (p["shift"], p["smem"], p["block"], p["grid"]) == (0, 0, 256, 4096)


# ---------------------------------------------------------------------------
# a NumPy model of the CH / RS kernels' two-level search
# ---------------------------------------------------------------------------


def indexed_search(keys: np.ndarray, h: np.ndarray, side_left: bool, shift: int) -> np.ndarray:
    """The kernels' search, lane by lane: the branchless lower bound over
    the index keys[j << shift], then the count of passing keys in the
    one bucket it names."""
    n, S = keys.shape[0], 1 << shift
    idx = keys[::S]
    out = np.empty(h.shape[0], dtype=np.int64)
    for lane, x in enumerate(h):
        def passes(k):
            return k < x if side_left else k <= x
        base, length = 0, idx.shape[0]
        while length > 1:
            half = length >> 1
            base += half if passes(idx[base + half - 1]) else 0
            length -= half
        b = base + int(passes(idx[base]))
        if shift == 0 or b == 0:
            out[lane] = b
            continue
        lo = (b - 1) << shift
        out[lane] = lo + int(sum(passes(k) for k in keys[lo: min(lo + S, n)]))
    return out


def _edge_hashes(keys: np.ndarray) -> np.ndarray:
    p = keys.astype(np.int64)
    h = np.concatenate([[0, 1, 2**32 - 2, 2**32 - 1], p - 1, p, p + 1])
    return np.unique(np.clip(h, 0, 2**32 - 1)).astype(np.uint32)


@pytest.mark.parametrize("shift", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("n", [1, 7, 128, 200, 333])
def test_indexed_search_lands_where_searchsorted_lands(n, shift):
    rng = np.random.default_rng(n * 8 + shift)
    keys = np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))
    if n > 20:  # runs of equal keys across every bucket boundary
        S = 1 << shift
        for b in range(S, n - 2, S):
            keys[b - 2: b + 3] = keys[b - 2]
        keys[-3:] = np.uint32(0xFFFFFFFF)  # the lane padding
        keys = np.sort(keys)
    h = np.concatenate([_edge_hashes(keys), keys[:: max(1, 1 << shift)],
                        rng.integers(0, 2**32, 64, dtype=np.uint32)])
    for side_left in (True, False):
        want = np.searchsorted(keys, h, side="left" if side_left else "right")
        assert np.array_equal(indexed_search(keys, h, side_left, shift), want)


# ---------------------------------------------------------------------------
# a NumPy model of the ladder counters (csrc/asura_lane.cuh)
# ---------------------------------------------------------------------------


def _draw(lane_id, level, counter) -> int:
    return draw_u32_scalar(int(lane_id), level, counter)


def test_model_draws_are_the_generator():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 2**32, 200, dtype=np.uint32)
    levels = rng.integers(0, 32, 200)
    ctrs = rng.integers(0, 2**32, 200, dtype=np.uint32)
    want = draw_u32_np(ids, levels, ctrs)
    assert [_draw(i, int(lv), int(c)) for i, lv, c in zip(ids, levels, ctrs)] == want.tolist()


class ArrayLadder:
    """A counter per level, indexed by level: the plain ladder the
    register ladders below are held to."""

    def reset(self, top):
        self.ctr = [0] * (top + 1)

    def next(self, lane_id, top):
        level = top
        while True:
            h = _draw(lane_id, level, self.ctr[level])
            self.ctr[level] += 1
            if level == 0 or h >= 2**31:
                return level, h
            level -= 1


class TopLadder:
    """The top K counters by distance from the top, the deeper ones in a
    lazily zeroed array that keeps stale values from earlier resets."""

    def __init__(self, K):
        self.K, self.deep = K, [0xDEAD] * 32

    def reset(self, top):
        self.c, self.fresh = [0] * self.K, top - self.K + 1

    def next(self, lane_id, top):
        for j in range(self.K):
            level = top - j
            h = _draw(lane_id, level, self.c[j])
            self.c[j] += 1
            if level == 0 or h >= 2**31:
                return level, h
        while True:
            level -= 1
            if level < self.fresh:
                self.deep[level], self.fresh = 0, level
            h = _draw(lane_id, level, self.deep[level])
            self.deep[level] += 1
            if level == 0 or h >= 2**31:
                return level, h


@pytest.mark.parametrize("K", [1, 4, 6])
def test_top_ladder_draws_what_a_counter_per_level_draws(K):
    """Draw sequences of one lane over several resets (a B8 lane: level 1,
    then one level-2 placement per replica) at top levels below, at and
    above K, with the deep array reused across resets."""
    rng = np.random.default_rng(K)
    for lane_id in rng.integers(0, 2**32, 12, dtype=np.uint32):
        want, got = ArrayLadder(), TopLadder(K)
        for top in (12, 3, K - 1 if K > 1 else 0, K, 20, 6):
            want.reset(top)
            got.reset(top)
            seq_w = [want.next(int(lane_id), top) for _ in range(40)]
            seq_g = [got.next(int(lane_id), top) for _ in range(40)]
            assert seq_g == seq_w


def test_build_names_the_selection_word_source_and_resolves_it_without_nvcc(monkeypatch):
    assert build.SOURCES == ("asura_place", "baselines", "hierarchy", "traffic", "serve")
    assert build.source_files("traffic") == [build.CSRC / "traffic.cu"]
    assert build.source_files("serve") == [build.CSRC / "serve.cu"]
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    path = build.library_path("traffic")
    assert path.parent == build.BUILD_DIR and path.name.startswith("traffic-")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_parse_ptxas_reads_registers_stack_and_spills():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113lookup_kernelINS_8ChLookupEEEvT_PKjPix' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113lookup_kernelINS_8ChLookupEEEvT_PKjPix
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z12place_kernelPKjS0_Piiiii' for 'sm_90a'
ptxas info    : Function properties for _Z12place_kernelPKjS0_Piiiii
    128 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers, 388 bytes cmem[0]
"""
    got = build.parse_ptxas(log)
    assert got == {
        "_ZN12_GLOBAL__N_113lookup_kernelINS_8ChLookupEEEvT_PKjPix":
            dict(registers=26, stack=0, spill_stores=0, spill_loads=0),
        "_Z12place_kernelPKjS0_Piiiii":
            dict(registers=40, stack=128, spill_stores=4, spill_loads=8),
    }


# ---------------------------------------------------------------------------
# a NumPy model of the diff kernels' joint walk (B3, B4: diff_nodes_lane_with,
# diff_replicas_lane_with in csrc/asura_lane.cuh)
# ---------------------------------------------------------------------------

S_LOG2 = 1


def _split(level, h):
    return h >> (32 - S_LOG2 - level), (h << (S_LOG2 + level)) & 0xFFFFFFFF


def _hits(k, f, len32) -> bool:
    return k < len(len32) and f < int(len32[k])


def diff_lane(lane_id, tables, *, max_draws, R=None, K=6):
    """One lane of B3 (``R`` None: each table's first hit segment, -1 for
    none; the kernel then resolves a tail and gathers) or of B4 (each
    table's first R distinct nodes, -1 padded), both tables in one walk of
    the deeper ladder, every number from its top.  ``tables`` is ((len32,
    node_of, top) of A, of B); returns [A's result, B's result].  A number
    is tested against a table only if it reached that table's top; each
    table counts its own numbers against its cap."""
    hi, lo = (0, 1) if tables[0][2] >= tables[1][2] else (1, 0)
    top_hi = tables[hi][2]
    ladder = TopLadder(K)
    ladder.reset(top_hi)
    cap = max_draws if R is None else max_draws * max(1, R)
    left, picked = [cap, cap], [[], []]
    while left[hi] > 0 or left[lo] > 0:
        level, h = ladder.next(lane_id, top_hi)
        k, f = _split(level, h)
        for t in (hi, lo):
            len32, node_of, top = tables[t]
            if left[t] == 0 or level > top:
                continue
            left[t] -= 1
            if not _hits(k, f, len32):
                continue
            if R is None:
                picked[t], left[t] = [k], 0
                continue
            if int(node_of[k]) not in picked[t]:
                picked[t].append(int(node_of[k]))
            if len(picked[t]) == R:
                left[t] = 0
    if R is None:
        return [p[0] if p else -1 for p in picked]
    return [p + [-1] * (R - len(p)) for p in picked]


def single_lane(lane_id, table, *, max_draws, R=None):
    """B1's bounded loop (``R`` None) or B2's, one table, a counter per
    level: what the reference's diff kernels run once per table."""
    len32, node_of, top = table
    ladder = ArrayLadder()
    ladder.reset(top)
    picked = []
    for _ in range(max_draws if R is None else max_draws * max(1, R)):
        k, f = _split(*ladder.next(lane_id, top))
        if not _hits(k, f, len32):
            continue
        if R is None:
            return k
        if int(node_of[k]) not in picked:
            picked.append(int(node_of[k]))
        if len(picked) == R:
            break
    return -1 if R is None else picked + [-1] * (R - len(picked))


def model_table(top, seed, holes=0):
    """(len32, node_of, top): a table whose ladder tops out at ``top``
    (s_log2 = 1: 2**top < n_segs <= 2**(top + 1)), one node per segment
    and ``holes`` length-0 holes (node -1)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2**top + 1, 2 ** (top + 1) + 1))
    len32 = np.round(rng.uniform(0.3, 0.999, n) * 2**32).astype(np.uint32)
    node_of = np.arange(n, dtype=np.int32)
    gone = rng.choice(n, holes, replace=False)
    len32[gone], node_of[gone] = 0, -1
    return len32, node_of, top


# (top of A, top of B): equal, B one and two above A, B one below (an
# add's tables swapped: the top goes down), and ladders deeper than K
JOINT_TOPS = [(3, 3), (3, 4), (3, 5), (4, 3), (9, 12)]


@pytest.mark.parametrize("max_draws", [0, 1, 128])
@pytest.mark.parametrize("tops", JOINT_TOPS)
def test_joint_walk_equals_two_walks_b3(tops, max_draws):
    """B3 keeps K = 4 counters in registers; K = 2 sends more consults to
    the deep array."""
    tables = [model_table(tops[0], 1, holes=2), model_table(tops[1], 2, holes=1)]
    rng = np.random.default_rng(tops[0] * 100 + tops[1] + max_draws)
    for lane_id in map(int, rng.integers(0, 2**32, 200, dtype=np.uint32)):
        want = [single_lane(lane_id, t, max_draws=max_draws) for t in tables]
        for K in (4, 2):
            assert diff_lane(lane_id, tables, max_draws=max_draws, K=K) == want, (lane_id, K)


@pytest.mark.parametrize("R", [1, 3, 12])
@pytest.mark.parametrize("max_draws", [0, 1, 128])
@pytest.mark.parametrize("tops", JOINT_TOPS)
def test_joint_walk_equals_two_walks_b4(tops, max_draws, R):
    """B4 keeps K = 6 counters in registers."""
    tables = [model_table(tops[0], 3, holes=1), model_table(tops[1], 4, holes=3)]
    rng = np.random.default_rng(tops[0] * 100 + tops[1] + R)
    for lane_id in map(int, rng.integers(0, 2**32, 100, dtype=np.uint32)):
        want = [single_lane(lane_id, t, max_draws=max_draws, R=R) for t in tables]
        for K in (6, 2):
            got = diff_lane(lane_id, tables, max_draws=max_draws, R=R, K=K)
            assert got == want, (lane_id, K)


# ---------------------------------------------------------------------------
# a model of B4's alignment epilogue (align_registers / align_rows in
# csrc/asura_place.cu), held to the plain alignment (ops.align_replica_sets)
# ---------------------------------------------------------------------------


def align_epilogue(b, a, *, rows=False):
    """One lane of B4's alignment epilogue on its before set ``b`` and after
    set ``a`` (R ints each, -1 for unfilled slots) -> (moved, src, dst,
    src_slot) lists.  ``rows`` False: the register form (the lost slots as a
    bit mask, each new slot taking the lowest left); True: the row form of
    R > 8 (the next lost slot found by scanning on from the last)."""
    R = len(a)
    lost = sum(1 << j for j in range(R) if b[j] not in a)
    nxt = 0
    moved, src, slot = [], [], []
    for r in range(R):
        held = a[r] in b
        s, t = a[r], r
        if not held:
            s, t = 0, 0
            if not rows and lost:
                t = (lost & -lost).bit_length() - 1
                lost &= lost - 1
                s = b[t]
            while rows and nxt < R:
                nxt += 1
                if b[nxt - 1] not in a:
                    s, t = b[nxt - 1], nxt - 1
                    break
        moved.append(not held)
        src.append(s)
        slot.append(t)
    return moved, src, list(a), slot


# (before, after) rows, R = 4, that the epilogue has to align as the plain
# version does: -1 marks an unfilled slot (a lane out of draws), so a set
# may hold it more than once and a row may gain more new slots than it
# loses (those take source 0, slot 0, the plain version's empty sum)
ALIGN_ROWS = {
    "all moved": ([1, 2, 3, 4], [5, 6, 7, 8]),
    "none moved": ([1, 2, 3, 4], [1, 2, 3, 4]),
    "common nodes permuted": ([1, 2, 3, 4], [4, 3, 1, 2]),
    "one in, the rest shifted": ([1, 2, 3, 4], [2, 3, 4, 9]),
    "node 0 vacated": ([0, 1, 2, 3], [4, 1, 2, 3]),
    "several -1s": ([1, -1, -1, -1], [2, 1, -1, -1]),
    "-1s filled": ([1, 2, -1, -1], [3, 1, 4, 2]),
    "-1s left": ([3, 1, 4, 2], [1, -1, 2, -1]),
    "more new slots than lost": ([1, 2, -1, -1], [3, 4, 5, -1]),
    "all -1 before": ([-1, -1, -1, -1], [1, 2, 3, 4]),
    "all -1 after": ([1, 2, 3, 4], [-1, -1, -1, -1]),
}


def align_rows_random(R, n, seed):
    """(before, after), each (n, R) int32: rows of distinct nodes out of R +
    3, each filled up to a random slot and -1 after it."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        sets = np.stack([rng.permutation(R + 3)[:R] for _ in range(n)]).astype(np.int32)
        filled = rng.integers(0, R + 1, n)
        sets[np.arange(R)[None, :] >= filled[:, None]] = -1
        out.append(sets)
    return out


@pytest.mark.parametrize("rows", [False, True])
def test_alignment_epilogue_model_equals_the_plain_alignment(rows):
    import torch

    from repro_torch.kernels.ops import align_replica_sets

    cases = [(np.array([b], np.int32), np.array([a], np.int32)) for b, a in ALIGN_ROWS.values()]
    cases += [align_rows_random(R, 300, R) for R in (1, 2, 3, 5, 8, 9, 12)]
    for before, after in cases:
        want = align_replica_sets(torch.from_numpy(before), torch.from_numpy(after))
        want = [list(zip(*(t[i].tolist() for t in want))) for i in range(len(before))]
        for i, (b, a) in enumerate(zip(before.tolist(), after.tolist())):
            assert list(zip(*align_epilogue(b, a, rows=rows))) == want[i], (b, a)


# ---------------------------------------------------------------------------
# a NumPy model of B1 / B2 / B9's ladder, which also keeps its top
# levels' seeds (TopLadder<K, S> in csrc/asura_lane.cuh), and of B2's
# stats vector read from it and summed per warp (place_replicas_kernel in
# csrc/asura_place.cu)
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF
DEPTH_BINS = 34  # the stats vector: [draws of depth 0 .. 33, unfilled slots]


def _level_seed(lane_id, level) -> int:
    return fmix32_scalar((lane_id + GOLDEN * (level + 1)) & M32)


def _draw_seeded(seed, counter) -> int:
    return fmix32_scalar(seed ^ ((counter * KMULT) & M32))


class SeededTopLadder(TopLadder):
    """TopLadder whose top ``seeds`` levels draw from seeds hashed at the
    reset; the other levels hash every draw in full.  ``draws`` logs
    every (level, counter, draw)."""

    def __init__(self, K, seeds):
        super().__init__(K)
        self.seeds = seeds

    def reset(self, top, lane_id):
        super().reset(top)
        self.seed = [_level_seed(lane_id, top - j) for j in range(self.seeds)]
        self.draws = []

    def next(self, lane_id, top):
        for j in range(self.K):
            level = top - j
            if j < self.seeds:
                h = _draw_seeded(self.seed[j], self.c[j])
            else:
                h = _draw(lane_id, level, self.c[j])
            self.draws.append((level, self.c[j], h))
            self.c[j] += 1
            if level == 0 or h >= 2**31:
                return level, h
        while True:
            level -= 1
            if level < self.fresh:
                self.deep[level], self.fresh = 0, level
            h = _draw(lane_id, level, self.deep[level])
            self.draws.append((level, self.deep[level], h))
            self.deep[level] += 1
            if level == 0 or h >= 2**31:
                return level, h

    def depth_hist(self, top):
        """(hot, deep): the draws of depth 1 .. K from the register
        counters' differences (depth K less the counter of level top - K,
        0 unless zeroed since the reset), and {depth: count} of the deeper
        depths from the deep levels in [fresh, top - K]."""
        K, c = self.K, self.c
        hot = [(c[j] - c[j + 1]) & M32 for j in range(K - 1)]
        below = top - K
        hot.append((c[K - 1] - (self.deep[below] if below >= self.fresh else 0)) & M32)
        deep = {}
        for level in range(below, self.fresh - 1, -1):
            here = (self.deep[level] - (self.deep[level - 1] if level > self.fresh else 0)) & M32
            if here:
                deep[top - level + 1] = here
        return hot, deep


def replicas_lane(lane_id, table, ladder, *, max_draws, R):
    """B2's per-lane body: the first R hits on distinct nodes within
    max_draws * max(1, R) draws -> (the R segments, -1 padded; slots
    filled).  The ladder is left holding the lane's counters."""
    len32, node_of, top = table
    if isinstance(ladder, SeededTopLadder):
        ladder.reset(top, lane_id)
    else:
        ladder.reset(top)
    segs, nodes = [], []
    for _ in range(max_draws * max(1, R)):
        if len(segs) == R:
            break
        k, f = _split(*ladder.next(lane_id, top))
        if _hits(k, f, len32) and int(node_of[k]) not in nodes:
            segs.append(k)
            nodes.append(int(node_of[k]))
    return segs + [-1] * (R - len(segs)), len(segs)


def stats_per_level(ids, table, *, max_draws, R):
    """The stats vector as the counter-per-level kernel built it: each
    lane's draws of depth top - level + 1 = ctr[level] - ctr[level - 1],
    and its unfilled slots, summed (mod 2**32)."""
    top = table[2]
    rows, stats = [], [0] * (DEPTH_BINS + 1)
    for lane_id in ids:
        ladder = ArrayLadder()
        row, found = replicas_lane(int(lane_id), table, ladder, max_draws=max_draws, R=R)
        rows.append(row)
        for level in range(top, -1, -1):
            here = ladder.ctr[level] - (ladder.ctr[level - 1] if level > 0 else 0)
            stats[top - level + 1] = (stats[top - level + 1] + here) & M32
        stats[DEPTH_BINS] = (stats[DEPTH_BINS] + R - found) & M32
    return rows, stats


def stats_warp_summed(ids, table, *, max_draws, R, K, seeds, block=256):
    """The kernel's epilogue: each lane's depths 1 .. K and unfilled slots
    summed over its 32-lane warp (lanes past n take part with zeros) and
    added by one lane to its block's histogram, the deeper depths added
    per lane, each block's histogram then added to the vector."""
    top = table[2]
    rows, stats = [], [0] * (DEPTH_BINS + 1)
    n = len(ids)
    for b0 in range(0, n, block):
        block_hist = [0] * (DEPTH_BINS + 1)
        for w0 in range(b0, b0 + block, 32):
            warp = [[0] * (K + 1) for _ in range(32)]  # hot depths, then unfilled slots
            for lane in range(32):
                if w0 + lane >= n:
                    continue
                ladder = SeededTopLadder(K, seeds)
                row, found = replicas_lane(int(ids[w0 + lane]), table, ladder,
                                           max_draws=max_draws, R=R)
                rows.append(row)
                hot, deep = ladder.depth_hist(top)
                warp[lane][:K] = hot
                warp[lane][K] = R - found
                for d, count in deep.items():
                    block_hist[d] = (block_hist[d] + count) & M32
            for b in range(K + 1):
                total = sum(warp[lane][b] for lane in range(32)) & M32
                bin_ = b + 1 if b < K else DEPTH_BINS
                block_hist[bin_] = (block_hist[bin_] + total) & M32
        stats = [(x + y) & M32 for x, y in zip(stats, block_hist)]
    return rows, stats


@pytest.mark.parametrize("K,seeds", [(1, 0), (1, 1), (4, 2), (4, 4), (6, 3), (6, 6), (8, 8)])
def test_seeded_ladder_draws_the_generator(K, seeds):
    """Every draw of the seeded ladder is ``draw_u32_scalar`` of its
    (level, counter), and its sequence is the counter-per-level ladder's
    over several resets (tops below, at and above K, deep array reused)."""
    rng = np.random.default_rng(K * 10 + seeds)
    for lane_id in map(int, rng.integers(0, 2**32, 12, dtype=np.uint32)):
        want, got = ArrayLadder(), SeededTopLadder(K, seeds)
        for top in (12, 0, 3, K - 1 if K > 1 else 0, K, 20, 6):
            want.reset(top)
            got.reset(top, lane_id)
            seq_w = [want.next(lane_id, top) for _ in range(40)]
            seq_g = [got.next(lane_id, top) for _ in range(40)]
            assert seq_g == seq_w
            assert all(h == draw_u32_scalar(lane_id, lv, c) for lv, c, h in got.draws)


# (top level, holes): tops below, at and above the kernels' K, a one-level
# (top 0) table, and length-0 holes
REPLICA_TABLES = [(0, 0), (3, 2), (6, 1), (12, 3)]


@pytest.mark.parametrize("R", [1, 3, 12])
@pytest.mark.parametrize("max_draws", [0, 1, 128])
@pytest.mark.parametrize("top,holes", REPLICA_TABLES)
def test_b2_lane_and_warp_summed_stats_on_seeded_ladder(top, holes, max_draws, R):
    """B2's lane on the seeded ladder gives the counter-per-level lane's
    rows, and its stats vector, read from the ladder and summed per warp
    over 100 lanes (not a multiple of 32), the per-level stats; K = 6
    with five seeds kept (B2's ladder) and K = 4 with every register
    level's."""
    table = model_table(top, 5 + top, holes=holes)
    ids = np.random.default_rng(top * 7 + max_draws + R).integers(0, 2**32, 100,
                                                                   dtype=np.uint32)
    want_rows, want_stats = stats_per_level(ids, table, max_draws=max_draws, R=R)
    for K, seeds in ((6, 5), (4, 4)):
        rows, stats = stats_warp_summed(ids, table, max_draws=max_draws, R=R, K=K,
                                        seeds=seeds)
        assert rows == want_rows
        assert stats == want_stats


@pytest.mark.parametrize("n", [1, 31, 33, 257, 300])
def test_warp_summed_stats_on_ragged_batches(n):
    """Batches that end inside a warp or a block (300 = 256 + 44) on a
    ladder deeper than K, so that deep depths are counted per lane."""
    table = model_table(9, 11, holes=4)
    ids = np.random.default_rng(n).integers(0, 2**32, n, dtype=np.uint32)
    want_rows, want_stats = stats_per_level(ids, table, max_draws=128, R=3)
    rows, stats = stats_warp_summed(ids, table, max_draws=128, R=3, K=4, seeds=2)
    assert rows == want_rows and stats == want_stats
    assert sum(stats[6:DEPTH_BINS]) > 0 or n < 33  # deep depths were reached


# ---------------------------------------------------------------------------
# a model of the ADDITION-NUMBER kernel's rounds (AdditionNumberTrace in
# csrc/asura_lane.cuh, the launcher's high levels in csrc/asura_place.cu)
# ---------------------------------------------------------------------------

NO_K = 0x7FFFFFFF  # the reference's sentinel key (NO_K, 0)


def high_levels(n_segs, top, k_high) -> int:
    """The launcher's count of levels run level-major: from ``top`` down,
    those whose stopping numbers are misses past the table (a number that
    stops at level L >= 1 has k >= 2**(s + L - 1) >= n_segs), at most
    ``k_high``."""
    low = max(1, (n_segs - 1).bit_length() - S_LOG2 + 1)
    return min(k_high, max(0, top - low + 1))


def _nth_clear_bit(mask, nth) -> int:
    """``__fns(~mask, 0, nth + 1)``: the position of the nth (from 0) clear bit."""
    for b in range(32):
        if not (mask >> b) & 1:
            if nth == 0:
                return b
            nth -= 1
    raise AssertionError("no such bit")


def addition_number_sequential(lane_id, table, top, *, max_draws, R) -> int:
    """The trace as the reference runs it: one number after another from a
    counter per level, the minimum (k, f) of the unused numbers below the
    sentinel, until R distinct nodes or the cap."""
    len32, node_of, _ = table
    ladder = ArrayLadder()
    ladder.reset(top)
    nodes, best = [], (NO_K, 0)
    for _ in range(max_draws * max(1, R)):
        if len(nodes) >= R:
            break
        k, f = _split(*ladder.next(lane_id, top))
        if _hits(k, f, len32) and int(node_of[k]) not in nodes:
            nodes.append(int(node_of[k]))
        else:
            best = min(best, (k, f))
    return best[0] if len(nodes) >= R and best[0] != NO_K else -1


def addition_number_rounds(lane_id, table, top, *, max_draws, R, k_round=32, k_high=3) -> int:
    """The kernel's trace: rounds of up to ``k_round`` numbers, the high
    levels' draws hashed level-major with their stops as bit masks, B2's
    ladder walked only by the numbers passing them, and the high stops'
    minimum kept per round (lowest level first), or, in the round the
    trace ends in, over the numbers before the one that ended it, hashed
    again."""
    len32, node_of, _ = table
    high = high_levels(len(len32), top, k_high)
    seed = [_level_seed(lane_id, top - i) for i in range(high)]
    c = [0] * high
    ladder = TopLadder(6)
    ladder.reset(top - high)
    nodes, least_key, best_high = [], (NO_K, 0), None  # best_high: (level index, draw)
    left = max_draws * max(1, R)

    def keep(i, h):
        nonlocal best_high
        if best_high is None or i > best_high[0] or (i == best_high[0] and h < best_high[1]):
            best_high = (i, h)

    while left > 0 and len(nodes) < R:
        n = min(k_round, left)
        stops, least, consults, reach = [0] * high, [M32] * high, [0] * high, n
        for i in range(high):
            consults[i] = reach
            for j in range(reach):
                h = _draw_seeded(seed[i], (c[i] + j) & M32)
                if h >= 2**31:
                    stops[i] |= 1 << j
                    least[i] = min(least[i], h)
            c[i] += reach
            reach -= bin(stops[i]).count("1")
        ended_at = None
        for t in range(reach):
            k, f = _split(*ladder.next(lane_id, top - high))
            if _hits(k, f, len32) and int(node_of[k]) not in nodes:
                nodes.append(int(node_of[k]))
            else:
                least_key = min(least_key, (k, f))
            if len(nodes) >= R:
                ended_at = t
                break
        if ended_at is None:
            left -= n
            for i in range(high):
                if stops[i]:
                    keep(i, least[i])
            continue
        if least_key != (NO_K, 0):
            break
        pos = ended_at
        for i in reversed(range(high)):
            pos = _nth_clear_bit(stops[i], pos)
        before, lowest, drawn = pos, -1, 0
        for i in range(high):
            here = bin(stops[i] & ((1 << before) - 1)).count("1")
            if here:
                lowest, drawn = i, before
            before -= here
        if lowest >= 0:
            base = c[lowest] - consults[lowest]
            keep(lowest, min(_draw_seeded(seed[lowest], (base + j) & M32)
                             for j in range(drawn) if (stops[lowest] >> j) & 1))
        break
    if len(nodes) < R:
        return -1
    if least_key != (NO_K, 0):
        return least_key[0]
    if best_high is None:
        return -1
    i, h = best_high
    k = h >> (32 - S_LOG2 - (top - i))
    return k if k != NO_K else -1


def test_high_levels_are_misses_past_the_table():
    """Every level the launcher runs level-major stops its numbers past
    the table: k >= 2**(s + L - 1) >= n_segs at each such level L."""
    for n_segs in (1, 2, 3, 4, 5, 100, 6839, 8192, 8193, 2**30):
        for top in range(0, 31):
            high = high_levels(n_segs, top, 30)
            assert high <= top
            for i in range(high):
                assert 2 ** (S_LOG2 + (top - i) - 1) >= n_segs
            if high < top:  # the first level below them may hold a table hit
                assert top - high == 0 or 2 ** (S_LOG2 + (top - high) - 1) < n_segs


# (table top, extended trace top): the main path's four extra levels,
# fewer, none, and a trace deep enough that most lanes do not converge
AN_LADDERS = [(2, 6), (5, 9), (5, 7), (5, 5), (9, 13), (9, 10), (3, 18)]


@pytest.mark.parametrize("k_round,k_high", [(32, 3), (32, 1), (32, 4), (5, 3)])
@pytest.mark.parametrize("R", [1, 3, 9])
@pytest.mark.parametrize("tops", AN_LADDERS)
def test_addition_number_rounds_equal_the_sequential_trace(tops, R, k_round, k_high):
    """The kernel's rounds give every lane the sequential trace's number,
    -1 lanes included: rounds ended by the cap (max_draws 1 and 2) and by
    the R-th node, lanes whose minimum is a high stop before that node
    (R = 1 mostly), small rounds that end often and several high-level
    counts.  The sequential model is the twin's (checked below)."""
    table_top, top = tops
    table = model_table(table_top, seed=table_top + R, holes=1)
    rng = np.random.default_rng(100 * table_top + top + R)
    for lane_id in rng.integers(0, 2**32, 60, dtype=np.uint32):
        for max_draws in (128, 2, 1):
            want = addition_number_sequential(int(lane_id), table, top, max_draws=max_draws, R=R)
            got = addition_number_rounds(int(lane_id), table, top, max_draws=max_draws, R=R,
                                         k_round=k_round, k_high=k_high)
            assert got == want, (int(lane_id), max_draws)


@pytest.mark.parametrize("tops", AN_LADDERS)
def test_sequential_addition_number_is_the_twin(tops):
    import torch

    from repro_torch.kernels import ref

    table_top, top = tops
    len32, node_of, _ = table = model_table(table_top, seed=table_top, holes=1)
    ids = np.random.default_rng(top).integers(0, 2**32, 200, dtype=np.uint32)
    for R in (1, 3):
        want = ref.addition_numbers_ref(
            torch.from_numpy(ids), torch.from_numpy(len32), torch.from_numpy(node_of),
            top_level=top, s_log2=S_LOG2, max_draws=128, n_replicas=R).tolist()
        got = [addition_number_sequential(int(i), table, top, max_draws=128, R=R) for i in ids]
        assert got == want
