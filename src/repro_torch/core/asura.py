"""ASURA STEP 2 on the host: the port's own copy of the exact oracles.

The reference package's NumPy layer, copied rather than imported so the
port stands alone (no module of the reference is ever loaded):

  * ``AsuraParams``        -- the doubling generator-family ladder of
                              section 2.C (alpha = 2, S = 2**s_log2),
  * ``place_scalar`` / ``place_replicas_scalar`` -- the per-datum oracles
                              with true per-level counters,
  * ``place_batch_u32`` / ``place_replicas_u32`` -- the vectorized NumPy
                              batch paths (the engine's ``numpy`` backend),
  * ``resolve_tail_np``    -- the exact-integer fallback for lanes the
                              bounded loop leaves unplaced (DESIGN.md
                              section 3.2), which the CUDA kernel and the
                              torch twin reproduce bit for bit.

Exact integer formulation: with alpha = 2 and S a power of two every
test is a pure uint32 operation on the raw draw ``h``

    descend = h < 2**31,  k = h >> (32 - s - l),
    frac32  = (h << (s + l)) mod 2**32,  hit = frac32 < len32[k]

so no float round-off can reorder a boundary between implementations.
The section 2.D migration metadata is here too: ``placement_trace``,
``addition_number`` / ``remove_numbers`` (scalar oracles),
``addition_numbers_batch`` / ``remove_numbers_batch`` (their vectorized
twins) and ``align_replica_sets`` (the per-slot replica-set alignment
the migration planner's device path reproduces bit for bit).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from .rng import GOLDEN, KMULT, draw_u32_np, draw_u32_scalar, fmix32_np

_2_32 = 2.0**32


def lengths_to_u32(seg_lengths: Sequence[float]) -> np.ndarray:
    """Canonical integer segment lengths: round(length * 2**32), < 2**32."""
    lengths = np.asarray(seg_lengths, dtype=np.float64)
    if np.any(lengths < 0) or np.any(lengths >= 1.0):
        raise ValueError("segment lengths must lie in [0, 1)")
    return np.minimum(np.round(lengths * _2_32), _2_32 - 1).astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class AsuraParams:
    """Generator-family parameters (paper section 2.C / Appendix B).

    s_log2: log2 of the DEFAULT_MAXIMUM_RANDOM_NUMBER in the Appendix-A
        pseudocode (the level-0 range).  The paper's evaluation used 16
        (s_log2=4); we default to 2**1 = 2 so the raw-draw hit rate stays
        >= ~1/4 even for a single half-full node (Appendix B's expectation
        depends only on h/n once n >> S).
    max_draws: trip count of the bounded batched loop.  Appendix B bounds
        expected draws per placement by (S*a**x/(n-h)) * a/(a-1) <= 4 for
        hole fraction <= 1/2, so 128 draws miss with p < 2**-53 per lane.
    """

    s_log2: int = 1
    max_draws: int = 128

    def __post_init__(self):
        if not (1 <= self.s_log2 <= 16):
            raise ValueError("s_log2 must be in [1, 16]")

    @property
    def s_initial(self) -> float:
        return float(2**self.s_log2)

    def level_for(self, upper: float) -> int:
        """Smallest level L with 2**(s+L) >= upper (Appendix B eq. (1))."""
        level = max(0, int(math.ceil(math.log2(max(upper, 1.0)))) - self.s_log2)
        if self.s_log2 + level > 31:
            raise ValueError("segment space exceeds 2**31; unsupported")
        return level

    def range_at(self, level: int) -> float:
        return float(2 ** (self.s_log2 + level))


DEFAULT_PARAMS = AsuraParams()


def _upper_bound(seg_lengths: np.ndarray) -> float:
    """n of Appendix B: max occupied segment number + its length."""
    occupied = np.nonzero(seg_lengths > 0)[0]
    if occupied.size == 0:
        raise ValueError("segment table has no occupied segments")
    last = int(occupied[-1])
    return last + float(seg_lengths[last])


def tail_cumsum_halves(len32: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The u64 inclusive length-cumsum as two u32 halves (hi, lo).

    This is the device-side representation of the section 3.2 tail spec:
    ``cum = cumsum(len32)`` needs up to 63 bits (n_segs < 2**31), which TPUs
    do not carry natively, so the table artifact stores ``cum >> 32`` and
    ``cum & 0xFFFFFFFF`` separately and the kernels compare 64-bit values
    through the halves.  Computed on the host once per table version.
    """
    cum = np.cumsum(np.asarray(len32, dtype=np.uint32).astype(np.uint64))
    return (
        (cum >> np.uint64(32)).astype(np.uint32),
        (cum & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )


def resolve_tail_np(
    datum_ids: np.ndarray,
    result: np.ndarray,
    len32: np.ndarray,
    top_level: int,
) -> np.ndarray:
    """Exact-integer fallback for non-converged lanes (DESIGN.md section 3.2).

    Lanes still at -1 after the bounded draw loop (p < 2**-53 per lane) get a
    uniform draw over the occupied u32 mass: one raw draw h at level
    ``top_level + 1`` (counter 0) is scaled by the exact total mass T,

        u = (h * T) >> 32,    u in [0, T),    T = sum(len32),

    and mapped to the segment whose inclusive u64 cumsum first exceeds u.
    The product h * T needs up to 95 bits (T < 2**63 since n_segs < 2**31),
    so it is evaluated exactly through 32-bit halves of T:

        u = h * (T >> 32) + ((h * (T & 0xFFFFFFFF)) >> 32)

    where both terms fit uint64.  Pure integer arithmetic, so every
    implementation (NumPy batch, jnp reference, Pallas wrapper) resolves the
    tail bit-identically.  Trailing zero-length padding in ``len32`` never
    wins (its cumsum equals the total).
    """
    result = np.asarray(result)
    miss = result < 0
    if not miss.any():
        return result
    len32 = np.asarray(len32, dtype=np.uint32)
    cum = np.cumsum(len32.astype(np.uint64))
    total = cum[-1]
    ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
    h = draw_u32_np(
        ids[miss], np.uint32(top_level + 1), np.zeros(int(miss.sum()), np.uint32)
    ).astype(np.uint64)
    hi, lo = total >> np.uint64(32), total & np.uint64(0xFFFFFFFF)
    u = h * hi + ((h * lo) >> np.uint64(32))
    result = result.copy()
    result[miss] = np.searchsorted(cum, u, side="right")
    return result


class _AsuraStream:
    """Per-datum ASURA random number stream with true per-level counters."""

    def __init__(self, datum_id: int, top_level: int, params: AsuraParams):
        self.datum_id = int(datum_id) & 0xFFFFFFFF
        self.top_level = top_level
        self.params = params
        self.counters = [0] * (top_level + 1)

    def next(self) -> tuple[int, int]:
        """One ASURA random number as (k, frac32); value = k + frac32/2**32."""
        level = self.top_level
        s = self.params.s_log2
        while True:
            h = draw_u32_scalar(self.datum_id, level, self.counters[level])
            self.counters[level] += 1
            if level > 0 and h < 2**31:
                level -= 1  # value in next-narrower range: consult it instead
                continue
            k = h >> (32 - s - level)
            frac32 = (h << (s + level)) & 0xFFFFFFFF
            return k, frac32

    def next_value(self) -> float:
        k, frac32 = self.next()
        return k + frac32 / _2_32


def place_scalar(
    datum_id: int,
    seg_lengths: Sequence[float],
    params: AsuraParams = DEFAULT_PARAMS,
) -> int:
    """Paper STEP 2: the segment number storing ``datum_id``.

    seg_lengths[k] is the length (0 <= len < 1) of segment k, 0.0 for holes.
    Deterministic in ``datum_id``.
    """
    lengths = np.asarray(seg_lengths, dtype=np.float64)
    len32 = lengths_to_u32(lengths)
    n_segs = len(len32)
    stream = _AsuraStream(datum_id, params.level_for(_upper_bound(lengths)), params)
    while True:
        k, frac32 = stream.next()
        if k < n_segs and frac32 < int(len32[k]):
            return k


def place_replicas_scalar(
    datum_id: int,
    seg_lengths: Sequence[float],
    seg_to_node: Sequence[int],
    n_replicas: int,
    params: AsuraParams = DEFAULT_PARAMS,
) -> list[int]:
    """First ``n_replicas`` hits on distinct *nodes* (section 5.A).

    Returns the list of segment numbers, primary first.
    """
    lengths = np.asarray(seg_lengths, dtype=np.float64)
    len32 = lengths_to_u32(lengths)
    node_of = np.asarray(seg_to_node)
    n_segs = len(len32)
    stream = _AsuraStream(datum_id, params.level_for(_upper_bound(lengths)), params)
    segs: list[int] = []
    nodes_seen: set[int] = set()
    guard = 0
    while len(segs) < n_replicas:
        guard += 1
        if guard > 1_000_000:
            raise RuntimeError("replication needs more distinct nodes than exist")
        k, frac32 = stream.next()
        if k >= n_segs or frac32 >= int(len32[k]):
            continue
        node = int(node_of[k])
        if node in nodes_seen:
            continue
        nodes_seen.add(node)
        segs.append(k)
    return segs


# ---------------------------------------------------------------------------
# Section 2.D metadata: ADDITION NUMBER and REMOVE NUMBERS
# ---------------------------------------------------------------------------


def placement_trace(
    datum_id: int,
    seg_lengths: Sequence[float],
    seg_to_node: Sequence[int],
    n_replicas: int = 1,
    params: AsuraParams = DEFAULT_PARAMS,
    extra_levels: int = 0,
) -> tuple[list[int], list[float], list[bool]]:
    """Replica segments plus the full anterior ASURA-number trace.

    Returns (replica_segments, numbers, used) where ``numbers`` is every
    ASURA random number generated up to and including the finally selected
    one (at top level = level_for(n) + extra_levels, i.e. optionally with the
    range extended for the ADDITION-NUMBER search) and ``used[i]`` marks the
    numbers that selected a replica.
    """
    lengths = np.asarray(seg_lengths, dtype=np.float64)
    len32 = lengths_to_u32(lengths)
    node_of = np.asarray(seg_to_node)
    n_segs = len(len32)
    top = params.level_for(_upper_bound(lengths)) + extra_levels
    stream = _AsuraStream(datum_id, top, params)
    numbers: list[float] = []
    used: list[bool] = []
    segs: list[int] = []
    nodes_seen: set[int] = set()
    guard = 0
    while len(segs) < n_replicas:
        guard += 1
        if guard > 1_000_000:
            raise RuntimeError("trace did not converge")
        k, frac32 = stream.next()
        numbers.append(k + frac32 / _2_32)
        hit = k < n_segs and frac32 < int(len32[k]) and int(node_of[k]) not in nodes_seen
        used.append(bool(hit))
        if hit:
            nodes_seen.add(int(node_of[k]))
            segs.append(k)
    return segs, numbers, used


def addition_number(
    datum_id: int,
    seg_lengths: Sequence[float],
    seg_to_node: Sequence[int],
    n_replicas: int = 1,
    params: AsuraParams = DEFAULT_PARAMS,
) -> int:
    """Section 2.D ADDITION NUMBER.

    floor of the smallest ASURA number anterior to the finally selected one
    that did not select a replica.  If every anterior number was used, the
    range is extended (extra levels) until an unused anterior number exists;
    extension only inserts numbers, never reorders existing ones, so the
    trace stays consistent (section 2.B).

    The extended range ends at 2**32 (a u32 draw has no more bits).  A
    datum whose every level up to there descends -- about one id in 2**20
    on a 4096-node table (top level 12) -- has no ADDITION NUMBER in range:
    -1 is returned, "unknown", which every prefilter treats as a candidate
    (the reference raises ``ValueError`` from a negative shift there).
    """
    top = params.level_for(_upper_bound(np.asarray(seg_lengths, dtype=np.float64)))
    for extra in range(32 - params.s_log2 - top + 1):
        _, numbers, used = placement_trace(
            datum_id, seg_lengths, seg_to_node, n_replicas, params, extra_levels=extra
        )
        unused = [v for v, u in zip(numbers[:-1], used[:-1]) if not u]
        if unused:
            return int(min(unused))
    return -1


def remove_numbers(
    datum_id: int,
    seg_lengths: Sequence[float],
    seg_to_node: Sequence[int],
    n_replicas: int = 1,
    params: AsuraParams = DEFAULT_PARAMS,
) -> list[int]:
    """Section 2.D REMOVE NUMBERS: floors of the replica-selecting numbers."""
    _, numbers, used = placement_trace(
        datum_id, seg_lengths, seg_to_node, n_replicas, params
    )
    return sorted(int(v) for v, u in zip(numbers, used) if u)

def _lvl_term(level: int) -> np.uint32:
    # computed in python ints: scalar uint32 multiplies warn on overflow
    return np.uint32((GOLDEN * (level + 1)) & 0xFFFFFFFF)


def _next_asura_batch(
    ids: np.ndarray,
    counters: np.ndarray,
    top_level: int,
    params: AsuraParams,
) -> tuple[np.ndarray, np.ndarray]:
    """One ASURA number per lane as (k, frac32); advances per-level counters.

    counters: (top_level + 1, batch) uint32, mutated in place; row l holds
    the level-l counters (contiguous, so per-level reads/ticks are cheap).

    Lazy-depth ladder (DESIGN.md section 3.4): the descend test is a coin
    flip per level, so the expected consulted depth is < 2 regardless of
    ``top_level``.  The top level is consulted by EVERY lane on every draw
    and is evaluated on the full batch with no index arrays; each deeper
    level hashes only the (geometrically shrinking) subset of lanes still
    consulting, and the loop exits as soon as no lane is.  Per-draw hash
    work is therefore O(expected depth) ~ 2 level-batches, not
    O(top_level).  Counters tick exactly one per consulted level per lane
    -- bit-identical to the unrolled ladder and to the scalar oracle
    (tested lane-by-lane).
    """
    s = params.s_log2
    kmult = np.uint32(KMULT)
    # -- top level: full batch, no indexing --------------------------------
    h = fmix32_np(fmix32_np(ids + _lvl_term(top_level)) ^ (counters[top_level] * kmult))
    counters[top_level] += np.uint32(1)
    # Emit values computed for ALL lanes; descending lanes get theirs
    # overwritten by the store at their (unique) emitting level below.
    out_k = (h >> np.uint32(32 - s - top_level)).astype(np.int64)
    out_frac = (h << np.uint32(s + top_level)).astype(np.uint32)
    if top_level == 0:
        return out_k, out_frac
    descend = h < np.uint32(2**31)
    active = np.nonzero(descend)[0]  # absolute lane index of each live row
    sub_ids = ids[descend]
    # -- deeper levels: compacted subsets ----------------------------------
    for level in range(top_level - 1, -1, -1):
        if active.size == 0:
            break
        ctr = counters[level]
        h = fmix32_np(fmix32_np(sub_ids + _lvl_term(level)) ^ (ctr[active] * kmult))
        ctr[active] += np.uint32(1)
        if level > 0:
            descend = h < np.uint32(2**31)
            emit = ~descend
        else:
            descend = np.zeros(h.shape, dtype=bool)
            emit = np.ones(h.shape, dtype=bool)
        em = active[emit]
        he = h[emit]
        out_k[em] = (he >> np.uint32(32 - s - level)).astype(np.int64)
        out_frac[em] = (he << np.uint32(s + level)).astype(np.uint32)
        active = active[descend]
        sub_ids = sub_ids[descend]
    return out_k, out_frac


def place_batch_u32(
    datum_ids: np.ndarray,
    len32: np.ndarray,
    top_level: int,
    params: AsuraParams = DEFAULT_PARAMS,
) -> np.ndarray:
    """Bounded-loop STEP 2 on a prebuilt u32 table; -1 marks non-converged.

    The table-artifact entry point: ``PlacementEngine`` calls this with its
    cached canonical table so repeated placements never re-derive ``len32``
    or the top level.  Callers resolve the -1 tail via ``resolve_tail_np``.

    Placed lanes are compacted out between draws (lanes are independent, so
    dropping a finished row changes nothing for the others): with expected
    ~4 draws per lane the draw loop touches roughly ``4 * batch`` lanes
    total instead of ``max_draws * batch``.
    """
    ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
    len32 = np.asarray(len32, dtype=np.uint32)
    n_segs = len(len32)
    batch = ids.shape[0]
    result = np.full(batch, -1, dtype=np.int64)
    alive = np.arange(batch)  # original lane index of each live row
    live_ids = ids
    counters = np.zeros((top_level + 1, batch), dtype=np.uint32)
    for _ in range(params.max_draws):
        if alive.size == 0:
            break
        k, frac = _next_asura_batch(live_ids, counters, top_level, params)
        k_safe = np.minimum(k, n_segs - 1)
        hit = (k < n_segs) & (frac < len32[k_safe])
        result[alive[hit]] = k[hit]
        keep = ~hit
        alive = alive[keep]
        live_ids = live_ids[keep]
        counters = counters[:, keep]
    return result


def place_replicas_u32(
    datum_ids: np.ndarray,
    len32: np.ndarray,
    node_of: np.ndarray,
    n_replicas: int,
    top_level: int,
    params: AsuraParams = DEFAULT_PARAMS,
) -> np.ndarray:
    """Replica placement on a prebuilt u32 table -> (batch, R) segments."""
    ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
    len32 = np.asarray(len32, dtype=np.uint32)
    node_of = np.asarray(node_of)
    n_segs = len(len32)
    batch = ids.shape[0]
    counters = np.zeros((top_level + 1, batch), dtype=np.uint32)
    result = np.full((batch, n_replicas), -1, dtype=np.int64)
    found = np.zeros(batch, dtype=np.int64)
    for _ in range(params.max_draws * max(1, n_replicas)):
        k, frac = _next_asura_batch(ids, counters, top_level, params)
        k_safe = np.minimum(k, n_segs - 1)
        hit = (k < n_segs) & (frac < len32[k_safe]) & (found < n_replicas)
        node_k = node_of[k_safe]
        dup = np.zeros(batch, dtype=bool)
        for r in range(n_replicas):
            prev = result[:, r]
            dup |= (prev >= 0) & (node_of[np.maximum(prev, 0)] == node_k)
        hit &= ~dup
        rows = np.nonzero(hit)[0]
        result[rows, found[rows]] = k[rows]
        found[rows] += 1
        if (found >= n_replicas).all():
            break
    if not (found >= n_replicas).all():
        raise RuntimeError("replication did not converge; too few distinct nodes?")
    return result


def place_batch(
    datum_ids: np.ndarray,
    seg_lengths: Sequence[float],
    params: AsuraParams = DEFAULT_PARAMS,
) -> np.ndarray:
    """Vectorized STEP 2 for a batch of datum ids -> segment numbers.

    Bit-identical to ``place_scalar`` lane-by-lane (tested).  Lanes that fail
    to hit within ``params.max_draws`` draws (probability < 2**-53 per lane
    for hole fractions <= 1/2) fall back to the exact-integer uniform draw
    over the occupied mass (``resolve_tail_np``) -- total and uniform but
    outside the movement-optimality guarantee; see DESIGN.md section 3.2.
    """
    ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
    lengths = np.asarray(seg_lengths, dtype=np.float64)
    len32 = lengths_to_u32(lengths)
    top = params.level_for(_upper_bound(lengths))
    result = place_batch_u32(ids, len32, top, params)
    return resolve_tail_np(ids, result, len32, top)


def place_nodes_batch(
    datum_ids: np.ndarray,
    seg_lengths: Sequence[float],
    seg_to_node: Sequence[int],
    params: AsuraParams = DEFAULT_PARAMS,
) -> np.ndarray:
    """Batch placement straight to node ids."""
    segs = place_batch(datum_ids, seg_lengths, params)
    return np.asarray(seg_to_node)[segs]


def place_replicas_batch(
    datum_ids: np.ndarray,
    seg_lengths: Sequence[float],
    seg_to_node: Sequence[int],
    n_replicas: int,
    params: AsuraParams = DEFAULT_PARAMS,
) -> np.ndarray:
    """(batch, n_replicas) segment numbers; first column is the primary.

    Vectorized analogue of ``place_replicas_scalar`` (bit-identical; tested).
    """
    lengths = np.asarray(seg_lengths, dtype=np.float64)
    len32 = lengths_to_u32(lengths)
    top = params.level_for(_upper_bound(lengths))
    return place_replicas_u32(
        datum_ids, len32, np.asarray(seg_to_node), n_replicas, top, params
    )


def addition_numbers_batch(
    datum_ids: np.ndarray,
    seg_lengths: Sequence[float],
    seg_to_node: Sequence[int],
    n_replicas: int = 1,
    params: AsuraParams = DEFAULT_PARAMS,
) -> np.ndarray:
    """Vectorized section 2.D ADDITION NUMBER for a batch of datum ids.

    Runs the replica trace for every lane at once, tracking the minimum
    *unused* anterior ASURA number as an exact (k << 32 | frac32) uint64 key
    (value ordering is identical to the float ordering of the scalar trace,
    without float64 round-off).  Lanes whose trace needs the rare
    range-extension path (every anterior number used) or does not converge in
    the bounded loop fall back to the exact scalar ``addition_number``.
    Matches ``addition_number`` lane-by-lane (tested), -1 included.
    """
    ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
    lengths = np.asarray(seg_lengths, dtype=np.float64)
    len32 = lengths_to_u32(lengths)
    node_of = np.asarray(seg_to_node)
    n_segs = len(len32)
    top = params.level_for(_upper_bound(lengths))
    batch = ids.shape[0]
    counters = np.zeros((top + 1, batch), dtype=np.uint32)
    found = np.zeros(batch, dtype=np.int64)
    picked_nodes = np.full((batch, n_replicas), -1, dtype=np.int64)
    no_min = np.uint64(0xFFFFFFFFFFFFFFFF)
    min_unused = np.full(batch, no_min, dtype=np.uint64)
    for _ in range(params.max_draws * max(1, n_replicas)):
        active = found < n_replicas
        if not active.any():
            break
        k, frac = _next_asura_batch(ids, counters, top, params)
        k_safe = np.minimum(k, n_segs - 1)
        hit = (k < n_segs) & (frac < len32[k_safe])
        node_k = node_of[k_safe]
        dup = np.any((picked_nodes >= 0) & (picked_nodes == node_k[:, None]), axis=1)
        used = active & hit & ~dup
        key = (k.astype(np.uint64) << np.uint64(32)) | frac.astype(np.uint64)
        unused = active & ~used
        min_unused = np.where(unused, np.minimum(min_unused, key), min_unused)
        rows = np.nonzero(used)[0]
        picked_nodes[rows, found[rows]] = node_k[rows]
        found[rows] += 1
    an = (min_unused >> np.uint64(32)).astype(np.int64)
    extend = (found >= n_replicas) & (min_unused == no_min)
    if extend.any():
        an[extend] = _extended_addition_numbers(ids[extend], n_replicas, top, params)
    for i in np.nonzero(found < n_replicas)[0]:
        an[i] = addition_number(int(ids[i]), lengths, node_of, n_replicas, params)
    return an


def _extended_addition_numbers(
    ids: np.ndarray, n_replicas: int, top: int, params: AsuraParams
) -> np.ndarray:
    """ADDITION NUMBERs of lanes whose first ``n_replicas`` numbers at
    ``top`` all selected a replica (no unused anterior number), through
    the range extension of ``addition_number`` in closed form.

    With the range extended to level L > top, every number starts at L
    and the numbers of the trace at L - 1 are exactly its descents, in
    order.  Numbers emitted at a level above ``top`` lie past every
    segment (unused), and an emission at a lower level is smaller than
    any at a higher one.  So if the trace at L - 1 still had no unused
    anterior number, the unused anterior numbers at L are the level-L
    draws that emit before the ``n_replicas``-th descent, and the
    ADDITION NUMBER is the smallest of their floors; with none, the next
    level is tried, up to 2**32 (then -1, as ``addition_number``).
    Equal to ``addition_number`` lane by lane (tested)."""
    s = params.s_log2
    an = np.full(ids.shape[0], -1, dtype=np.int64)
    rows = np.arange(ids.shape[0])
    for level in range(top + 1, 33 - s):
        if rows.size == 0:
            break
        sub = ids[rows]
        best = np.full(rows.size, np.iinfo(np.int64).max, dtype=np.int64)
        descents = np.zeros(rows.size, dtype=np.int64)
        live = np.arange(rows.size)
        counter = 0
        while live.size:
            h = draw_u32_np(sub[live], np.uint32(level), np.uint32(counter))
            emit = h >= np.uint32(2**31)
            k = (h.astype(np.int64) >> (32 - s - level))
            best[live[emit]] = np.minimum(best[live[emit]], k[emit])
            descents[live[~emit]] += 1
            live = live[descents[live] < n_replicas]
            counter += 1
        found = best != np.iinfo(np.int64).max
        an[rows[found]] = best[found]
        rows = rows[~found]
    return an


def remove_numbers_batch(
    datum_ids: np.ndarray,
    seg_lengths: Sequence[float],
    seg_to_node: Sequence[int],
    n_replicas: int = 1,
    params: AsuraParams = DEFAULT_PARAMS,
) -> np.ndarray:
    """Vectorized section 2.D REMOVE NUMBERS -> (batch, R) sorted segments.

    A datum's remove numbers are the floors of its replica-SELECTING ASURA
    numbers, and the floor of a selecting number IS the selected segment --
    so the batch is one vectorized replica placement plus a row sort,
    replacing the per-id scalar trace (``remove_numbers``).  Row-identical
    to the scalar (tested).
    """
    segs = place_replicas_batch(
        datum_ids, seg_lengths, seg_to_node, n_replicas, params
    )
    return np.sort(segs, axis=1)


def align_replica_sets(
    before: np.ndarray, after: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-slot minimal alignment of two replica-node sets (the host spec).

    ``before`` / ``after`` are (batch, R) replica-node sets (each row
    pairwise-distinct, primary first) of the same ids under versions v and
    v+1.  Slots index the AFTER set.  Returns ``(moved, src, src_slot)``:

      * ``moved[b, r]``    -- slot r's owner actually changed, i.e.
        ``after[b, r]`` is not a member of ``before[b, :]`` (so exactly
        ``|after \\ before|`` slots move -- the section-5 minimal replica
        mass; common nodes that merely changed position move nothing),
      * ``src[b, r]``      -- where slot r's bytes live under v: for a moved
        slot the rank-matched VACATED node (the k-th new after-slot pairs
        with the k-th lost before-slot, both in slot order -- the set
        differences have equal size, so the match is total), else
        ``after[b, r]`` itself (it holds the datum throughout),
      * ``src_slot[b, r]`` -- the BEFORE-set position of ``src`` for moved
        slots (rollback re-indexes the reverse plan with it), else r.

    Pure exact integer ops, formulated identically to the jitted device
    twin (``kernels.ops.align_replica_sets``) so the two are bit-identical.
    """
    before = np.asarray(before)
    after = np.asarray(after)
    n_replicas = after.shape[1]
    new = ~(after[:, :, None] == before[:, None, :]).any(axis=2)
    lost = ~(before[:, :, None] == after[:, None, :]).any(axis=2)
    new_i = new.astype(np.int64)
    lost_i = lost.astype(np.int64)
    rank_new = np.cumsum(new_i, axis=1) - new_i
    rank_lost = np.cumsum(lost_i, axis=1) - lost_i
    match = lost[:, None, :] & (rank_lost[:, None, :] == rank_new[:, :, None])
    picked_src = np.where(match, before[:, None, :], 0).sum(axis=2)
    slots = np.arange(n_replicas, dtype=np.int64)
    picked_slot = np.where(match, slots[None, None, :], 0).sum(axis=2)
    src = np.where(new, picked_src, after)
    src_slot = np.where(new, picked_slot, slots[None, :])
    return new, src, src_slot
