"""Plain-torch twins of the ASURA placement kernels.

Each function here computes exactly what a CUDA kernel of
``kernels/csrc/asura_place.cu`` computes, in plain tensor code that runs
on any device.  The wrappers in ``asura_place.py`` take these twins for
CPU tensors; on the card they are the yardstick every kernel is held to
(``chip_smoke.py``), and on the CPU they are what the tests hold to the
reference's jnp refs, Pallas kernels (interpret mode) and NumPy oracles,
bit for bit.

u32 values travel in ``int64`` under the rule of ``u32.py``.  Outputs
keep the kernels' types: segment / node ids ``int32`` (-1 = none), the
stats vector ``uint32``.

The twins keep the lockstep semantics of the reference (one draw per live
lane per loop trip, counters in the reference's layout: row ``r`` of the
``(top_level + 1, batch)`` counter array is level ``top_level - r``), but
drop lanes once they are placed and hash each ladder level only for the
lanes still consulting it -- lanes never read each other's state, so the
per-lane results are unchanged.  The reference's straggler compaction
(a TPU lockstep schedule) has no counterpart.
"""

from __future__ import annotations

import torch

from ..core.rng import GOLDEN, KMULT
from .u32 import M32, add32, as_u32, mul32, mulhi32, shl32, to_u32

# Ladder-depth histogram width: a draw's depth is ``top_level -
# exit_level + 1`` in [1, top_level + 1] and top_level <= 31 - s_log2, so
# 34 bins cover every reachable depth (the reference's constant).
DEPTH_BINS = 34


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 finalizer on u32 values carried in int64."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def draw_u32(ids: torch.Tensor, level, counters) -> torch.Tensor:
    """k-th raw draw of the level-``level`` generator (counter-based).

    ``level`` is a Python int or an int64 tensor broadcasting over ids."""
    if isinstance(level, torch.Tensor):
        lvl_term = mul32((level + 1) & M32, GOLDEN)
    else:
        lvl_term = (GOLDEN * (level + 1)) & M32
    seed = fmix32(add32(ids, lvl_term))
    return fmix32(seed ^ mul32(counters, KMULT))


def next_asura(
    ids: torch.Tensor,
    counters: torch.Tensor,
    top_level: int,
    s_log2: int,
    emit_depth: bool = False,
    active: torch.Tensor | None = None,
):
    """One ASURA number per lane -> ``(k, frac32, counters[, depth])``.

    ``counters`` is ``(top_level + 1, batch)`` int64, row ``r`` = level
    ``top_level - r``; it is updated IN PLACE (one tick per consulted
    level) and returned.  Every lane hashes the top level; each deeper
    level hashes only the lanes still descending (MSB clear), so the work
    per draw is the expected ~2 consulted levels, not ``top_level + 1``.

    ``emit_depth`` also returns the consulted depth ``top_level -
    exit_level + 1`` per lane.  ``active`` (bool per lane) gates the
    counter TICK only: inactive lanes still draw, and their outputs are
    garbage the caller ignores -- the replica loop freezes satisfied
    lanes with it so the depth histogram counts only seeking draws.
    """
    depth = torch.ones_like(ids) if emit_depth else None
    lanes = None  # None: every lane; else the indices still consulting
    for level in range(top_level, -1, -1):
        row = top_level - level
        sub_ids = ids if lanes is None else ids[lanes]
        ctr = counters[row] if lanes is None else counters[row, lanes]
        h = draw_u32(sub_ids, level, ctr)
        tick = torch.ones_like(ctr) if active is None else (
            active if lanes is None else active[lanes]
        ).to(torch.int64)
        if lanes is None:
            counters[row] = add32(ctr, tick)
        else:
            counters[row, lanes] = add32(ctr, tick)
        # every visited lane takes this level's value; lanes that descend
        # are overwritten at their (deeper) emitting level
        kk = h >> (32 - s_log2 - level)
        ff = shl32(h, s_log2 + level)
        if lanes is None:
            k, f = kk, ff
        else:
            k[lanes] = kk
            f[lanes] = ff
            if emit_depth:
                depth[lanes] = row + 1
        if level == 0:
            break
        descend = h < 0x80000000
        lanes = (
            torch.nonzero(descend).flatten()
            if lanes is None
            else lanes[descend]
        )
        if lanes.numel() == 0:
            break
    if emit_depth:
        return k, f, counters, depth
    return k, f, counters


def resolve_tail_dev(
    ids: torch.Tensor,
    segs: torch.Tensor,
    cum_hi: torch.Tensor,
    cum_lo: torch.Tensor,
    top_level: int,
) -> torch.Tensor:
    """The non-converged-tail fallback (DESIGN.md section 3.2) in torch.

    Lanes with ``segs < 0`` get one raw draw ``h`` at level ``top_level +
    1`` (counter 0), scaled by the exact total mass ``T`` as
    ``u = h * (T >> 32) + ((h * (T & 0xFFFFFFFF)) >> 32)``, and land on the
    first segment whose inclusive u64 cumsum exceeds ``u``
    (``searchsorted(side="right")``).  ``T < 2**63`` and ``u < T``, so
    native int64 carries the whole computation; ``mulhi32`` keeps the
    second product from overflowing.  Equal to ``resolve_tail_np``.
    """
    ids = as_u32(ids)
    hi = as_u32(cum_hi)
    lo = as_u32(cum_lo)
    cum = (hi << 32) | lo
    total = cum[-1]
    h = draw_u32(ids, top_level + 1, torch.zeros_like(ids))
    u = h * (total >> 32) + mulhi32(h, total & M32)
    tail = torch.searchsorted(cum, u, right=True)
    return torch.where(segs < 0, tail.to(segs.dtype), segs)


def place_ref(
    ids: torch.Tensor,
    len32: torch.Tensor,
    *,
    top_level: int,
    s_log2: int = 1,
    max_draws: int = 128,
) -> torch.Tensor:
    """Bounded STEP 2 -> int32 segment numbers (-1 if not converged)."""
    ids = as_u32(ids)
    len32 = as_u32(len32)
    n_segs = len32.shape[0]
    n = ids.shape[0]
    dev = ids.device
    result = torch.full((n,), -1, dtype=torch.int64, device=dev)
    alive = torch.arange(n, device=dev)
    live_ids = ids
    counters = torch.zeros((top_level + 1, n), dtype=torch.int64, device=dev)
    for _ in range(max_draws):
        if alive.numel() == 0:
            break
        k, f, counters = next_asura(live_ids, counters, top_level, s_log2)
        hit = (k < n_segs) & (f < len32[k.clamp(max=n_segs - 1)])
        result[alive[hit]] = k[hit]
        keep = ~hit
        alive, live_ids, counters = alive[keep], live_ids[keep], counters[:, keep]
    return result.to(torch.int32)


def place_replicas_ref(
    ids: torch.Tensor,
    len32: torch.Tensor,
    node_of: torch.Tensor,
    *,
    top_level: int,
    s_log2: int = 1,
    max_draws: int = 128,
    n_replicas: int = 1,
    emit_stats: bool = False,
    emit_nodes: bool = False,
    emit_levels: bool = False,
):
    """Section 5.A replication -> (batch, R) int32, primary first.

    Each lane draws until it holds R hits on pairwise-distinct nodes or
    has made ``max_draws * max(1, R)`` draws; -1 marks the slots it did
    not fill.  ``emit_nodes`` returns the picked nodes instead of their
    segments.  ``emit_stats`` also returns the (DEPTH_BINS,) int64
    consulted-depth histogram over every draw a lane made while still
    seeking, derived -- as the reference does -- from the first
    difference of the per-row counter sums (mod 2**32).  ``emit_levels``
    also returns (last) the int64 count of distinct ladder levels each
    lane consulted, summed over lanes: the level seeds a lane that keeps
    them hashes.
    """
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    ids = as_u32(ids)
    len32 = as_u32(len32)
    node_of = node_of.to(torch.int64)
    n_segs = len32.shape[0]
    n, R = ids.shape[0], n_replicas
    dev = ids.device
    out = torch.full((n, R), -1, dtype=torch.int64, device=dev)
    alive = torch.arange(n, device=dev)
    live_ids = ids
    counters = torch.zeros((top_level + 1, n), dtype=torch.int64, device=dev)
    segs = torch.full((n, R), -1, dtype=torch.int64, device=dev)
    nodes = torch.full((n, R), -1, dtype=torch.int64, device=dev)
    found = torch.zeros(n, dtype=torch.int64, device=dev)
    cnt = torch.zeros(top_level + 1, dtype=torch.int64, device=dev)
    levels = torch.zeros((), dtype=torch.int64, device=dev)

    def retire(mask):
        nonlocal cnt, levels
        out[alive[mask]] = (nodes if emit_nodes else segs)[mask]
        cnt = cnt + counters[:, mask].sum(dim=1)
        if emit_levels:
            levels = levels + (counters[:, mask] > 0).sum()

    for _ in range(max_draws * max(1, R)):
        if alive.numel() == 0:
            break
        k, f, counters = next_asura(live_ids, counters, top_level, s_log2)
        k_safe = k.clamp(max=n_segs - 1)
        hit = (k < n_segs) & (f < len32[k_safe])
        node_k = node_of[k_safe]
        dup = (nodes == node_k[:, None]).any(dim=1)
        rows = torch.nonzero(hit & ~dup).flatten()
        slot = found[rows]
        segs[rows, slot] = k[rows]
        nodes[rows, slot] = node_k[rows]
        found[rows] += 1
        done = found >= R
        retire(done)
        keep = ~done
        alive, live_ids, counters = alive[keep], live_ids[keep], counters[:, keep]
        segs, nodes, found = segs[keep], nodes[keep], found[keep]
    retire(torch.ones_like(found, dtype=torch.bool))  # non-converged lanes
    out = out.to(torch.int32)
    extra = []
    if emit_stats:
        # cnt[r] = draws of depth >= r + 1; hist[d] = cnt[d - 1] - cnt[d]
        cnt = torch.cat([cnt, cnt.new_zeros(1)]) & M32
        hist = torch.zeros(DEPTH_BINS, dtype=torch.int64, device=dev)
        hist[1 : top_level + 2] = (cnt[:-1] - cnt[1:]) & M32
        extra.append(hist)
    if emit_levels:
        extra.append(levels)
    return (out, *extra) if extra else out


def place_fused_ref(
    ids: torch.Tensor,
    len32: torch.Tensor,
    cum_hi: torch.Tensor,
    cum_lo: torch.Tensor,
    node_of: torch.Tensor,
    *,
    top_level: int,
    s_log2: int,
    max_draws: int,
    emit_nodes: bool,
) -> torch.Tensor:
    """Twin of the fused placement kernel: total, tail resolved, optional
    seg->node gather -> (batch,) int32."""
    segs = place_ref(
        ids, len32, top_level=top_level, s_log2=s_log2, max_draws=max_draws
    )
    segs = resolve_tail_dev(ids, segs, cum_hi, cum_lo, top_level)
    if emit_nodes:
        return node_of.to(torch.int32)[segs.to(torch.int64)]
    return segs


def place_replicas_fused_ref(
    ids: torch.Tensor,
    len32: torch.Tensor,
    node_of: torch.Tensor,
    *,
    top_level: int,
    s_log2: int,
    max_draws: int,
    n_replicas: int,
    emit_nodes: bool,
    emit_stats: bool,
):
    """Twin of the replica kernel -> (batch, R) int32 [, stats].

    ``stats`` is the (DEPTH_BINS + 1,) uint32 vector ``[depth_hist...,
    nonconverged]``; the last entry counts -1 SLOTS over (batch, R)."""
    out = place_replicas_ref(
        ids, len32, node_of, top_level=top_level, s_log2=s_log2,
        max_draws=max_draws, n_replicas=n_replicas, emit_stats=emit_stats,
        emit_nodes=emit_nodes,
    )
    if not emit_stats:
        return out
    out, hist = out
    nonconv = (out < 0).sum().reshape(1) & M32
    return out, to_u32(torch.cat([hist, nonconv]))


def diff_fused_ref(
    ids: torch.Tensor,
    len32_a: torch.Tensor,
    cum_hi_a: torch.Tensor,
    cum_lo_a: torch.Tensor,
    node_a: torch.Tensor,
    len32_b: torch.Tensor,
    cum_hi_b: torch.Tensor,
    cum_lo_b: torch.Tensor,
    node_b: torch.Tensor,
    *,
    top_a: int,
    top_b: int,
    s_log2: int,
    max_draws: int,
) -> torch.Tensor:
    """Twin of the node diff kernel: total placement with nodes out under
    table A (version v), then under table B (v+1) -> (2, batch) int32."""
    kw = dict(s_log2=s_log2, max_draws=max_draws, emit_nodes=True)
    src = place_fused_ref(ids, len32_a, cum_hi_a, cum_lo_a, node_a, top_level=top_a, **kw)
    dst = place_fused_ref(ids, len32_b, cum_hi_b, cum_lo_b, node_b, top_level=top_b, **kw)
    return torch.stack([src, dst])


def diff_replicas_fused_ref(
    ids: torch.Tensor,
    len32_a: torch.Tensor,
    node_a: torch.Tensor,
    len32_b: torch.Tensor,
    node_b: torch.Tensor,
    *,
    top_a: int,
    top_b: int,
    s_log2: int,
    max_draws: int,
    n_replicas: int,
) -> torch.Tensor:
    """Twin of the replica diff kernel: R-replica node sets under table A,
    then under table B -> (2, batch, R) int32, -1 for unfilled slots."""
    kw = dict(s_log2=s_log2, max_draws=max_draws, n_replicas=n_replicas,
              emit_nodes=True, emit_stats=False)
    before = place_replicas_fused_ref(ids, len32_a, node_a, top_level=top_a, **kw)
    after = place_replicas_fused_ref(ids, len32_b, node_b, top_level=top_b, **kw)
    return torch.stack([before, after])


def addition_numbers_ref(
    ids: torch.Tensor,
    len32: torch.Tensor,
    node_of: torch.Tensor,
    *,
    top_level: int,
    s_log2: int = 1,
    max_draws: int = 128,
    n_replicas: int = 1,
) -> torch.Tensor:
    """Section 2.D ADDITION NUMBER per lane -> (batch,) int32.

    Every lane runs the bounded replica trace, tracking the minimum
    *unused* anterior ASURA number as an exact ``(k << 32) | frac32`` key
    below the reference's sentinel ``(0x7FFFFFFF, 0)``.  Lanes that do not
    converge within ``max_draws * max(1, R)`` draws, or whose every
    anterior number was used, return -1 ("unknown: treat as a candidate",
    which keeps the planner's AN <= f prefilter sound); the others equal
    ``core.asura.addition_numbers_batch``.  The twin of the CUDA kernel
    ``asura_addition_numbers`` (the reference has no Pallas kernel for
    this trace); lanes are dropped once they hold R replicas (their state
    no longer changes), so it reads its count of live lanes every draw.
    """
    ids = as_u32(ids)
    len32 = as_u32(len32)
    node_of = node_of.to(torch.int64)
    n_segs = len32.shape[0]
    n, R = ids.shape[0], n_replicas
    dev = ids.device
    no_min = 0x7FFFFFFF << 32  # the reference's (NO_K, 0): k < 2**31 always
    result = torch.full((n,), -1, dtype=torch.int64, device=dev)
    alive = torch.arange(n, device=dev)
    live_ids = ids
    counters = torch.zeros((top_level + 1, n), dtype=torch.int64, device=dev)
    nodes = torch.full((n, R), -1, dtype=torch.int64, device=dev)
    found = torch.zeros(n, dtype=torch.int64, device=dev)
    min_key = torch.full((n,), no_min, dtype=torch.int64, device=dev)
    for _ in range(max_draws * max(1, R)):
        if alive.numel() == 0:
            break
        k, f, counters = next_asura(live_ids, counters, top_level, s_log2)
        k_safe = k.clamp(max=n_segs - 1)
        hit = (k < n_segs) & (f < len32[k_safe])
        node_k = node_of[k_safe]
        dup = (nodes == node_k[:, None]).any(dim=1)
        used = hit & ~dup
        min_key = torch.where(used, min_key, torch.minimum(min_key, (k << 32) | f))
        rows = torch.nonzero(used).flatten()
        nodes[rows, found[rows]] = node_k[rows]
        found[rows] += 1
        done = found >= R
        result[alive[done]] = torch.where(min_key[done] == no_min, -1, min_key[done] >> 32)
        keep = ~done
        alive, live_ids, counters = alive[keep], live_ids[keep], counters[:, keep]
        nodes, found, min_key = nodes[keep], found[keep], min_key[keep]
    return result.to(torch.int32)
