"""Plain-torch twins of the two-level (failure-domain-aware) kernel B8.

``hier_place_replicas_ref`` computes exactly what ``csrc/hierarchy.cu``
computes, in plain tensor code on any device: the section-5.A replica
draw over the DOMAIN table (``ref.place_replicas_ref`` with the dense
domain slots as the node map), then one salted total placement per filled
slot in that domain's row of the stacked tables.  The wrapper in
``hierarchy.py`` takes it for CPU tensors; on the card it is the yardstick
kernel B8 is held to, and on the CPU the tests hold it to the reference's
jnp twin, its Pallas kernel (interpret mode) and the NumPy oracle.

Level 2 keeps the reference's lockstep "vartop" ladder: the scalar level
descends from ``max_top`` (the largest per-domain top level) and a lane
consults once the level has reached ITS domain's top.  Counters are
indexed by level directly (row L = level L), so lanes of different tops
share one ``(max_top + 1, batch)`` array.  As in ``ref.py``, u32 values
travel in int64 under the rule of ``u32.py``, placed lanes drop out of
the draw loop, and each level hashes only the lanes consulting it --
per lane the result is unchanged.
"""

from __future__ import annotations

import torch

from ..core.rng import GOLDEN
from .ref import draw_u32, fmix32, place_replicas_ref
from .u32 import M32, add32, as_u32, mul32, mulhi32, shl32


def next_asura_vartop(
    ids: torch.Tensor,
    counters: torch.Tensor,
    lane_top: torch.Tensor,
    max_top: int,
    s_log2: int,
):
    """One ASURA number per lane with a PER-LANE top level -> ``(k,
    frac32, counters)``.

    ``counters``: (max_top + 1, batch) int64, row L the counter of level
    L, updated IN PLACE (one tick per consulted level).  ``lane_top``:
    int64 per-lane start level, <= ``max_top``.  The level descends from
    ``max_top``; a lane consults from its own top down until its draw's
    MSB is set (or level 0), and emits there."""
    n = ids.shape[0]
    k = torch.zeros(n, dtype=torch.int64, device=ids.device)
    f = torch.zeros(n, dtype=torch.int64, device=ids.device)
    emitted = torch.zeros(n, dtype=torch.bool, device=ids.device)
    for level in range(max_top, -1, -1):
        lanes = torch.nonzero(~emitted & (lane_top >= level)).flatten()
        if lanes.numel() == 0:
            continue
        ctr = counters[level, lanes]
        h = draw_u32(ids[lanes], level, ctr)
        counters[level, lanes] = add32(ctr, 1)
        emit = lanes if level == 0 else lanes[h >= 0x80000000]
        he = h if level == 0 else h[h >= 0x80000000]
        k[emit] = he >> (32 - s_log2 - level)
        f[emit] = shl32(he, s_log2 + level)
        emitted[emit] = True
    return k, f, counters


def resolve_tail_vartop(
    ids: torch.Tensor,
    segs: torch.Tensor,
    cum_hi: torch.Tensor,
    cum_lo: torch.Tensor,
    lane_top: torch.Tensor,
    dom_slot: torch.Tensor,
    s_pad: int,
) -> torch.Tensor:
    """Per-lane section 3.2 tail against STACKED per-domain cumsum rows.

    Lanes with ``segs < 0`` take one raw draw at ``lane_top + 1`` (counter
    0), scaled by their domain's total mass (the last entry of its row:
    each row's u64 cumsum is carried at the domain total through the
    padding), and land on the first segment of the row whose inclusive
    cumsum exceeds it -- the reference's branchless search, equal to
    ``resolve_tail_np`` on the domain's unpadded table."""
    miss = torch.nonzero(segs < 0).flatten()
    if miss.numel() == 0:
        return segs
    cum = (as_u32(cum_hi) << 32) | as_u32(cum_lo)
    ids_m = as_u32(ids)[miss]
    base = dom_slot[miss] * s_pad
    h = draw_u32(ids_m, lane_top[miss] + 1, torch.zeros_like(ids_m))
    total = cum[base + (s_pad - 1)]
    u = h * (total >> 32) + mulhi32(h, total & M32)
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, s_pad)
    for _ in range(max(1, int(s_pad).bit_length())):
        active = lo < hi
        mid = ((lo + hi) >> 1).clamp(max=s_pad - 1)
        le = cum[base + mid] <= u
        lo = torch.where(active & le, mid + 1, lo)
        hi = torch.where(active & ~le, mid, hi)
    out = segs.clone()
    out[miss] = lo.to(segs.dtype)
    return out


def place_vartop(
    ids: torch.Tensor,
    len32_flat: torch.Tensor,
    cum_hi: torch.Tensor,
    cum_lo: torch.Tensor,
    lane_top: torch.Tensor,
    dom_slot: torch.Tensor,
    *,
    max_top: int,
    s_log2: int,
    s_pad: int,
    max_draws: int,
) -> torch.Tensor:
    """Total single placement of every lane in ITS OWN domain's row of the
    stacked tables -> int64 per-domain segment indices.

    The ``ref.place_ref`` loop on the vartop ladder: padded (zero-length)
    slots never hit, so the misses are exactly the per-domain oracle's;
    the tail then resolves per lane."""
    ids = as_u32(ids)
    len32_flat = as_u32(len32_flat)
    n = ids.shape[0]
    dev = ids.device
    base = dom_slot * s_pad
    result = torch.full((n,), -1, dtype=torch.int64, device=dev)
    alive = torch.arange(n, device=dev)
    counters = torch.zeros((max_top + 1, n), dtype=torch.int64, device=dev)
    live_ids, live_top, live_base = ids, lane_top, base
    for _ in range(max_draws):
        if alive.numel() == 0:
            break
        k, f, counters = next_asura_vartop(live_ids, counters, live_top, max_top, s_log2)
        lens = len32_flat[live_base + k.clamp(max=s_pad - 1)]
        hit = (k < s_pad) & (f < lens)
        result[alive[hit]] = k[hit]
        keep = ~hit
        alive, counters = alive[keep], counters[:, keep]
        live_ids, live_top, live_base = live_ids[keep], live_top[keep], live_base[keep]
    return resolve_tail_vartop(ids, result, cum_hi, cum_lo, lane_top, dom_slot, s_pad)


def hier_place_replicas_ref(
    ids: torch.Tensor,
    top_len32: torch.Tensor,
    top_slot_of: torch.Tensor,
    dom_len32: torch.Tensor,
    dom_node: torch.Tensor,
    dom_cum_hi: torch.Tensor,
    dom_cum_lo: torch.Tensor,
    dom_top: torch.Tensor,
    dom_ids: torch.Tensor,
    *,
    top_level: int,
    max_top: int,
    s_log2: int,
    max_draws: int,
    s_pad: int,
    n_replicas: int,
) -> torch.Tensor:
    """Twin of the two-level kernel -> (2, R, batch) int32.

    Plane 0 holds domain ids, plane 1 node ids; -1 marks the slots whose
    level-1 distinct-domain draw did not converge."""
    ids = as_u32(ids)
    n, R = ids.shape[0], n_replicas
    slots = place_replicas_ref(
        ids, top_len32, top_slot_of, top_level=top_level, s_log2=s_log2,
        max_draws=max_draws, n_replicas=R, emit_nodes=True,
    ).to(torch.int64)  # (batch, R) domain slots
    dom_top = dom_top.to(torch.int64)
    dom_ids = dom_ids.to(torch.int64)
    dom_node = dom_node.to(torch.int64)
    out = torch.full((2, R, n), -1, dtype=torch.int64, device=ids.device)
    for r in range(R):
        lanes = torch.nonzero(slots[:, r] >= 0).flatten()
        slot = slots[lanes, r]
        did = dom_ids[slot]
        salted = fmix32(ids[lanes] ^ mul32(did & M32, GOLDEN))
        seg = place_vartop(
            salted, dom_len32, dom_cum_hi, dom_cum_lo, dom_top[slot], slot,
            max_top=max_top, s_log2=s_log2, s_pad=s_pad, max_draws=max_draws,
        )
        out[0, r, lanes] = did
        out[1, r, lanes] = dom_node[slot * s_pad + seg]
    return out.to(torch.int32)
