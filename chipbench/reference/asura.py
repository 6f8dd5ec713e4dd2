"""ASURA STEP 2 in plain torch: the benchmark's own reference placement.

Written from the paper's algorithm (Ishikawa 2013, sections 2.C and 5.A)
in its exact integer form, and independent of the program under test:

  * the k-th draw of the level-``l`` generator for datum ``id`` is
    ``fmix32(fmix32(id + GOLDEN * (l + 1)) ^ (k * KMULT))`` (MurmurHash3's
    32-bit finalizer), a pure function of (id, level, counter);
  * one ASURA number walks the ladder from the top level down: a draw
    with its most significant bit clear descends to the next level (each
    level keeps its own counter), otherwise, or at level 0, it is the
    number ``k + frac / 2**32`` with ``k = h >> (32 - s - l)`` and
    ``frac = (h << (s + l)) mod 2**32``;
  * it hits segment ``k`` when ``k < n_segs`` and ``frac < len32[k]``;
  * an R-replica set takes the first R hits on pairwise-distinct owners,
    within ``max_draws * R`` draws (-1 marks a slot left unfilled);
  * a total single placement draws ``max_draws`` numbers and then
    resolves a miss by one draw at level ``top + 1`` scaled onto the
    table's exact u32 mass.

u32 values travel in ``int64`` tensors and stay in [0, 2**32).  The
functions run on any device; on the card they judge the program at the
timed sizes.

``number="float32"`` is the control: the same algorithm with the ASURA
number formed and tested in float32, as the paper's pseudocode states it
with real numbers, the nearest precision below the exact u32 fixed point
that the configurations state.  Its answers differ from the exact ones on
a small share of the draws, and a comparison that cannot tell the two
apart is no comparison.

Every placement can also count the work its lanes need (``counts``): the
ladder levels consulted, the draws, the distinct levels a lane touched
(the seeds it must hash at least once) and the lanes that fell back to
the tail.  The benchmark's operation bounds are computed from these.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
KMULT = 0x85EBCA77
HIGH_BIT = 0x80000000
NUMBERS = ("exact", "float32")


def mul32(a: torch.Tensor, c) -> torch.Tensor:
    """(a * c) mod 2**32 for u32 values in int64, without overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mulhi32(a: torch.Tensor, c) -> torch.Tensor:
    """floor(a * c / 2**32) for u32 values in int64, exactly."""
    return (a * (c >> 16) + ((a * (c & 0xFFFF)) >> 16)) >> 16


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def draw(ids: torch.Tensor, level, counters: torch.Tensor) -> torch.Tensor:
    """The ``counters``-th raw draw of the level-``level`` generator.

    ``level`` is an int or an int64 tensor that broadcasts over ``ids``."""
    if isinstance(level, torch.Tensor):
        term = mul32((level + 1) & M32, GOLDEN)
    else:
        term = (GOLDEN * (level + 1)) & M32
    return fmix32(fmix32((ids + term) & M32) ^ mul32(counters, KMULT))


def widen(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor (uint32 bit patterns included) -> int64 u32."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & M32


class Counts(dict):
    """Work a placement's lanes needed: ``consults``, ``draws``,
    ``distinct`` (levels a lane consulted at least once, summed over
    lanes) and ``tail`` (lanes resolved by the fallback)."""

    def __init__(self):
        super().__init__(consults=0, draws=0, distinct=0, tail=0)

    def add(self, other: dict) -> "Counts":
        for k in self:
            self[k] += int(other[k])
        return self


class Table:
    """One flat segment table on a device: ``len32`` (u32 in int64),
    ``owner`` (int64, -1 on holes) and the ``top`` level."""

    def __init__(self, len32, owner, top: int, device):
        self.len32 = torch.as_tensor(len32, dtype=torch.int64).to(device)
        self.owner = torch.as_tensor(owner, dtype=torch.int64).to(device)
        self.top = int(top)
        self.n_segs = int(self.len32.shape[0])


def _walk(ids, ctr, lane_top, max_top: int, s_log2: int, number: str):
    """One ASURA number per lane -> ``(k, frac, consults)``.

    ``ctr`` is (max_top + 1, m) int64, row L the level-L counter, ticked in
    place once per consulted level.  A lane starts at ``lane_top`` (an
    int, or an int64 tensor per lane) and walks down.  ``frac`` is the u32
    fraction for ``number="exact"`` and the float32 fraction scaled to
    2**32 for the control."""
    m = ids.shape[0]
    dev = ids.device
    f32 = number == "float32"
    k = torch.zeros(m, dtype=torch.int64, device=dev)
    frac = torch.zeros(m, dtype=torch.float32 if f32 else torch.int64, device=dev)
    per_lane = isinstance(lane_top, torch.Tensor)
    walking = torch.ones(m, dtype=torch.bool, device=dev)
    consults = 0
    for level in range(max_top, -1, -1):
        here = walking & (lane_top >= level) if per_lane else walking
        if per_lane or level < max_top:
            lanes = torch.nonzero(here).flatten()
            if lanes.numel() == 0:
                if per_lane:
                    continue
                break
        else:
            lanes = None
        c = ctr[level] if lanes is None else ctr[level, lanes]
        h = draw(ids if lanes is None else ids[lanes], level, c)
        if lanes is None:
            ctr[level] = c + 1
            consults += m
        else:
            ctr[level, lanes] = c + 1
            consults += int(lanes.numel())
        shift = s_log2 + level
        if f32:
            hf = h.to(torch.float32)
            stop = hf >= float(HIGH_BIT) if level > 0 else torch.ones_like(hf, dtype=torch.bool)
            value = hf * float(2.0 ** (shift - 32))
            kk = torch.floor(value)
            ff = (value - kk) * float(2.0**32)
            kk = kk.to(torch.int64)
        else:
            stop = h >= HIGH_BIT if level > 0 else torch.ones_like(h, dtype=torch.bool)
            kk = h >> (32 - shift)
            ff = (h << shift) & M32
        if lanes is None:
            k = torch.where(stop, kk, k)
            frac = torch.where(stop, ff, frac)
            walking = walking & ~stop
        else:
            sl = lanes[stop]
            k[sl] = kk[stop]
            frac[sl] = ff[stop]
            walking[sl] = False
    return k, frac, consults


def _hit(k, frac, len32, n_segs: int, number: str):
    """The segment test of one ASURA number per lane."""
    safe = k.clamp(0, n_segs - 1)
    if number == "float32":
        return (k < n_segs) & (frac < len32[safe].to(torch.float32)), safe
    return (k < n_segs) & (frac < len32[safe]), safe


def _check_number(number: str) -> None:
    if number not in NUMBERS:
        raise ValueError(f"number must be one of {NUMBERS}, got {number!r}")


def place_replicas(
    ids: torch.Tensor,
    table: Table,
    n_replicas: int,
    *,
    s_log2: int = 1,
    max_draws: int = 128,
    number: str = "exact",
    counts: Counts | None = None,
) -> torch.Tensor:
    """Section 5.A replication -> (batch, R) int64 owners, primary first,
    -1 where a lane found fewer than R distinct owners in ``max_draws * R``
    draws.  ``counts``, when given, is increased by the lanes' work (draws
    made while a lane still sought a replica)."""
    _check_number(number)
    ids = widen(ids)
    n, R = int(ids.shape[0]), int(n_replicas)
    dev = ids.device
    out = torch.full((n, R), -1, dtype=torch.int64, device=dev)
    alive = torch.arange(n, device=dev)
    live = ids
    ctr = torch.zeros((table.top + 1, n), dtype=torch.int64, device=dev)
    owners = torch.full((n, R), -1, dtype=torch.int64, device=dev)
    found = torch.zeros(n, dtype=torch.int64, device=dev)
    consults = draws = distinct = 0

    def retire(mask):
        nonlocal distinct
        out[alive[mask]] = owners[mask]
        if counts is not None:
            distinct += int((ctr[:, mask] > 0).sum())

    for _ in range(max_draws * max(1, R)):
        if alive.numel() == 0:
            break
        k, frac, c = _walk(live, ctr, table.top, table.top, s_log2, number)
        consults += c
        draws += int(live.shape[0])
        hit, safe = _hit(k, frac, table.len32, table.n_segs, number)
        who = table.owner[safe]
        fresh = hit & ~(owners == who[:, None]).any(dim=1)
        rows = torch.nonzero(fresh).flatten()
        owners[rows, found[rows]] = who[rows]
        found[rows] += 1
        done = found >= R
        retire(done)
        keep = ~done
        alive, live, ctr = alive[keep], live[keep], ctr[:, keep]
        owners, found = owners[keep], found[keep]
    retire(torch.ones_like(found, dtype=torch.bool))
    if counts is not None:
        counts.add(dict(consults=consults, draws=draws, distinct=distinct, tail=0))
    return out


class StackedTables:
    """Several segment tables side by side (one row each, zero-padded to
    the longest), so that every lane can place in its own row at once."""

    def __init__(self, tables: list[Table], device):
        self.width = max(t.n_segs for t in tables)
        self.rows = len(tables)
        len32 = torch.zeros((self.rows, self.width), dtype=torch.int64)
        owner = torch.full((self.rows, self.width), -1, dtype=torch.int64)
        for i, t in enumerate(tables):
            len32[i, : t.n_segs] = t.len32.cpu()
            owner[i, : t.n_segs] = t.owner.cpu()
        self.len32 = len32.to(device).reshape(-1)
        self.owner = owner.to(device).reshape(-1)
        self.cum = torch.cumsum(len32, 1).to(device)  # the padding adds nothing
        self.top = torch.tensor([t.top for t in tables], dtype=torch.int64, device=device)
        self.max_top = int(max(t.top for t in tables))


def place_in_rows(
    ids: torch.Tensor,
    rows: torch.Tensor,
    tables: StackedTables,
    *,
    s_log2: int = 1,
    max_draws: int = 128,
    number: str = "exact",
    counts: Counts | None = None,
) -> torch.Tensor:
    """Total single placement of lane i in row ``rows[i]`` of ``tables``
    -> int64 owners.  Lanes that miss ``max_draws`` times take the tail:
    one draw at their row's top + 1 (counter 0), ``u = (h * T) >> 32``
    over the row's total mass ``T``, and the first segment whose inclusive
    cumsum exceeds ``u``."""
    _check_number(number)
    ids = widen(ids)
    rows = rows.to(torch.int64)
    n = int(ids.shape[0])
    dev = ids.device
    W = tables.width
    seg = torch.full((n,), -1, dtype=torch.int64, device=dev)
    alive = torch.arange(n, device=dev)
    live, lrow = ids, rows
    ltop = tables.top[rows]
    ctr = torch.zeros((tables.max_top + 1, n), dtype=torch.int64, device=dev)
    consults = draws = distinct = 0
    for _ in range(max_draws):
        if alive.numel() == 0:
            break
        k, frac, c = _walk(live, ctr, ltop, tables.max_top, s_log2, number)
        consults += c
        draws += int(live.shape[0])
        safe = k.clamp(0, W - 1)
        lens = tables.len32[lrow * W + safe]
        if number == "float32":
            hit = (k < W) & (frac < lens.to(torch.float32))
        else:
            hit = (k < W) & (frac < lens)
        seg[alive[hit]] = k[hit]
        if counts is not None:
            distinct += int((ctr[:, hit] > 0).sum())
        keep = ~hit
        alive, live, lrow, ltop, ctr = alive[keep], live[keep], lrow[keep], ltop[keep], ctr[:, keep]
    tail = int(alive.numel())
    if tail:
        if counts is not None:
            distinct += int((ctr > 0).sum())
        cum = tables.cum[lrow]  # (tail, W)
        total = cum[:, -1]
        h = draw(live, ltop + 1, torch.zeros_like(live))
        u = h * (total >> 32) + mulhi32(h, total & M32)
        seg[alive] = torch.searchsorted(cum, u[:, None], right=True)[:, 0]
    if counts is not None:
        counts.add(dict(consults=consults, draws=draws, distinct=distinct, tail=tail))
    return tables.owner[rows * W + seg]
