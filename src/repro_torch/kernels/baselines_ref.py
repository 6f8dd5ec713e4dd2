"""Plain-torch twins of the baseline kernels (``csrc/baselines.cu``).

Each function computes what a CUDA kernel of ``baselines.cu`` computes,
in plain tensor code that runs on any device: the wrappers in
``baselines.py`` take them for CPU tensors, ``chip_smoke.py`` holds every
kernel to them on the card, and the tests hold them to the reference's
jnp bodies, Pallas kernels (interpret mode) and NumPy oracles, bit for
bit.  They follow the reference's ``kernels/baselines.py``:

  * ``ch_lookup`` / ``rs_lookup`` -- ``fmix32`` then the branchless
    fixed-trip ``_bsearch`` over the lane-padded table;
  * ``neg_log2_q16`` and ``wrh_lookup`` -- the Q16 ``-log2`` and the
    running argmin over the salt / reciprocal tables.  The squaring keeps
    its 24-bit mantissa's product in int64 (``m * m < 2**48``), the bits
    the reference assembles from 16-bit limbs; the lookup walks the node
    table in (ids x nodes) blocks, taking each block's first minimum and
    replacing the running best only on strict ``<``, so the first minimal
    node wins as in the reference's one-node-at-a-time loop;
  * ``baseline_replicas_lookup`` -- the salted rejection fan-out with its
    ``[reprobes]`` stat; lanes leave the loop once their set is full (the
    reference's batch-wide early exit only skips iterations that change
    nothing).

u32 values travel in ``int64`` under the rule of ``u32.py``; outputs are
``int32`` node ids (-1 = none) and the ``uint32`` stats vector.
"""

from __future__ import annotations

import torch

from ..core.rng import GOLDEN
from .ref import draw_u32, fmix32
from .u32 import M32, add32, as_u32, mul32, to_u32

# R-way fan-out rejection stream: the k-th re-probe hashes the datum id at
# a reserved level far above any ASURA ladder level (the reference's
# constants).
REPLICA_FANOUT_LEVEL = 0x52455031  # "REP1"
REPLICA_MAX_TRIES = 64

Q16 = 16  # fractional bits of the fixed-point -log2
GOLDEN_INV = pow(GOLDEN, -1, 1 << 32)  # salt = GOLDEN * (node + 1) -> node

# pair evaluations per (ids x nodes) block of ``wrh_lookup``
WRH_BLOCK = 1 << 22


def _bsearch(keys: torch.Tensor, h: torch.Tensor, *, side_left: bool) -> torch.Tensor:
    """First index with ``keys[idx] >= h`` (``side_left``) or ``> h``, by
    a fixed ``bit_length(len(keys))``-step branchless search -> int64."""
    n_pad = keys.shape[0]
    lo = torch.zeros_like(h)
    hi = torch.full_like(h, n_pad)
    for _ in range(max(1, n_pad.bit_length())):
        active = lo < hi
        mid = torch.clamp((lo + hi) >> 1, max=n_pad - 1)
        k = keys[mid]
        below = (k < h) if side_left else (k <= h)
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return lo


def ch_lookup(ids: torch.Tensor, ring: torch.Tensor, owners: torch.Tensor) -> torch.Tensor:
    """Consistent hashing: the first ring point clockwise -> int32 owners."""
    h = fmix32(as_u32(ids))
    idx = _bsearch(as_u32(ring), h, side_left=True)
    idx = torch.where(idx == ring.shape[0], 0, idx)  # wrap
    return owners.to(torch.int32)[idx]


def rs_lookup(ids: torch.Tensor, starts: torch.Tensor, owners: torch.Tensor) -> torch.Tensor:
    """Random slicing: the owner of the last start <= the hash -> int32."""
    h = fmix32(as_u32(ids))
    idx = _bsearch(as_u32(starts), h, side_left=False) - 1
    idx = torch.where(idx < 0, starts.shape[0] - 1, idx)  # starts[0] != 0 only
    return owners.to(torch.int32)[idx]


def neg_log2_q16(h: torch.Tensor) -> torch.Tensor:
    """-log2(u) in Q16 for u = (2*(h >> 9) + 1) / 2**24 -> int32, > 0
    (``core.wrh.neg_log2_q16_np``)."""
    h = as_u32(h)
    v = ((h >> 9) << 1) | 1  # odd, [1, 2**24)
    x = v
    e = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = (x >= (1 << s)).to(torch.int64)
        e = e + s * big
        x = x >> (s * big)
    m = v << (23 - e)  # [2**23, 2**24)
    frac = torch.zeros_like(v)
    for i in range(1, Q16 + 1):
        m = (m * m) >> 23  # < 2**48 before the shift: exact in int64
        ge = (m >= (1 << 24)).to(torch.int64)
        frac = frac | (ge << (Q16 - i))
        m = m >> ge
    return (((24 - e) << Q16) - frac).to(torch.int32)


def wrh_lookup(
    ids: torch.Tensor,
    salts: torch.Tensor,
    inv_w: torch.Tensor,
    *,
    block: int = WRH_BLOCK,
) -> torch.Tensor:
    """Weighted rendezvous: the node of least ``float(neg_log2_q16(
    fmix32(fmix32(id + salt)))) * inv_w`` among entries with ``inv_w > 0``
    (first minimum on ties) -> int32 node ids, -1 when none is valid."""
    ids = as_u32(ids)
    salts = as_u32(salts)
    inv_w = inv_w.to(torch.float32)
    n, n_nodes = ids.shape[0], salts.shape[0]
    dev = ids.device
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    best_key = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    best_salt = torch.zeros(n, dtype=torch.int64, device=dev)
    cols = max(1, block // max(1, n))
    for j0 in range(0, n_nodes, cols):
        s = salts[j0 : j0 + cols]
        iw = inv_w[j0 : j0 + cols]
        h = fmix32(fmix32(add32(ids[:, None], s[None, :])))
        key = neg_log2_q16(h).to(torch.float32) * iw[None, :]  # one IEEE f32 mul
        key = torch.where(iw[None, :] > 0, key, inf)
        kmin = key.min(dim=1).values
        pos = torch.arange(s.shape[0], device=dev)
        first = torch.where(key == kmin[:, None], pos[None, :], s.shape[0]).min(dim=1).values
        better = kmin < best_key
        best_key = torch.where(better, kmin, best_key)
        best_salt = torch.where(better, s[first.clamp(max=s.shape[0] - 1)], best_salt)
    node = (mul32(best_salt, GOLDEN_INV) - 1) & M32  # salt 0 -> 0xFFFFFFFF
    return to_u32(node).view(torch.int32)


LOOKUPS = {"ch": ch_lookup, "rs": rs_lookup, "wrh": wrh_lookup}


def baseline_replicas_lookup(
    algorithm: str,
    ids: torch.Tensor,
    keys: torch.Tensor,
    vals: torch.Tensor,
    *,
    n_replicas: int,
    max_tries: int = REPLICA_MAX_TRIES,
    emit_stats: bool = False,
):
    """R-way fan-out -> (batch, R) int32 nodes, primary first, -1 for the
    slots a lane did not fill within ``max_tries``.

    Slot 0 is the lookup of the id; try ``k`` looks up ``draw_u32(id,
    REPLICA_FANOUT_LEVEL, k)`` and takes it if it equals none of the R
    slots (an unfilled slot holds -1, so a -1 candidate is never taken).
    ``emit_stats`` also returns the (1,) uint32 ``[reprobes]``: the tries
    lanes made while their set was short (mod 2**32)."""
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    lookup = LOOKUPS[algorithm]
    ids = as_u32(ids)
    n, R = ids.shape[0], n_replicas
    dev = ids.device
    slots = torch.full((n, R), -1, dtype=torch.int64, device=dev)
    slots[:, 0] = lookup(ids, keys, vals).to(torch.int64)
    found = torch.ones(n, dtype=torch.int64, device=dev)
    short = torch.arange(n, device=dev) if R > 1 else torch.arange(0, device=dev)
    probes = 0
    for k in range(1, max_tries + 1):
        if short.numel() == 0:
            break
        probes += short.numel()
        h = draw_u32(ids[short], REPLICA_FANOUT_LEVEL, torch.full_like(short, k))
        cand = lookup(h, keys, vals).to(torch.int64)
        take = ~(slots[short] == cand[:, None]).any(dim=1)
        rows = short[take]
        slots[rows, found[rows]] = cand[take]
        found[rows] += 1
        short = short[found[short] < R]
    out = slots.to(torch.int32)
    if not emit_stats:
        return out
    stats = torch.tensor([probes & M32], dtype=torch.int64, device=dev)
    return out, to_u32(stats)
