"""Weighted Rendezvous Hashing baseline in the exact-u32 formulation.

Rendezvous (highest-random-weight) hashing assigns each datum to the node
with the best keyed hash of the (datum, node) pair; weighting by capacity
uses the exponential-race form: node ``i`` wins iff it minimizes

    key_i = -log2(u_i) / w_i,      u_i = hash(datum, node_i) mapped to (0, 1),

which selects node ``i`` with probability w_i / sum(w) (the max of
``u**(1/w)`` rule, CRUSH "straw" / Sage & Weil).  ``core.straw.StrawBucket``
already implements this rule on the host with float64 ``np.log`` -- a
transcendental whose last-bit rounding is libm-specific, so a device kernel
could never be BIT-IDENTICAL to it.  This module is the device-exact
re-formulation the ``PlacementEngine`` baseline backend uses:

  * ``-log2(u)`` is computed by the classic integer square-and-shift
    algorithm in Q16 fixed point -- pure u32 shifts/multiplies (via the same
    16-bit-limb trick the tail resolver uses), bit-identical on NumPy, in
    plain torch and inside the CUDA kernels,
  * the only float ops are ONE IEEE float32 reciprocal per NODE (computed
    at table-prep time, shared by every id) and ONE float32 multiply per
    (id, node) pair -- each a single correctly-rounded op, immune to FMA
    re-association, so host and device agree bit-for-bit,
  * argmin ties break to the lowest node index on every path.

The mantissa keeps 23 bits of the raw draw (u = (2*(h >> 9) + 1) * 2**-24,
exactly representable in float32 and never 0 or 1), which leaves the
selection probabilities within 2**-16 of exact -- far below the sampling
noise of any uniformity figure -- while making cross-backend equality a
bit-for-bit assertion instead of a tolerance.
"""

from __future__ import annotations

import numpy as np

from .rng import draw_u32_np

Q16 = 16  # fractional bits of the fixed-point -log2


def neg_log2_q16_np(h: np.ndarray) -> np.ndarray:
    """-log2(u) in Q16 for u = (2*(h >> 9) + 1) / 2**24 -> int32, > 0.

    Integer square-and-shift log: normalize the 24-bit odd mantissa
    ``v = 2*(h >> 9) + 1`` to ``m in [2**23, 2**24)``, then square 16 times,
    shifting out one fraction bit per overflow.  Every step is exact u32
    arithmetic, so NumPy, plain torch and CUDA agree bit-for-bit.
    """
    h = np.asarray(h, dtype=np.uint32)
    v = ((h >> np.uint32(9)) << np.uint32(1)) | np.uint32(1)  # odd, [1, 2**24)
    # e = floor(log2 v) via binary integer search (no float bitcasts).
    x = v.copy()
    e = np.zeros(v.shape, dtype=np.uint32)
    for s in (16, 8, 4, 2, 1):
        big = x >= np.uint32(1) << np.uint32(s)
        e += np.where(big, np.uint32(s), np.uint32(0))
        x = np.where(big, x >> np.uint32(s), x)
    m = v << (np.uint32(23) - e)  # mantissa in [2**23, 2**24)
    frac = np.zeros(v.shape, dtype=np.uint32)
    with np.errstate(over="ignore"):  # the limb products wrap by design
        for i in range(1, Q16 + 1):
            # m*m needs 48 bits: assemble from 16-bit limbs, keep bits 47..23.
            m16 = np.uint32(0xFFFF)
            a_lo, a_hi = m & m16, m >> np.uint32(16)
            ll = a_lo * a_lo
            lh = a_lo * a_hi
            t = (ll >> np.uint32(16)) + (lh & m16) + (lh & m16)
            lo = (t << np.uint32(16)) | (ll & m16)
            hi = (
                a_hi * a_hi
                + (lh >> np.uint32(16))
                + (lh >> np.uint32(16))
                + (t >> np.uint32(16))
            )
            m = (hi << np.uint32(9)) | (lo >> np.uint32(23))
            ge = m >= np.uint32(1) << np.uint32(24)
            frac |= np.where(ge, np.uint32(1) << np.uint32(Q16 - i), np.uint32(0))
            m = np.where(ge, m >> np.uint32(1), m)
    # -log2(u) = 24 - log2(v);  log2(v) ~= e + frac * 2**-16 (truncated).
    return (
        ((np.uint32(24) - e).astype(np.int32) << np.int32(Q16)) - frac.astype(np.int32)
    )


def wrh_hash_np(datum_ids: np.ndarray, node_ids: np.ndarray) -> np.ndarray:
    """(batch, n) raw pair hashes -- the same keyed draw StrawBucket uses."""
    ids = np.asarray(datum_ids, dtype=np.uint32).reshape(-1)
    nodes = np.asarray(node_ids, dtype=np.uint32)
    return draw_u32_np(
        ids[:, None], nodes[None, :], np.zeros((1, nodes.shape[0]), dtype=np.uint32)
    )


def wrh_place_np(
    datum_ids: np.ndarray, node_ids: np.ndarray, weights: np.ndarray
) -> np.ndarray:
    """NumPy oracle: index into ``node_ids`` of each datum's winner.

    ``weights`` are float32 capacities (> 0).  Returns int64 node ids.
    Bit-identical to the plain-torch twin and the CUDA kernel behind
    ``repro_torch.kernels.baselines`` (tested).
    """
    nodes = np.asarray(node_ids, dtype=np.uint32)
    w = np.asarray(weights, dtype=np.float32)
    ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
    if ids.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    h = wrh_hash_np(ids, nodes)
    # One f32 reciprocal per NODE, one f32 multiply per (id, node) -- the
    # same precomputed-reciprocal key the device tables bake in
    # (``repro_torch.kernels.baselines.wrh_table_prep``), so the two paths stay
    # bit-identical; both are single correctly-rounded IEEE ops.
    with np.errstate(divide="ignore"):
        inv_w = np.where(w > 0.0, np.float32(1.0) / w, np.float32(0.0))
    key = neg_log2_q16_np(h).astype(np.float32) * inv_w[None, :].astype(np.float32)
    return nodes[np.argmin(key, axis=1)].astype(np.int64)  # first-min tie-break
