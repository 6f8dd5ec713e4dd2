"""Counter-based pseudorandom draws shared by every ASURA implementation.

The port's own copy of the reference's host-side generator (the reference
package stays untouched and is never imported).  The k-th draw of the
level-``l`` generator for datum ``id`` is

    u(id, l, k) = fmix32(fmix32(id + GOLDEN * (l + 1)) ^ (k * KMULT)) / 2**32

with ``fmix32`` the MurmurHash3 32-bit finalizer.  Every draw is a pure
function of ``(id, level, counter)``, which is what lets the CUDA kernels
run one thread per id with its own loop and still agree bit for bit with
the lockstep reference (DESIGN.md section 3).
"""

from __future__ import annotations

import numpy as np

GOLDEN = 0x9E3779B9  # 2**32 / golden ratio
KMULT = 0x85EBCA77   # odd multiplier decorrelating the counter stream

_INV_2_32 = float(2.0**-32)


def fmix32_scalar(h: int) -> int:
    """MurmurHash3 finalizer on a Python int (masked to 32 bits)."""
    h &= 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def draw_u32_scalar(datum_id: int, level: int, counter: int) -> int:
    """The k-th raw 32-bit draw of the level-``level`` generator."""
    seed = fmix32_scalar((datum_id + GOLDEN * (level + 1)) & 0xFFFFFFFF)
    return fmix32_scalar(seed ^ ((counter * KMULT) & 0xFFFFFFFF))


def draw_u01_scalar(datum_id: int, level: int, counter: int) -> float:
    """Uniform draw on [0, 1) -- scalar oracle path."""
    return draw_u32_scalar(datum_id, level, counter) * _INV_2_32


def fmix32_np(h: np.ndarray) -> np.ndarray:
    """Vectorized MurmurHash3 finalizer (uint32 in, uint32 out)."""
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def draw_u32_np(datum_ids: np.ndarray, level, counters) -> np.ndarray:
    """Vectorized raw draws; broadcasts over ids/levels/counters."""
    ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
    lvl = np.atleast_1d(np.asarray(level, dtype=np.uint32))
    ctr = np.atleast_1d(np.asarray(counters, dtype=np.uint32))
    with np.errstate(over="ignore"):  # uint32 wrap-around is intended
        seed = fmix32_np(ids + np.uint32(GOLDEN) * (lvl + np.uint32(1)))
        out = fmix32_np(seed ^ (ctr * np.uint32(KMULT)))
    return out


def draw_u01_np(datum_ids: np.ndarray, level, counters) -> np.ndarray:
    """Vectorized uniform draws on [0, 1) (float64)."""
    return draw_u32_np(datum_ids, level, counters).astype(np.float64) * _INV_2_32


def hash_str_to_u32(s: str) -> int:
    """Stable string -> uint32 for node / datum ids given as strings
    (FNV-1a, then ``fmix32``)."""
    h = 0x811C9DC5
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return fmix32_scalar(h)
