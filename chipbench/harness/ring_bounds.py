"""The least time of a consistent-hashing replica fan-out, as
``bounds.py`` counts it for the ASURA kernels: the larger of its bytes
over the card's memory bandwidth and its int32 operations over the
card's int32 rate (``bounds.least_seconds``).

The bytes are the ids read once, the (n, R) int32 sets written once and
the ring's points and owners (4 bytes each) read once.  The operations
are counted from the lookups the plain reference makes on the same inputs
(``reference.ring.Counts``), whatever index stride the kernel picks:

  * a lookup: the hash (one fmix32, 8), a binary search of
    ``ceil(log2(points))`` steps at 6 each, and the owner gather (3);
  * a re-lookup besides: its draw, ``fmix32(seed ^ k * KMULT)`` (8 and
    the multiply and the xor), and the distinct-node test (R compares);
  * an id that re-looks up: its generator seed once, ``fmix32(id +
    term)`` (9), since the seed depends on the id alone.
"""

from __future__ import annotations

from chipbench.harness.bounds import FMIX_OPS, GATHER_OPS, OPS_PER_SEARCH_STEP, OPS_PER_SEED

OPS_PER_FOLD = 2  # a draw's counter multiply and xor onto the seed


def search_steps(n_points: int) -> int:
    """ceil(log2(n_points)) steps of a binary search, at least 1."""
    return max(1, (int(n_points) - 1).bit_length())


def fanout(n: int, R: int, n_points: int, c: dict) -> tuple[int, int]:
    """(bytes, ops) of one R-replica fan-out of ``n`` ids on a ring of
    ``n_points`` points, with ``c`` the reference's ``Counts``."""
    nbytes = 4 * n + 4 * R * n + 8 * n_points
    lookup = FMIX_OPS + OPS_PER_SEARCH_STEP * search_steps(n_points) + GATHER_OPS
    ops = (lookup * c["lookups"] + (FMIX_OPS + OPS_PER_FOLD + R) * c["relookups"]
           + OPS_PER_SEED * c["seeded"])
    return nbytes, ops
