"""Peaks of the card and the least time a kernel's work can take.

A kernel's least time is the larger of its bytes, each input read once
and each output written once, over the card's memory bandwidth, and the
int32 operations its inputs need over the card's int32 rate.  The
operations are counted from the work the plain reference counts on the
same inputs (``reference.asura.Counts``), so they read the same work
whatever implements the kernel:

  * a ladder consult: 11 (one fmix32 of 8, the counter's multiply, xor
    and tick), and 9 more per distinct level a lane consults (its seed:
    one fmix32 and the add), since the seed depends on (id, level) alone;
  * a draw: 4 (floor shift, fraction shift, bound and length compares),
    and in a replica set 3 more (the owner gather and the distinct-owner
    test);
  * a lane of a total placement that falls to the tail: one more consult
    with its seed (20) and a binary search of 6 per step;
  * a rack-aware replica: the salt (xor, multiply) and an fmix32, and
    three gathers of 3.

The NVIDIA H100 SXM's published peaks, at its 700 W limit: 3.35 TB/s of
HBM3; int32 at 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7 T
operations per second (the data sheet's SM count and boost clock, which
give its 67 TFLOP/s FP32 row as 132 x 128 x 2 x 1.98 GHz).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

OPS_PER_CONSULT = 11
OPS_PER_SEED = 9
OPS_PER_DRAW = 4
OPS_PER_REPLICA_DRAW = OPS_PER_DRAW + 3
OPS_PER_TAIL = 20
OPS_PER_SEARCH_STEP = 6
FMIX_OPS = 8
GATHER_OPS = 3


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def ladder_ops(c: dict) -> int:
    return OPS_PER_CONSULT * c["consults"] + OPS_PER_SEED * c["distinct"]


def replicas(n: int, R: int, n_segs: int, c: dict) -> tuple[int, int]:
    """(bytes, ops) of one R-replica placement of ``n`` ids (kernel B2):
    ids in, (n, R) int32 nodes out, the table's lengths and owners."""
    nbytes = 4 * n + 4 * R * n + 8 * n_segs
    return nbytes, ladder_ops(c) + OPS_PER_REPLICA_DRAW * c["draws"]


def diff_replicas(n: int, R: int, segs: tuple[int, int], before: dict, after: dict) -> tuple[int, int]:
    """(bytes, ops) of one two-version replica diff of ``n`` ids (kernel
    B4): both sets out, both tables in.  One walk of the ladder serves both
    tables, so its consults and seeds are the larger table's; every draw
    of each table is tested."""
    nbytes = 4 * n + 2 * 4 * R * n + 8 * sum(segs)
    walk = max(before["consults"], after["consults"]) * OPS_PER_CONSULT
    seeds = max(before["distinct"], after["distinct"]) * OPS_PER_SEED
    return nbytes, walk + seeds + OPS_PER_REPLICA_DRAW * (before["draws"] + after["draws"])


def rack_replicas(n: int, R: int, rack_segs: int, node_segs: int, width: int, n_racks: int,
                  racks: dict, nodes: dict) -> tuple[int, int]:
    """(bytes, ops) of one rack-aware R-replica placement (kernel B8):
    ids in, the (2, R, n) rack and node planes out, both levels' tables
    (the node level's lengths, owners and u64 cumsum halves)."""
    nbytes = 4 * n + 8 * R * n + 8 * rack_segs + 16 * node_segs + 8 * n_racks
    ops = ladder_ops(racks) + OPS_PER_REPLICA_DRAW * racks["draws"]
    ops += ladder_ops(nodes) + OPS_PER_DRAW * nodes["draws"]
    ops += (OPS_PER_TAIL + OPS_PER_SEARCH_STEP * max(1, width).bit_length()) * nodes["tail"]
    ops += n * R * (FMIX_OPS + 2 + 3 * GATHER_OPS)
    return nbytes, ops
