"""Random Slicing baseline (Miranda et al. 2014), as framed by the paper's
related work: the unit interval [0, 1) is partitioned into contiguous
intervals, each owned by one node, and a datum is stored on the owner of
the interval its hash falls into.

Membership changes re-slice minimally: capacity shares are recomputed and
ONLY the surplus mass of over-quota nodes is cut off (splitting their
intervals) and handed to under-quota nodes, so data moves exactly from
givers to takers -- the optimal-movement property ASURA is compared
against.  Lookup is a binary search over the interval starts, O(log I) for
I intervals; memory is O(I) and I grows by at most O(N) per membership
event.

The table is canonicalized exactly like the ASURA segment table: interval
boundaries are maintained as EXACT integers on the u32 circle (total mass
2**32, shares by largest-remainder rounding), so

  * ``starts32`` (sorted uint32, first entry 0) + ``owners`` (int32) is the
    whole lookup state,
  * the lookup is ``owners[searchsorted(starts32, fmix32(id), 'right') - 1]``
    -- the CUDA binary-search kernel behind ``repro_torch.kernels.baselines``
    and its plain-torch twin are bit-identical to the NumPy oracle below,
  * no float boundary can drift between host and device.

The port's own copy of the reference's ``core/random_slicing.py``.
"""

from __future__ import annotations

import numpy as np

from .rng import fmix32_np

_MASS = 1 << 32  # total mass of the u32 circle


def _quotas(weights: dict[int, float]) -> dict[int, int]:
    """Largest-remainder shares of the 2**32 circle, summing exactly.

    Deterministic: remainders tie-break by node id, so every replica of the
    table computes the same slicing.
    """
    total = float(sum(weights.values()))
    if total <= 0:
        raise ValueError("total capacity must be positive")
    floors: dict[int, int] = {}
    rema: list[tuple[float, int]] = []
    for nid in sorted(weights):
        exact = weights[nid] * _MASS / total
        f = int(exact)
        floors[nid] = f
        rema.append((-(exact - f), nid))
    short = _MASS - sum(floors.values())
    for _, nid in sorted(rema)[:short]:
        floors[nid] += 1
    return floors


class RandomSlicingTable:
    """Mutable interval table mirroring a cluster's membership.

    ``rebalance`` moves the table from its current slicing to the quota of a
    new weight map in one minimal step -- additions, removals and resizes
    are all the same operation, so the engine can sync the table to any
    cluster version with one call.
    """

    def __init__(self, weights: dict[int, float] | None = None):
        # intervals: (start, length, owner) with exact int starts/lengths,
        # sorted by start, covering [0, 2**32) exactly once.
        self._intervals: list[tuple[int, int, int]] = []
        self.weights: dict[int, float] = {}
        if weights:
            self.rebalance(weights)

    # -- slicing -------------------------------------------------------------

    def _assigned(self) -> dict[int, int]:
        mass: dict[int, int] = {nid: 0 for nid in self.weights}
        for _, length, owner in self._intervals:
            mass[owner] = mass.get(owner, 0) + length
        return mass

    def rebalance(self, weights: dict[int, float]) -> None:
        """Re-slice to the new weight map with minimal movement.

        Over-quota nodes (including departed ones, quota 0) free exactly
        their surplus, cut from the tail of each of their intervals in
        start order (splitting an interval when the cut lands inside it);
        the freed pieces are handed to under-quota nodes in node-id order.
        Mass moves only giver -> taker, so the moved fraction equals the
        quota delta -- optimal.
        """
        for nid, w in weights.items():
            if w <= 0:
                raise ValueError(f"node {nid} capacity must be positive")
        quotas = _quotas(weights)
        assigned = self._assigned()
        if not self._intervals:
            free = [(0, _MASS)]  # initial build: the whole circle is free
        else:
            free = []
            kept: list[tuple[int, int, int]] = []
            for start, length, owner in self._intervals:
                surplus = assigned.get(owner, 0) - quotas.get(owner, 0)
                give = min(max(surplus, 0), length)
                if give:
                    # cut from the tail of this interval
                    if give < length:
                        kept.append((start, length - give, owner))
                    free.append((start + length - give, give))
                    assigned[owner] -= give
                else:
                    kept.append((start, length, owner))
            self._intervals = kept
        # hand the freed pieces to under-quota nodes, node-id order.
        free.reverse()  # pop() serves pieces in ascending-start order
        for nid in sorted(quotas):
            need = quotas[nid] - assigned.get(nid, 0)
            while need > 0:
                start, length = free.pop()
                take = min(length, need)
                self._intervals.append((start, take, nid))
                if take < length:
                    free.append((start + take, length - take))
                need -= take
        assert not free, "re-slice must cover the circle exactly"
        self._intervals.sort()
        self.weights = dict(weights)

    # -- canonical lookup state ---------------------------------------------

    def n_intervals(self) -> int:
        return len(self._intervals)

    def memory_bytes(self) -> int:
        """Table-II-style accounting: 8 bytes per interval (start + owner)."""
        return 8 * len(self._intervals)

    def starts_owners(self) -> tuple[np.ndarray, np.ndarray]:
        """(starts32 uint32 sorted with starts32[0] == 0, owners int32)."""
        starts = np.asarray([s for s, _, _ in self._intervals], dtype=np.uint64)
        owners = np.asarray([o for _, _, o in self._intervals], dtype=np.int32)
        return starts.astype(np.uint32), owners

    def place(self, datum_ids) -> np.ndarray:
        starts32, owners = self.starts_owners()
        return rs_place_np(datum_ids, starts32, owners)


def rs_place_np(datum_ids, starts32: np.ndarray, owners: np.ndarray) -> np.ndarray:
    """NumPy oracle: hash each id onto the circle, map to its interval owner.

    ``searchsorted(..., 'right') - 1`` finds the last interval starting at
    or before the hash; ``starts32[0] == 0`` guarantees the index is valid.
    Bit-identical to the plain-torch twin and the CUDA kernel (tested).
    """
    ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
    if ids.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    h = fmix32_np(ids)
    idx = np.searchsorted(starts32, h, side="right") - 1
    return owners[idx].astype(np.int64)
