"""Consistent Hashing baseline (Karger et al. 1997), as evaluated in the paper.

Faithful to the paper's section IV setup: each node gets V virtual-node hash
numbers placed on a 32-bit ring; the initial stage sorts them (O(NV log NV));
the distribution stage hashes the datum id and binary-searches the ring
(O(log NV)).  Memory is O(NV) -- 8 bytes per virtual node (Table II).

The same counter-based generator used by ASURA produces the hashes, matching
the paper's "same pseudorandom number generator for a fair quantitative
evaluation" premise.

The port's own copy of the reference's ``core/consistent_hashing.py``
(NumPy only); the card runs the distribution stage in
``kernels/csrc/baselines.cu``.
"""

from __future__ import annotations

import numpy as np

from .rng import draw_u32_np, fmix32_np


def build_ring(node_ids, virtual_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Initial stage as bare arrays: (sorted ring hashes u32, owners u32).

    The canonical lookup state the ``PlacementEngine`` baseline backend
    caches per cluster version (the ring analogue of the segment table).
    """
    nodes = np.asarray(list(node_ids), dtype=np.uint32)
    if nodes.shape[0] == 0:
        raise ValueError("need at least one node")
    ids = np.repeat(nodes, int(virtual_nodes))
    vidx = np.tile(np.arange(int(virtual_nodes), dtype=np.uint32), nodes.shape[0])
    hashes = draw_u32_np(ids, np.uint32(0), vidx)
    order = np.argsort(hashes, kind="stable")
    return hashes[order], ids[order]


def ch_place_np(datum_ids, ring_hashes: np.ndarray, ring_owners: np.ndarray) -> np.ndarray:
    """NumPy oracle for the distribution stage: first ring point clockwise.

    Bit-identical to the plain-torch twin and the CUDA binary-search
    kernel behind ``repro_torch.kernels.baselines`` (tested).
    """
    ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
    if ids.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    h = fmix32_np(ids)
    idx = np.searchsorted(ring_hashes, h, side="left")
    idx = np.where(idx == ring_hashes.shape[0], 0, idx)  # wrap
    return ring_owners[idx].astype(np.int64)


class ConsistentHashRing:
    def __init__(self, node_ids, virtual_nodes: int = 100):
        self.virtual_nodes = int(virtual_nodes)
        self.node_ids = np.asarray(list(node_ids), dtype=np.uint32)
        # initial stage: NV hash numbers, sorted once.
        self.ring_hashes, self.ring_owners = build_ring(
            self.node_ids, self.virtual_nodes
        )

    def memory_bytes(self) -> int:
        """Table II accounting: 8NV bytes (4-byte hash + 4-byte owner)."""
        return 8 * self.ring_hashes.shape[0]

    def place(self, datum_ids) -> np.ndarray:
        """Distribution stage: datum hash -> first ring point clockwise."""
        return ch_place_np(datum_ids, self.ring_hashes, self.ring_owners)
