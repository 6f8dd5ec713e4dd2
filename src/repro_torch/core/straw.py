"""Straw Buckets baseline (Weil et al., CRUSH 2006), as evaluated in the paper.

Each node draws a hash ("straw length") per datum; the node with the maximum
straw stores the datum (paper Fig. 2).  Distribution-stage cost is O(N) per
datum -- the property that makes it unscalable in the paper's Fig. 5.
Capacity weighting multiplies straws by CRUSH-style per-node factors so
selection probability tracks capacity (section III.E "in limited case").
Replication takes the R largest straws (section V.A).

This float64 ``np.log`` formulation is host-only; the ``PlacementEngine``
"wrh" backend uses the device-exact re-formulation in ``core/wrh.py``
(fixed-point -log2, bit-identical across NumPy, plain torch and CUDA --
DESIGN.md section 9), which implements the same weighted-rendezvous
selection rule.  The port's own copy of the reference's ``core/straw.py``.
"""

from __future__ import annotations

import numpy as np

from .rng import draw_u32_np


class StrawBucket:
    def __init__(self, node_ids, weights=None):
        self.node_ids = np.asarray(list(node_ids), dtype=np.uint32)
        n = self.node_ids.shape[0]
        if n == 0:
            raise ValueError("need at least one node")
        if weights is None:
            self.scale = np.ones(n)
        else:
            w = np.asarray(weights, dtype=np.float64)
            # CRUSH straw scaling: straw_i = hash ** (1 / w_i) on (0, 1);
            # equivalently compare log(u) / w_i.
            self.scale = w

    def memory_bytes(self) -> int:
        """O(N): node id + weight per node."""
        return 8 * self.node_ids.shape[0]

    def _straws(self, datum_ids) -> np.ndarray:
        ids = np.asarray(datum_ids, dtype=np.uint32).reshape(-1)
        # hash(datum, node) per pair -- depends ONLY on the pair, so straws
        # are stable under membership changes (the optimal-movement property).
        h = draw_u32_np(
            ids[:, None],
            self.node_ids[None, :],
            np.zeros((1, self.node_ids.shape[0]), dtype=np.uint32),
        ).astype(np.float64)
        u = (h + 1.0) * 2.0**-32  # (0, 1]
        return np.log(u) / self.scale[None, :]  # max == capacity-weighted max straw

    def place(self, datum_ids) -> np.ndarray:
        straws = self._straws(datum_ids)
        return self.node_ids[np.argmax(straws, axis=1)]

    def place_replicas(self, datum_ids, n_replicas: int) -> np.ndarray:
        straws = self._straws(datum_ids)
        order = np.argsort(-straws, axis=1)[:, :n_replicas]
        return self.node_ids[order]
