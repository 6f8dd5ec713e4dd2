"""Carry the reference's state across to the port.

ASURA has no weights: its whole shared state is the STEP-1 segment table
(kilobytes, paper Table II) and the cluster membership behind it.  These
two functions are the port's loaders for that state:

  * ``cluster_from_reference_json`` rebuilds a port ``Cluster`` from the
    blob the reference's ``Cluster.to_json()`` writes (the same format,
    so membership, free-segment heap, version and params carry over);
  * ``artifact_from_arrays`` builds the port's ``TableArtifact`` (host
    arrays plus device tables) straight from the reference engine's
    NumPy tables (``len32``, ``node_of``, ``top_level``, ``version``).

Both take plain JSON / NumPy, so nothing of the reference is imported.
"""

from __future__ import annotations

import numpy as np

from .core.cluster import Cluster
from .core.engine import TableArtifact, with_device_tables


def cluster_from_reference_json(blob: str, *, device=None) -> Cluster:
    """A port ``Cluster`` equal to the reference cluster that wrote ``blob``;
    its ``.engine`` places on ``device`` (None: the card)."""
    return Cluster.from_json(blob, device=device)


def artifact_from_arrays(
    len32, node_of, top_level: int, version: int, device=None
) -> TableArtifact:
    """The port's table artifact for one version, device tables included."""
    len32 = np.ascontiguousarray(np.asarray(len32, dtype=np.uint32))
    node_of = np.asarray(node_of, dtype=np.int64)
    if len32.shape != node_of.shape or len32.ndim != 1:
        raise ValueError(
            f"len32 {len32.shape} and node_of {node_of.shape} must be equal 1-D"
        )
    art = TableArtifact(
        version=int(version),
        n_segs=int(len32.shape[0]),
        top_level=int(top_level),
        len32=len32,
        node_of=node_of,
    )
    return with_device_tables(art, device)
