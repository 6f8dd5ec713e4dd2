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

The baselines carry over the same way:

  * ``baseline_artifact_from_arrays`` builds the port's
    ``BaselineArtifact`` from a reference baseline artifact's canonical
    ``keys`` / ``vals``;
  * ``rs_table_from_intervals`` rebuilds a ``RandomSlicingTable`` from a
    reference table's ``_intervals`` and ``weights``: random slicing is
    history-dependent, so a port engine continues a reference engine's
    slicing from it (``PlacementEngine._rs_shadow``).

The failure-domain-aware mode carries over the same way:

  * ``hier_cluster_from_reference_json`` rebuilds a port
    ``HierarchicalCluster`` from the reference's domain-level blob
    (``h._top.to_json()``) and one blob per domain (``{did:
    h.domains[did].to_json()}``): the domain table is history-dependent
    (free-segment reuse), so it crosses over as data, not replayed;
  * ``hier_artifact_from_arrays`` builds the port's ``HierArtifact`` from
    a reference artifact's eight tables (``tables_dev`` as NumPy arrays)
    and its statics ``(top_level, max_top, s_pad)``.

A replicated checkpoint store carries over the same way:

  * ``checkpoint_store_from_reference`` rebuilds a port
    ``AsuraCheckpointStore`` from the reference store's cluster blob
    (``store.cluster.to_json()``), its per-node blobs and alive flags and
    its ``n_replicas``: chunk ids and placement are the same, so the
    port's ``CheckpointManager`` restores what the reference saved.

The language model's weights and caches carry over as trees:

  * ``model_params_from_reference`` takes the reference's ``init_params``
    pytree as nested dicts of NumPy arrays and returns the port's
    parameter tree, key for key, stacked layer axis included;
  * ``model_cache_from_reference`` does the same for an ``init_cache``
    tree (bf16 K / V, int32 positions and per-layer ring indices).

All take plain JSON / NumPy / Python values, so nothing of the reference
is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.cluster import Cluster
from .core.engine import (
    ALGORITHMS,
    BaselineArtifact,
    HierArtifact,
    TableArtifact,
    with_baseline_device_tables,
    with_device_tables,
)
from .core.hierarchy import HierarchicalCluster
from .core.random_slicing import RandomSlicingTable
from .device import resolve_device


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


def baseline_artifact_from_arrays(
    algorithm: str, keys, vals, version: int, device=None
) -> BaselineArtifact:
    """The port's baseline artifact for one version, device tables
    included.  ``keys`` / ``vals`` are the reference artifact's canonical
    arrays: (ring u32, owners i32) for ``ch``, (starts u32, owners i32) for
    ``rs``, (node ids u32, weights f32) for ``wrh``."""
    if algorithm not in ALGORITHMS or algorithm == "asura":
        raise ValueError(f"algorithm must be one of {ALGORITHMS[1:]}, got {algorithm!r}")
    keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint32))
    vals = np.ascontiguousarray(
        np.asarray(vals, dtype=np.float32 if algorithm == "wrh" else np.int32)
    )
    if keys.shape != vals.shape or keys.ndim != 1:
        raise ValueError(f"keys {keys.shape} and vals {vals.shape} must be equal 1-D")
    art = BaselineArtifact(
        algorithm=algorithm,
        version=int(version),
        n_entries=int(keys.shape[0]),
        keys=keys,
        vals=vals,
    )
    return with_baseline_device_tables(art, device)


def rs_table_from_intervals(intervals, weights) -> RandomSlicingTable:
    """A port ``RandomSlicingTable`` equal to the reference table whose
    ``_intervals`` ((start, length, owner) triples) and ``weights`` are
    given; later ``rebalance`` calls continue its slicing exactly."""
    table = RandomSlicingTable()
    table._intervals = sorted((int(s), int(n), int(o)) for s, n, o in intervals)
    if sum(n for _, n, _ in table._intervals) != 1 << 32:
        raise ValueError("the intervals must cover the u32 circle exactly once")
    table.weights = {int(k): float(v) for k, v in weights.items()}
    return table


def hier_cluster_from_reference_json(
    top_blob: str, domain_blobs: dict, *, version: int = 0, device=None
) -> HierarchicalCluster:
    """A port ``HierarchicalCluster`` equal to the reference hierarchy whose
    domain-level cluster wrote ``top_blob`` and whose domains wrote
    ``domain_blobs`` (domain id -> blob); ``version`` is the reference
    hierarchy's ``version``, and ``.engine`` places on ``device``."""
    top = Cluster.from_json(top_blob, device=device)
    h = HierarchicalCluster(params=top.params, device=device)
    h._top = top
    h.domains = {
        int(did): Cluster.from_json(blob, device=device)
        for did, blob in domain_blobs.items()
    }
    h._version = int(version)
    return h


_HIER_DTYPES = (np.uint32, np.int32, np.uint32, np.int32, np.uint32, np.uint32,
                np.int32, np.int32)


def hier_artifact_from_arrays(
    tables, top_level: int, max_top: int, s_pad: int, *, version: int = 0, device=None,
) -> HierArtifact:
    """The port's two-level artifact from a reference artifact's eight
    tables (NumPy arrays in the kernel's operand order: top lengths, top
    slots, stacked lengths, nodes, cumsum halves, per-slot top levels and
    domain ids) and its statics, device tables included."""
    if len(tables) != 8:
        raise ValueError(f"a hierarchical artifact has 8 tables, got {len(tables)}")
    host = [np.array(t, dtype=dt) for t, dt in zip(tables, _HIER_DTYPES)]
    if host[2].shape[0] % s_pad:
        raise ValueError(f"stacked tables of length {host[2].shape[0]} need s_pad | length")
    n_domains = host[2].shape[0] // s_pad
    dev = resolve_device(device)
    return HierArtifact(
        version=int(version),
        n_domains=n_domains,
        top_level=int(top_level),
        max_top=int(max_top),
        s_pad=int(s_pad),
        domain_ids=host[7][:n_domains].astype(np.int64),
        node_domain={},  # the tables carry no node -> domain view
        tables_dev=tuple(torch.from_numpy(a).to(dev) for a in host),
    )


def checkpoint_store_from_reference(
    cluster_blob: str, blobs: dict, n_replicas: int, *, alive=None, device=None,
):
    """A port ``AsuraCheckpointStore`` holding what a reference store
    holds: ``cluster_blob`` is its ``store.cluster.to_json()``, ``blobs``
    maps each node id to that node's ``{chunk key: bytes}``, ``alive``
    (default: every node) maps node ids to their alive flags, and the
    store's engine places on ``device`` (None: the card)."""
    from .checkpoint.sharded import AsuraCheckpointStore, StorageNode

    store = AsuraCheckpointStore({}, n_replicas=n_replicas, device=device)
    store.cluster = Cluster.from_json(cluster_blob, device=device)
    store.engine = store.cluster.engine
    alive = alive or {}
    store.nodes = {
        nid: StorageNode(
            nid, info.capacity, dict(blobs.get(nid, {})), alive=bool(alive.get(nid, True))
        )
        for nid, info in store.cluster.nodes.items()
    }
    return store


def _tensor_from_array(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # a bf16 array reads back as ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree_from_arrays(tree: dict, device) -> dict:
    return {
        key: _tree_from_arrays(leaf, device) if isinstance(leaf, dict)
        else _tensor_from_array(leaf, device)
        for key, leaf in tree.items()
    }


def model_params_from_reference(tree: dict, device=None) -> dict:
    """The port's parameter tree from the reference's (nested dicts of NumPy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``): key for key, same
    shapes (the stacked leading layer axis included) and dtypes (the fp32
    master copy), on ``device`` (None: the card)."""
    return _tree_from_arrays(tree, resolve_device(device))


# The reference's KV cache tree (bf16 ``k`` / ``v``, int32 ``pos``, the
# (L,) int32 ring ``index``) carries across the same way.
model_cache_from_reference = model_params_from_reference


def opt_state_from_reference(tree: dict, device=None) -> dict:
    """The port's AdamW state from the reference's (``{"m", "v", "count"}``
    as NumPy arrays, e.g. ``jax.tree.map(np.asarray, opt_state)``): fp32
    moments key for key, ``count`` an int32 scalar tensor, on ``device``
    (None: the card)."""
    dev = resolve_device(device)
    return {
        "m": _tree_from_arrays(tree["m"], dev),
        "v": _tree_from_arrays(tree["v"], dev),
        "count": _tensor_from_array(np.asarray(tree["count"], dtype=np.int32), dev),
    }
