"""STEP 1 (cluster / segment table) and STEP 2 host oracles + engine,
and the paper's comparison baselines (consistent hashing, random slicing,
weighted rendezvous hashing, straw buckets), and the failure-domain-aware
two-level cluster."""

from .asura import (
    DEFAULT_PARAMS,
    AsuraParams,
    addition_number,
    addition_numbers_batch,
    align_replica_sets,
    place_batch,
    place_nodes_batch,
    place_replicas_batch,
    place_replicas_scalar,
    place_scalar,
    placement_trace,
    remove_numbers,
    remove_numbers_batch,
    resolve_tail_np,
    tail_cumsum_halves,
)
from .cluster import Cluster, NodeInfo, make_cluster, make_uniform_cluster
from .consistent_hashing import ConsistentHashRing, build_ring, ch_place_np
from .engine import (
    ALGORITHMS,
    BaselineArtifact,
    HierArtifact,
    PlacementEngine,
    TableArtifact,
)
from .hierarchy import HierarchicalCluster
from .random_slicing import RandomSlicingTable, rs_place_np
from .straw import StrawBucket
from .wrh import wrh_place_np

__all__ = [
    "ALGORITHMS",
    "DEFAULT_PARAMS",
    "AsuraParams",
    "BaselineArtifact",
    "Cluster",
    "ConsistentHashRing",
    "HierArtifact",
    "HierarchicalCluster",
    "NodeInfo",
    "PlacementEngine",
    "RandomSlicingTable",
    "StrawBucket",
    "TableArtifact",
    "addition_number",
    "addition_numbers_batch",
    "align_replica_sets",
    "build_ring",
    "ch_place_np",
    "make_cluster",
    "make_uniform_cluster",
    "place_batch",
    "place_nodes_batch",
    "place_replicas_batch",
    "place_replicas_scalar",
    "place_scalar",
    "placement_trace",
    "remove_numbers",
    "remove_numbers_batch",
    "resolve_tail_np",
    "rs_place_np",
    "tail_cumsum_halves",
    "wrh_place_np",
]
