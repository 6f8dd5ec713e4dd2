"""STEP 1 (cluster / segment table) and STEP 2 host oracles + engine,
and the paper's comparison baselines (consistent hashing, random slicing,
weighted rendezvous hashing, straw buckets), and the failure-domain-aware
two-level cluster."""

from .asura import DEFAULT_PARAMS, AsuraParams, place_replicas_scalar, place_scalar
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
    "build_ring",
    "ch_place_np",
    "make_cluster",
    "make_uniform_cluster",
    "place_replicas_scalar",
    "place_scalar",
    "rs_place_np",
    "wrh_place_np",
]
