"""STEP 1 (cluster / segment table) and STEP 2 host oracles + engine."""

from .asura import DEFAULT_PARAMS, AsuraParams, place_replicas_scalar, place_scalar
from .cluster import Cluster, NodeInfo, make_cluster, make_uniform_cluster
from .engine import PlacementEngine, TableArtifact

__all__ = [
    "DEFAULT_PARAMS",
    "AsuraParams",
    "Cluster",
    "NodeInfo",
    "PlacementEngine",
    "TableArtifact",
    "make_cluster",
    "make_uniform_cluster",
    "place_replicas_scalar",
    "place_scalar",
]
