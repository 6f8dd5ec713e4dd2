"""The consumers of placement: elastic membership changes, failure
detection and repair, straggler backups and the durability simulator."""

from .durability import (
    DurabilityReport,
    DurabilitySimulator,
    FailureEvent,
    compare_policies,
    failure_trace,
    movement_on_node_add,
)
from .elastic import ElasticCoordinator, MovePlan
from .failures import FailureDetector, HeartbeatTracker, MigrationDriver
from .straggler import StragglerMitigator

__all__ = [
    "DurabilityReport",
    "DurabilitySimulator",
    "ElasticCoordinator",
    "FailureDetector",
    "FailureEvent",
    "HeartbeatTracker",
    "MigrationDriver",
    "MovePlan",
    "StragglerMitigator",
    "compare_policies",
    "failure_trace",
    "movement_on_node_add",
]
