"""Request routing and the batched serving driver on the card."""

from .router import ReplicaRouter, Router
from .stream import POLICIES, RequestStreamDriver
from .traffic import LAWS, TrafficModel

__all__ = [
    "LAWS",
    "POLICIES",
    "ReplicaRouter",
    "RequestStreamDriver",
    "Router",
    "TrafficModel",
]
