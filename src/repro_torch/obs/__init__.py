"""Two-plane telemetry: the device metrics slab and the host trace ledger."""

from .metrics import MetricsRegistry
from .trace import TraceLedger

__all__ = ["MetricsRegistry", "TraceLedger"]
