"""Two-plane telemetry: the device metrics slab and the host trace ledger."""

from .metrics import MetricsRegistry
from .trace import TraceLedger, get_ledger, maybe_span, set_ledger

__all__ = ["MetricsRegistry", "TraceLedger", "get_ledger", "maybe_span", "set_ledger"]
