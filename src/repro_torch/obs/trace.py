"""Host-plane telemetry: timestamped structured events + counters.

The port's own copy of the reference's ``TraceLedger``: a bounded ring of
structured events (span timings, artifact uploads, LRU evictions) plus a
dict of monotonically-increasing counters.  The engine's ``uploads`` and
the serving driver's ``step_traces`` are ledger counters behind those
attribute names, so the tripwire tests read the same way on both sides.
Events carry a timestamp from an injectable clock and export as JSONL or
Prometheus-style text (optionally merged with a ``MetricsRegistry``'s
drained device totals).  Ledgers are instance-scoped: exact tripwire
counts never alias across objects.

A span is also a profiler range: while a ``torch.profiler`` runs, it
opens a ``record_function`` range of its own name, so its start and end
lie on the profiler's clock beside the kernels it launched.  The port's
layers open ``maybe_span(None, "<layer>.<what>")`` at their boundaries;
with no profiler and no ledger that is one flag check and a shared
no-op context.
"""

from __future__ import annotations

import collections
import contextlib
import json
import re
import time

import numpy as np
from torch.autograd import profiler as _profiler

DEFAULT_CAPACITY = 65536

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")

_NULL = contextlib.nullcontext()


def _range(name: str):
    """A profiler range named ``name`` while a profiler runs, else a no-op
    context (the profiler's own flag, a module global: no call into torch
    when it is off)."""
    return _profiler.record_function(name) if _profiler._is_profiler_enabled else _NULL


def _jsonable(v):
    """Coerce an event field into something json.dumps accepts."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


class TraceLedger:
    """Bounded event ring + counter dict with JSONL/Prometheus export."""

    def __init__(self, *, clock=None, capacity: int = DEFAULT_CAPACITY):
        self._clock = clock if clock is not None else time.perf_counter
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._counters: dict[str, int] = {}

    # -- counters (the tripwire plane) ----------------------------------------

    def incr(self, name: str, n: int = 1) -> int:
        """Bump counter ``name`` by ``n``; returns the new value.  Cheap
        enough for traced-body side effects (fires once per jit TRACE)."""
        self._counters[name] = c = self._counters.get(name, 0) + int(n)
        return c

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    @property
    def counters(self) -> dict[str, int]:
        return dict(self._counters)

    # -- events ----------------------------------------------------------------

    def event(self, kind: str, name: str = "", **fields) -> dict:
        ev = {"ts": float(self._clock()), "kind": str(kind), "name": str(name)}
        for k, v in fields.items():
            ev[str(k)] = _jsonable(v)
        self._events.append(ev)
        return ev

    def events(self, kind: str | None = None) -> list[dict]:
        evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e["kind"] == kind]

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """Time a block; emits one ``kind="span"`` event with ``dur_s`` (and,
        under a running profiler, a range of the same name)."""
        with _range(name):
            t0 = self._clock()
            try:
                yield
            finally:
                self.event("span", name, dur_s=float(self._clock() - t0), **fields)

    def clear(self) -> None:
        self._events.clear()

    # -- exporters --------------------------------------------------------------

    def to_jsonl(self) -> str:
        """One JSON object per line: every buffered event, then one
        ``kind="counters"`` summary line."""
        lines = [json.dumps(e, sort_keys=True) for e in self._events]
        if self._counters:
            lines.append(
                json.dumps(
                    {"kind": "counters", "counters": dict(self._counters)},
                    sort_keys=True,
                )
            )
        return "\n".join(lines) + ("\n" if lines else "")

    def export_jsonl(self, path: str) -> int:
        """Write ``to_jsonl()`` to ``path``; returns the event count."""
        with open(path, "w") as f:
            f.write(self.to_jsonl())
        return len(self._events)

    def prometheus_text(self, registry=None, *, prefix: str = "repro_torch") -> str:
        """Prometheus-style text exposition of the counters (and, given a
        ``MetricsRegistry``, its drained device totals -- call
        ``registry.snapshot()`` first; this reads host totals only)."""

        def metric(name: str) -> str:
            return f"{prefix}_{_PROM_BAD.sub('_', name)}"

        lines: list[str] = []
        for name in sorted(self._counters):
            m = metric(name)
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {self._counters[name]}")
        if registry is not None:
            for name, v in sorted(registry.totals().items()):
                m = metric(name)
                if np.ndim(v) == 0:
                    lines.append(f"# TYPE {m} counter")
                    lines.append(f"{m} {int(v)}")
                else:
                    lines.append(f"# TYPE {m} histogram")
                    for i, c in enumerate(np.asarray(v).tolist()):
                        lines.append(f'{m}_bucket{{bin="{i}"}} {int(c)}')
        return "\n".join(lines) + ("\n" if lines else "")


# -- the process-wide ledger (for module-level call sites) ---------------------

_GLOBAL: TraceLedger | None = None


def get_ledger() -> TraceLedger:
    """The process-wide default ledger (created on first use)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = TraceLedger()
    return _GLOBAL


def set_ledger(ledger: TraceLedger) -> TraceLedger:
    """Swap the process-wide ledger (tests inject a fresh one); returns the
    previous one."""
    global _GLOBAL
    prev = get_ledger()
    _GLOBAL = ledger
    return prev


def maybe_span(ledger, name: str, **fields):
    """``ledger.span`` when a ledger is given, else the profiler's range
    while one runs, else a no-op context."""
    if ledger is None:
        return _range(name)
    return ledger.span(name, **fields)
