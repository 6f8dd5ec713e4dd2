"""The program's own spans in the traced window.

The program opens a profiler range at each of its layers' boundaries,
named ``<layer>.<what>`` (``serve.words``, ``engine.tables_host``,
``planner.block``, ...).  From the raw events of the traced window
(``run.profile._prof.events()``) this keeps the program's ranges on the
harness's thread that lie inside a ``chipbench.unit``, and reads for each
name:

  * its host time, on the profiler's clock;
  * the device time of the operations launched inside it, its children's
    included: each device operation is matched to the runtime call that
    launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...; the same
    correlation id) and counts in every range whose interval holds that
    call.  ``FunctionEvent.device_time_total`` would miss the kernels
    launched through a plain C interface (B2, B4): the profiler links
    those to no host operator;
  * the device's idle time while it is the innermost program span: the
    pieces of its interval that no program span nested in it covers,
    less their overlap with the union of ``run.profile.device_ops``.

The arithmetic is in pure functions over plain tuples (seconds on the
profiler's clock); ``summary`` reads a run once.  A program without such
spans (an older checkout) gives an empty summary, and its readers None.
"""

from __future__ import annotations

import re
import weakref
from bisect import bisect_left, bisect_right

from chipbench.harness.trace import UNIT_SPAN, WINDOW_SPAN

# a program span's name: lower-case words joined by dots, e.g. serve.words
PROGRAM = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)+$")


def is_program(name: str) -> bool:
    return PROGRAM.match(name) is not None and not name.startswith("chipbench.")


# -- pure functions over (name, start_s, end_s[, device_s]) tuples ------------


def in_units(ranges, units) -> list:
    """The ranges that lie inside one of the ``units`` ((start, end) pairs)."""
    units = sorted(units)
    starts = [u[0] for u in units]
    out = []
    for r in ranges:
        i = bisect_left(starts, r[1] + 1e-12) - 1  # the last unit starting at or before r
        if i >= 0 and units[i][0] <= r[1] and r[2] <= units[i][1]:
            out.append(r)
    return out


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def innermost(ranges) -> list[tuple[str, float, float]]:
    """(name, start, end): the pieces of time in which each range is the
    innermost of ``ranges`` (ranges of one thread nest)."""
    out, stack, cursor = [], [], 0.0
    for name, s, t, *_ in sorted(ranges, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][1] <= s:
            top, end = stack.pop()
            out.append((top, cursor, end))
            cursor = end
        if stack:
            out.append((stack[-1][0], cursor, s))
        stack.append((name, t))
        cursor = s
    while stack:
        top, end = stack.pop()
        out.append((top, cursor, end))
        cursor = end
    return [p for p in out if p[2] > p[1]]


def overlap(a: float, b: float, busy) -> float:
    """How much of [a, b] the sorted disjoint intervals ``busy`` cover."""
    i = bisect_left(busy, a, key=lambda iv: iv[1])
    got = 0.0
    while i < len(busy) and busy[i][0] < b:
        s, t = busy[i]
        got += max(0.0, min(b, t) - max(a, s))
        i += 1
    return got


def idle_by_span(ranges, busy) -> dict[str, float]:
    """{name: seconds} of device idle time while ``name`` is the innermost
    range; ``busy`` are the device's (start, end) operation intervals."""
    merged = union(busy)
    out: dict[str, float] = {}
    for name, a, b in innermost(ranges):
        out[name] = out.get(name, 0.0) + (b - a) - overlap(a, b, merged)
    return out


def device_by_span(ranges, launches) -> list:
    """(name, start, end, device_s) for each (name, start, end) range: the
    device seconds of the ``launches`` ((host time of the launch,
    device seconds)) made inside it."""
    launches = sorted(launches)
    times = [t for t, _ in launches]
    cum = [0.0]
    for _, d in launches:
        cum.append(cum[-1] + d)
    return [(name, s, t, cum[bisect_right(times, t)] - cum[bisect_left(times, s)])
            for name, s, t, *_ in ranges]


def totals(ranges) -> dict[str, dict[str, float]]:
    """{name: {"count", "host_s", "device_s"}} over (name, start, end,
    device_s) ranges."""
    out: dict[str, dict[str, float]] = {}
    for name, s, t, dev in ranges:
        d = out.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0})
        d["count"] += 1
        d["host_s"] += t - s
        d["device_s"] += dev
    return out


# -- reading a traced run -------------------------------------------------------


def _is_range(event) -> bool:
    """A device-side copy of a host range, not an operation."""
    return getattr(event, "is_user_annotation", False) or is_program(event.name) \
        or event.name.startswith("chipbench.")


def ranges_of(events) -> tuple[list, list]:
    """(program ranges as (name, start_s, end_s, device_s) inside a unit,
    the units' (start_s, end_s)) from the profiler's events."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async]
    thread = [e for e in cpu if e.name == WINDOW_SPAN][0].thread
    mine = [e for e in cpu if e.thread == thread]
    units = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6)
             for e in mine if e.name == UNIT_SPAN]
    ranges = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
              for e in mine if is_program(e.name)]
    # runtime calls keep the driver's own thread id: any thread's launch counts
    calls = {e.id: e.time_range.start * 1e-6 for e in cpu if e.name.startswith("cu")}
    launches = [(calls[e.id], (e.time_range.end - e.time_range.start) * 1e-6)
                for e in events
                if e.device_type == DeviceType.CUDA and e.id in calls and not _is_range(e)]
    return device_by_span(in_units(ranges, units), launches), units


_SUMMARIES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def summary(run) -> dict[str, dict[str, float]]:
    """{span name: {"count", "host_s", "device_s", "idle_s"}} of the traced
    window's units, totals (not per unit); empty without a profile."""
    p = run.profile
    prof = getattr(p, "_prof", None)
    if prof is None:
        return {}
    if p not in _SUMMARIES:
        ranges, _ = ranges_of(prof.events())
        out = totals(ranges)
        idle = idle_by_span(ranges, [(s, t) for _, s, t in p.device_ops])
        for name, d in out.items():
            d["idle_s"] = idle.get(name, 0.0)
        _SUMMARIES[p] = out
    return _SUMMARIES[p]


def per_unit_ms(run, name: str, field: str):
    """``field`` ("host_s", "device_s") of span ``name`` in ms per profiled
    unit; None without a device trace or without the span."""
    if run.profile is None or not run.profile.device_ops:
        return None
    d = summary(run).get(name)
    return None if d is None else 1e3 * d[field] / run.profiled


def idle_ms(run, prefix: str):
    """Device idle ms per profiled unit while the innermost program span's
    name starts with ``prefix``; None without a device trace or without
    such a span."""
    if run.profile is None or not run.profile.device_ops:
        return None
    found = [d["idle_s"] for name, d in summary(run).items() if name.startswith(prefix)]
    return 1e3 * sum(found) / run.profiled if found else None
