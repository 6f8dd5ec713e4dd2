"""The traced run: a ``torch.profiler`` window and what is read from it.

``Profile`` wraps the profiler around the first units of a run (each unit
inside a ``chipbench.unit`` span) and reduces its events to what the
metric readers need: the device operations (kernels, copies, sets) in
order with their times; the window, from the first unit's start to the
synchronize after the last; the time in which some operation ran on the
device (the union of their intervals); and the device's idle gaps,
labelled by what the host was doing: the innermost host event of the
harness's thread that covers the gap's middle.  The profiler's own start
lies before the first unit and is not in the window.
"""

from __future__ import annotations

from bisect import bisect_right

import torch

WINDOW_SPAN = "chipbench.window"
UNIT_SPAN = "chipbench.unit"


class Profile:
    """Profile a block: ``with Profile(dev) as p: ...`` with each unit in
    ``with p.unit(): ...``; then read ``p.device_ops``, ``p.window_s``,
    ``p.busy_s`` and ``p.gaps``."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.device_ops: list[tuple[str, float, float]] = []  # (name, start_s, end_s)
        self.gaps: list[tuple[str, float]] = []
        self.window_s = 0.0
        self.busy_s = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.dev)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        return self

    def unit(self):
        from torch.profiler import record_function

        return record_function(UNIT_SPAN)

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce(self._prof.events())
        return False

    def _reduce(self, events) -> None:
        from torch.autograd import DeviceType

        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        window = [e for e in cpu if e.name == WINDOW_SPAN][0]
        thread = window.thread
        units = [e.time_range.start for e in cpu if e.name == UNIT_SPAN and e.thread == thread]
        w0 = min(units) if units else window.time_range.start
        w1 = window.time_range.end
        dev_ops, host = [], []
        for e in events:
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                mine = e.name.startswith("chipbench.") or getattr(e, "is_user_annotation", False)
                if not mine and tr.end > w0 and tr.start < w1 and tr.end > tr.start:
                    dev_ops.append((e.name, tr.start, tr.end))
            elif e.device_type == DeviceType.CPU and e.thread == thread and not e.is_async \
                    and e.name != WINDOW_SPAN:
                host.append((tr.start, tr.end, e.name))
        dev_ops.sort(key=lambda o: o[1])
        self.window_s = (w1 - w0) * 1e-6
        # the operations the window's units issued; one of the primer's
        # still running at the start counts as busy time only
        self.device_ops = [(n, s * 1e-6, t * 1e-6) for n, s, t in dev_ops if s >= w0]
        busy, gaps, edge = 0.0, [], w0
        for _, s, t in dev_ops:
            s, t = max(s, w0), min(t, w1)
            if s > edge:
                gaps.append((edge, s))
            if t > edge:
                busy += t - max(s, edge)
                edge = t
        if w1 > edge:
            gaps.append((edge, w1))
        self.busy_s = busy * 1e-6
        self.gaps = _label(gaps, host)


def _label(gaps, host) -> list[tuple[str, float]]:
    """(what the host was doing, seconds) per gap: the innermost host event
    covering the gap's middle, or "host, outside any op"."""
    host.sort()
    starts = [h[0] for h in host]
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect_right(starts, mid)
        name = "host, outside any op"
        # nested events on one thread: the latest start that still covers mid
        for j in range(i - 1, max(-1, i - 4096), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out.append((name, (b - a) * 1e-6))
    return out


def top(pairs, n: int = 10) -> list[list]:
    """The ``n`` names with the most seconds in (name, seconds) pairs."""
    total: dict[str, float] = {}
    for name, sec in pairs:
        total[name] = total.get(name, 0.0) + sec
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))


def warm_profiler(dev: torch.device) -> None:
    """Start and stop the profiler once, so that a traced window does not
    pay the profiler's own first start."""
    with Profile(dev) as p, p.unit():
        torch.zeros(1, device=dev).add_(1)
