"""What the per-layer metric readers share: kernel times from the traced
window, a kernel's share of its roofline, the device's idle share and the
median of a host span.  Each returns None when the run holds nothing to
read, and the metric is then left out of the result."""

from __future__ import annotations

import statistics

from chipbench.harness.trace import is_kernel


def kernel_seconds(run, name_part: str) -> list[float]:
    """Device seconds of each launch whose kernel name holds ``name_part``,
    in launch order."""
    if run.profile is None:
        return []
    return [t - s for n, s, t in run.profile.device_ops if name_part in n]


def roofline_pct(run, label: str, name_part: str, per_unit: bool = False):
    """100 x the least time of the checked unit's ``label`` kernel over its
    time on the device: the median launch's, or with ``per_unit`` the
    launch of the checked unit (one launch per unit)."""
    least = run.least.get(label)
    times = kernel_seconds(run, name_part)
    if least is None or not times:
        return None
    if per_unit:
        if len(times) <= run.sampled:
            return None
        spent = times[run.sampled]
    else:
        spent = statistics.median(times)
    return 100.0 * least / spent


def idle_pct(run, kind: str):
    """100 x the share of the traced window in which no operation ran on
    the device, for a cell of driver ``kind``."""
    p = run.profile
    if run.kind != kind or p is None or p.window_s <= 0 or not p.device_ops:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def kernels_per_unit(run, kind: str):
    """Kernel launches per unit (call, batch, event) in the traced window."""
    p = run.profile
    if run.kind != kind or p is None or not p.device_ops:
        return None
    return sum(1 for n, _, _ in p.device_ops if is_kernel(n)) / run.profiled


def span_ms(run, name: str):
    values = run.spans.get(name)
    return 1e3 * statistics.median(values) if values else None
