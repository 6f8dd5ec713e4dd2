"""b4_roofline: kernel B4 (`diff_replicas_kernel`) on the checked scale
event: its least time over that event's launch, in %."""

from chipbench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "B4", "diff_replicas_kernel", per_unit=True)
