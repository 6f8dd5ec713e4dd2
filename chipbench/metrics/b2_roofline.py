"""b2_roofline: kernel B2 (`place_replicas_kernel`) on the checked call:
its least time over the median launch's device time, in %."""

from chipbench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "B2", "place_replicas_kernel")
