"""ch_fanout_roofline: the fan-out kernel (`replicas_kernel` of
`baselines.cu`) on the CH ring, on the checked call: its least time
(`harness/ring_bounds.py`) over the median launch's device time, in %."""

from chipbench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "FANOUT", "replicas_kernel")
