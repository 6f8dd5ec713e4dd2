"""device_idle_pct.bulk: the share of the traced window of a bulk cell in
which no operation ran on the device, in %."""

from chipbench.harness.readers import idle_pct


def read(run):
    return idle_pct(run, "bulk")
