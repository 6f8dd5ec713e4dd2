"""device_idle_pct.scale: the share of the traced window of a scale cell in
which no operation ran on the device, in %."""

from chipbench.harness.readers import idle_pct


def read(run):
    return idle_pct(run, "scale")
