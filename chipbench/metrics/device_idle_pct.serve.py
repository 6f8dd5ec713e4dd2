"""device_idle_pct.serve: the share of the traced window of a serve cell in
which no operation ran on the device, in %."""

from chipbench.harness.readers import idle_pct


def read(run):
    return idle_pct(run, "serve")
