"""scale.kernels_per_event: kernels the device ran per planned scale
event in the traced window."""

from chipbench.harness.readers import kernels_per_unit


def read(run):
    return kernels_per_unit(run, "scale")
