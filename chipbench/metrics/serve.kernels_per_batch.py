"""serve.kernels_per_batch: kernels the device ran per served batch in
the traced window."""

from chipbench.harness.readers import kernels_per_unit


def read(run):
    return kernels_per_unit(run, "serve")
