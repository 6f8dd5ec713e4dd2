"""serve.count_device_ms: device ms per served batch in the program's
`serve.count` span: the histogram of the chosen nodes, the counts, the
queue and its history ring."""

from chipbench.harness.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, "serve.count", "device_s")
