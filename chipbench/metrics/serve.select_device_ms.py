"""serve.select_device_ms: device ms per served batch in the program's
`serve.select` span: the replica choice (`select_replica`, pow2 against
the start-of-batch counts), B2's launch left out."""

from chipbench.harness.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, "serve.select", "device_s")
