"""scale.align_device_ms: device ms per scale event in the program's
`ops.align_replica_sets` span: the per-slot alignment of the before and
after replica sets of every tracked id."""

from chipbench.harness.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, "ops.align_replica_sets", "device_s")
