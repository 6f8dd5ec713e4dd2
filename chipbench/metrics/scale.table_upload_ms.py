"""scale.table_upload_ms: host ms per scale event in the program's
`engine.tables_upload` span: the new table version's device copies
(`with_device_tables`; profiler clock)."""

from chipbench.harness.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, "engine.tables_upload", "host_s")
