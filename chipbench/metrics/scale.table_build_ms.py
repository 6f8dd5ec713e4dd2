"""scale.table_build_ms: host ms per scale event in the program's
`engine.tables_host` span: the new table version built in NumPy, before
its upload (profiler clock)."""

from chipbench.harness.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, "engine.tables_host", "host_s")
