"""scale.table_idle_ms: device idle ms per scale event while the innermost
program span is an `engine.*` span (the artifact build: the host's table
build and its upload)."""

from chipbench.harness.spans import idle_ms


def read(run):
    return idle_ms(run, "engine.")
