"""scale.table_ms: the median host time of a membership change with its
new table version built and uploaded (`add_node` / `remove_node`, then
`PlacementEngine.artifact`)."""

from chipbench.harness.readers import span_ms


def read(run):
    return span_ms(run, "table")
