"""scale.diff_ms: the median host time of a scale event's plan, from the
new table's upload to its moved rows counted on the device
(`plan_replicas_stream` over every tracked id, synchronized): the part of
`plan_ms` after the table build, steadier than the whole event."""

from chipbench.harness.readers import span_ms


def read(run):
    return span_ms(run, "plan")
