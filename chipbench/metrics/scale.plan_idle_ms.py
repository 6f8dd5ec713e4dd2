"""scale.plan_idle_ms: device idle ms per scale event while the innermost
program span is a `planner.*` span (a fused block's padding, concatenation
and diff launch)."""

from chipbench.harness.spans import idle_ms


def read(run):
    return idle_ms(run, "planner.")
