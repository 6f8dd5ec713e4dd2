"""serve.dispatch_idle_ms: device idle ms per served batch while the
innermost program span is a `serve.*` span (`serve.route_batch` and the
spans in it): the time the device waits on the serving driver's host
dispatch."""

from chipbench.harness.spans import idle_ms


def read(run):
    return idle_ms(run, "serve.")
