"""serve.enqueue_ms: the median host time of one `route_batch` call, from
its issue to its return and before any synchronize (selection words,
replica kernel, selection and count, all enqueued)."""

from chipbench.harness.readers import span_ms


def read(run):
    return span_ms(run, "route_batch")
