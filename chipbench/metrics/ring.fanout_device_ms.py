"""ring.fanout_device_ms: device ms per call in the program's
`engine.baseline_replicas` span: the baseline fan-out's launch
(`place_replica_nodes_device` under a baseline algorithm)."""

from chipbench.harness.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, "engine.baseline_replicas", "device_s")
