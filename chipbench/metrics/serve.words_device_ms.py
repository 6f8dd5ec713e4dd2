"""serve.words_device_ms: device ms per served batch in the program's
`serve.words` span: the selection words (`TrafficModel.lane_words`,
int64 Threefry) and their kernels."""

from chipbench.harness.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, "serve.words", "device_s")
