"""Device milliseconds a query in the port's span `expand.compact`: the
candidates' compaction (#9, `kernels.compact.compact_i32`), over the
device's stretch's recorded queries; the device's waits for the host's
enqueue included."""

from benchmark import expand_spans


def read(run):
    return expand_spans.mean_device_ms(run, "expand.compact")
