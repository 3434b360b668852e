"""Device milliseconds a query in the port's span `expand.narrow`: the stats
side's pack of the build keys and of the int64 probe column
(`ops.sort_merge.stats_pack32_streams`) and the probes' row ids, over the
device's stretch's recorded queries; the device's waits for the host's
enqueue included."""

from benchmark import expand_spans


def read(run):
    return expand_spans.mean_device_ms(run, "expand.narrow")
