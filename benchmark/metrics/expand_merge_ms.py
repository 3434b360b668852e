"""Device milliseconds a query in the port's span `expand.merge`: the probes'
tile sort with their row ids and its merge ladder (#6 and #7,
`kernels.pairsort.sort_multi_i32`), then the merge with the build stream
and its payloads (#7's `merge_sorted_multi_i32`), over the device's
stretch's recorded queries; the launch gaps and the device's waits for the
host's enqueue included."""

from benchmark import expand_spans


def read(run):
    return expand_spans.mean_device_ms(run, "expand.merge")
