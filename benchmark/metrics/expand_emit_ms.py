"""Device milliseconds a query in the port's spans `expand.emit`, summed: the
triples widened and fitted (`ops.sort_merge._fit`), then in
`exec.bulk.bulk_materialize` the host's read of the match count, the
slices, the gathers and the concatenations of the output, over the
device's stretch's recorded queries; the device's waits for the host
included."""

from benchmark import expand_spans


def read(run):
    return expand_spans.mean_device_ms(run, "expand.emit")
