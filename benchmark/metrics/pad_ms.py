"""Device milliseconds a query in the port's span `count.pad`: the int64
probe stream padded to whole tiles (`ops.sort_merge._padded`) on the
count side's int64 tile route, over the device's stretch's recorded
queries; the device's waits for the host's enqueue included. A port
that pads inside `count.narrow` records no such span: nothing to read."""

from benchmark import spans


def read(run):
    return spans.mean_device_ms(run, "count.pad")
