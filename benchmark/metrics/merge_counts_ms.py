"""Device milliseconds a query in the port's span `count.merge_counts`:
the merge counts over the sorted runs (`kernels.merge_scan.MERGE_COUNTS`),
over the device's stretch's recorded queries; the device's waits for the
host's enqueue included."""

from benchmark import spans


def read(run):
    return spans.mean_device_ms(run, "count.merge_counts")
