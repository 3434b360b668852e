"""Device milliseconds a query in the port's span `count.sort_runs`: the
tile sort and the merge ladder (`kernels.bigsort.sort_runs`, one host
call), over the device's stretch's recorded queries; the launch gaps
between its kernels and the device's waits for the host's enqueue
included."""

from benchmark import spans


def read(run):
    return spans.mean_device_ms(run, "count.sort_runs")
