"""Device milliseconds a query in the port's span `count.narrow`: the
probe column clamped, shifted and cast (`ops.sort_merge._probe_key32` or
`_probe_key64`), the build stream's `| 1`, and the probes padded to whole
tiles (`_padded`), over the device's stretch's recorded queries; the
device's waits for the host's enqueue included."""

from benchmark import spans


def read(run):
    return spans.mean_device_ms(run, "count.narrow")
