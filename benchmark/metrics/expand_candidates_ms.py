"""Device milliseconds a query in the port's span `expand.candidates`: the
merged stream's run starts, the copy-last scans of the builds' payloads to
their probes and the candidate planes' `stack`
(`ops.sort_merge.expand_candidates`), over the device's stretch's
recorded queries; the device's waits for the host's enqueue included."""

from benchmark import expand_spans


def read(run):
    return expand_spans.mean_device_ms(run, "expand.candidates")
