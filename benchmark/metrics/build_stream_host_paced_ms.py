"""Milliseconds a query of the stream's timeline in the port's span
`count.build_stream`: the build keys shifted (`ops.sort_merge._build_key32`
or `_build_key64`), over the device's stretch's recorded queries. The
card runs these passes in a few microseconds each and then waits for the
host to enqueue the next, so the host paces this interval: it holds the
host's enqueue of the passes and part of the two event records that bound
the span, more than the passes' device work."""

from benchmark import spans


def read(run):
    return spans.mean_device_ms(run, "count.build_stream")
