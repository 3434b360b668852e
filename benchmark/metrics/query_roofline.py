"""The query's least bytes at the card's peak bandwidth, as a share (%)
of the mean query latency of the trace run's queries that ran neither
under the profiler nor under the sync count."""


def read(run):
    values = run.plain(run.latency_ms)
    if not values or run.peak_bytes_per_s is None:
        return None
    mean_s = sum(values) / len(values) * 1e-3
    return 100 * run.least_bytes / run.peak_bytes_per_s / mean_s
