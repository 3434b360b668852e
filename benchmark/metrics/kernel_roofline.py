"""The query's least bytes at the card's peak bandwidth, as a share (%)
of the device's busy time a query in the trace."""


def read(run):
    t = run.trace
    if t is None or not t.busy_s or run.peak_bytes_per_s is None:
        return None
    return 100 * run.least_bytes / run.peak_bytes_per_s / (t.busy_s / t.queries)
