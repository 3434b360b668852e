"""Mean host milliseconds inside the call into the port (before the answer
read), over the trace run's queries that ran neither under the profiler
nor under the sync count."""


def read(run):
    values = run.plain(run.entry_ms)
    return sum(values) / len(values) if values else None
