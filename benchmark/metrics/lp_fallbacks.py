"""Full-width recomputes of the LP ladder a query, after a stage's
survivors overflowed its width: the counter `fallbacks` of the port's
root span `bulk.count`, averaged over the device's stretch's recorded
queries."""

from benchmark import counters, spans


def read(run):
    found = counters.totals(run, spans.ROOT, ("fallbacks",))
    return sum(f for (f,) in found) / len(found) if found else None
