"""Mean host milliseconds a query in the port's root span
`bulk.materialize` outside its child spans (`utils.profiler.self_host_ms`),
over the device's stretch's recorded queries: the call's own work around
the expansion's steps (the probe batch's cast, the first level's gather
of its column). The recorder's own work for the spans falls in the
children's host intervals and its root's bookkeeping outside the root's,
so none of it is read here."""

from benchmark import expand_spans


def read(run):
    queries = expand_spans.trace_queries(run)
    if not queries:
        return None
    from ccve_tpu_torch.utils.profiler import self_host_ms

    return sum(self_host_ms(q) for q in queries) / len(queries)
