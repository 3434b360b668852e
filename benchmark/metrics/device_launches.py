"""Device operations (kernels, memcpys, memsets) a query, from the trace."""


def read(run):
    t = run.trace
    return t.ops / t.queries if t is not None and t.ops else None
