"""Device milliseconds a query in the port's own kernels, from the trace;
the rule is `benchmark.trace.is_own_kernel`."""


def read(run):
    t = run.trace
    return t.own_s * 1e3 / t.queries if t is not None and t.ops else None
