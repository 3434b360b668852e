"""Device milliseconds a query in operations that are not the port's own
kernels (PyTorch's and its libraries' kernels, memcpys, memsets), from the
trace; the rule is `benchmark.trace.is_own_kernel`."""


def read(run):
    t = run.trace
    return t.other_s * 1e3 / t.queries if t is not None and t.ops else None
