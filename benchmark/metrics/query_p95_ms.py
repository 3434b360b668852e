"""The 95th percentile (nearest rank) of the latency of every query of
the window: from the call into the port to the answer on the host."""

import math


def read(run):
    ordered = sorted(run.plain(run.latency_ms))
    return ordered[math.ceil(0.95 * len(ordered)) - 1]
