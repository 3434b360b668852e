"""The port's spans of a `--trace 1` run whose queries are
`bulk_materialize` calls, for the expansion's `program_span` readers.

`benchmark/spans.py`'s reduction for the root `bulk.materialize`: the
recorded queries whose ids fall in the device's stretch (`Run.phase`),
taken once a run and cleared from the recorder. A port that records no
such root gives nothing to read.
"""

from __future__ import annotations

ROOT = "bulk.materialize"


def trace_queries(run) -> list | None:
    """The device's stretch's recorded queries, each a list of spans with
    the root first, or None where the recorder has none to line up with
    `run.phase`. The first call for a run takes the recorder's queries and
    clears it."""
    cached = getattr(run, "_expand_span_queries", False)
    if cached is not False:
        return cached
    try:
        from ccve_tpu_torch.utils.profiler import Spans
    except ImportError:
        return None
    rec = Spans.get()
    recorded = rec.snapshot()
    opened, dropped = rec.queries, rec.dropped
    rec.clear()
    n_trace, n_spans = run.phase.count("trace"), run.phase.count("spans")
    first = opened - n_trace - n_spans  # the device's stretch's first root
    found = None
    if n_trace and not dropped and first >= 0:
        found = [q for q in recorded
                 if q[0].name == ROOT and first <= q[0].query < first + n_trace] or None
    run._expand_span_queries = found
    return found


def mean_device_ms(run, name: str) -> float | None:
    """The mean over the device's stretch's recorded queries of the device
    intervals of the spans `name` in a query, summed; None on a CPU, or
    where a query has no such span."""
    queries = trace_queries(run)
    if not queries:
        return None
    total = 0.0
    for q in queries:
        ms = [s.device_interval_ms for s in q if s.name == name]
        if not ms or None in ms:
            return None
        total += sum(ms)
    return total / len(queries)
