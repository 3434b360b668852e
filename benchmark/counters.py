"""The port's counters of a `--trace 1` run, for the `program_counter`
readers: the values that `ccve_tpu_torch.utils.profiler.count` added to
the spans of the device's stretch's recorded queries (`benchmark/spans.py`
takes those queries). A port whose spans carry no counters, or that
records no span of the name, gives nothing to read."""

from __future__ import annotations

from benchmark import spans


def totals(run, span: str, names: tuple) -> list | None:
    """Per recorded query of the device's stretch, the totals of the
    counters `names` over its spans `span` (the root's name for the
    root), as a tuple; None where a query has no such span, or a span of
    the name lacks one of the counters."""
    queries = spans.trace_queries(run)
    if not queries:
        return None
    out = []
    for q in queries:
        found = [getattr(s, "counters", None) for s in q if s.name == span]
        if not found or any(c is None or not set(names) <= set(c) for c in found):
            return None
        out.append(tuple(sum(c[name] for c in found) for name in names))
    return out
