"""The traced stretches of a `--trace 1` run, reduced to what the per-layer
readers and the `breakdown` need. Both come after the window.

1. The device's stretch: torch.profiler records the device's operations
   alone (no host ops, so that the profiler adds little to the host's
   time) over `trace_queries` queries in a row, and the host clock times
   the stretch from the first query's call to the last one's answer.
   Busy is the union of the operations; idle is the rest of the stretch.
2. The host's stretch: the profiler records the host's ops as well, with
   the harness's own spans (`bench.query`, `bench.entry` around the call
   into the port, `bench.answer_read` around the answer's copy), over a
   few queries. It only names what the host was doing while the device
   sat idle (`breakdown.idle_gaps`); recording every host op slows the
   host, so its idle seconds run longer than the device's stretch's. Its
   first `SKIP` queries, which find the profiler warming up, are left out.

The rule that sorts device operations is frozen here, whatever kernels
the port has: a memcpy or memset is a copy; a kernel whose name holds one
of `LIBRARY_MARKERS` is PyTorch's or a library's it ships; every other
kernel is the port's own.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

LIBRARY_MARKERS = ("at::", "at_cuda_detail", "c10::", "cub::", "thrust::",
                   "cublas", "cudnn", "nccl")
SPAN_PREFIX = "bench."
QUERY, ENTRY, READ = "bench.query", "bench.entry", "bench.answer_read"
SKIP = 2  # queries of the host's stretch left out at its start
TOP = 10  # entries of each breakdown list
NAME_CHARS = 96  # of a kernel's name in the breakdown


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def is_own_kernel(name: str) -> bool:
    return not is_copy(name) and not any(m in name for m in LIBRARY_MARKERS)


@dataclasses.dataclass
class Trace:
    queries: int  # queries of the device's stretch
    busy_s: float  # union of the device's operations over that stretch
    window_s: float  # the stretch, host clock
    ops: int  # device operations: kernels, memcpys and memsets
    own_s: float  # summed durations of the port's own kernels
    other_s: float  # of every other device operation
    device_ops: list  # [[name, seconds]], the TOP operations by total time
    idle_gaps: list  # [[host span/host op, seconds]], the TOP idle totals


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _operations(device: list) -> list:
    # the harness's spans also appear on the device's timeline: no operation
    return [op for op in device if not op[0].startswith(SPAN_PREFIX)]


def _top(totals: dict) -> list:
    return [[k, v * 1e-6] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def reduce(device: list, queries: int, window_s: float, idle_gaps: list) -> Trace:
    """The device's stretch: `device` holds (name, start, end), in
    microseconds, of every device event of `queries` queries that took
    `window_s` seconds."""
    ops = _operations(device)
    totals = defaultdict(float)
    own = other = 0.0
    for name, s, e in ops:
        totals[name[:NAME_CHARS]] += e - s
        if is_own_kernel(name):
            own += e - s
        else:
            other += e - s
    busy = _union([(s, e) for _, s, e in ops])
    return Trace(queries=queries, busy_s=sum(e - s for s, e in busy) * 1e-6,
                 window_s=window_s, ops=len(ops), own_s=own * 1e-6, other_s=other * 1e-6,
                 device_ops=_top(totals), idle_gaps=idle_gaps)


def _top_level(intervals: list) -> list:
    """The intervals (start, end, name) that no other one contains."""
    out = []
    for s, e, name in sorted(intervals, key=lambda x: (x[0], -x[1])):
        if out and s < out[-1][1]:
            continue
        out.append((s, e, name))
    return out


class _Lookup:
    """The name of the interval that holds a time, among disjoint ones."""

    def __init__(self, intervals: list, default: str):
        self.intervals = sorted(intervals)
        self.starts = [s for s, _, _ in self.intervals]
        self.default = default

    def __call__(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.intervals[i][1]:
            return self.intervals[i][2]
        return self.default


def _segments(queries: list, entries: list, reads: list) -> list:
    """The host's harness segments: inside the call, inside the answer
    read, elsewhere in a query; outside a query is the default."""
    out = []
    for (qs, qe), (es, ee), (rs, re_) in zip(queries, entries, reads):
        out += [(qs, es, "query"), (es, ee, "entry"), (ee, rs, "query"),
                (rs, re_, "answer_read"), (re_, qe, "query")]
    return [s for s in out if s[1] > s[0]]


def idle_gaps(device: list, host: list) -> list:
    """The host's stretch: [[segment/host op, seconds]] of the device's
    idle time, by the harness segment and the outermost host op that the
    host was in, the TOP totals. `device` and `host` hold (name, start,
    end) in microseconds on one clock; `host` holds the harness's spans."""
    spans = defaultdict(list)
    host_ops = []
    for name, s, e in host:
        if name.startswith(SPAN_PREFIX):
            spans[name].append((s, e))
        else:
            host_ops.append((s, e, name))
    queries = sorted(spans[QUERY])[SKIP:]
    entries = sorted(spans[ENTRY])[SKIP:]
    reads = sorted(spans[READ])[SKIP:]
    if not queries or not (len(queries) == len(entries) == len(reads)):
        raise ValueError(f"traced spans: {len(queries)} queries, {len(entries)} "
                         f"entries, {len(reads)} answer reads past the first {SKIP}")
    lo, hi = queries[0][0], queries[-1][1]
    busy = _union([(max(s, lo), min(e, hi)) for _, s, e in _operations(device)
                   if e > lo and s < hi])
    segment = _Lookup(_segments(queries, entries, reads), "harness")
    host_op = _Lookup(_top_level(host_ops), "python")
    idle = defaultdict(float)
    gaps, edge = [], lo
    for s, e in busy:
        gaps.append((edge, s))
        edge = e
    gaps.append((edge, hi))
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        steps = max(int(g1 - g0), 1)  # one sample a microsecond
        width = (g1 - g0) / steps
        for k in range(steps):
            t = g0 + (k + 0.5) * width
            idle[f"{segment(t)}/{host_op(t)}"] += width
    return _top(idle)


def profiler(device, host: bool):
    """A torch.profiler over the device (on a GPU), and with `host` over
    the host's ops too."""
    from torch.profiler import ProfilerActivity, profile

    activities = []
    if host or device.type != "cuda":
        activities.append(ProfilerActivity.CPU)
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def events(prof) -> tuple[list, list]:
    """(device, host) events of a finished profiler, as (name, start, end)
    in microseconds."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            device.append(item)
        elif e.device_type == DeviceType.CPU:
            host.append(item)
    return device, host
