"""Profiling suite: the reference's profilers, for the port, and the
port's spans.

Port of `ccve_tpu.utils.profiler` (host code, copied: the port imports
nothing of the JAX package). The reference instruments with
(profiler.h:28-290):
 (a) `BaseProfiler`: a wall-clock stopwatch; not ported, since nothing of
     the port reads one (the JAX package keeps its `Timer`);
 (b) `BeeProfiler`: named accumulators (total time and call count), printed
     sorted at exit;
 (c) `ZebraProfiler`: latency histograms keyed by chunk size, the tool that
     shows that small chunks are slow;
 (d) `CycleProfiler`: `__rdtsc` deltas in 4 fixed phase slots (hash, match,
     gather, advance).

Here Bee times at host granularity (around work that ends in a device
sync), Zebra keys its histograms by chunk occupancy (the live-row count the
executor records per emitted chunk, 0..block), and Cycle becomes
`PhaseProfiler`: four named phases timed per call, with the bytes each
moved.

`Spans` is the port's own: the steps of a query, each timed on the host's
clock and, on a GPU, on the device's (see `span`), with the counts the
steps make (see `count`).
"""

from __future__ import annotations

import csv
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _torch_profiler


@dataclass
class _Stat:
    total_s: float = 0.0
    calls: int = 0


class BeeProfiler:
    """Named wall-time accumulators (profiler.h:61-167)."""

    _instance: "BeeProfiler | None" = None
    enabled: bool = True

    def __init__(self):
        self._stats: dict[str, _Stat] = defaultdict(_Stat)

    @classmethod
    def get(cls) -> "BeeProfiler":
        if cls._instance is None:
            cls._instance = BeeProfiler()
        return cls._instance

    def insert_stat_record(self, name: str, seconds: float) -> None:
        if not self.enabled:
            return
        s = self._stats[name]
        s.total_s += seconds
        s.calls += 1

    def time(self, name: str):
        """Context manager: with profiler.time('[Probe]'): ..."""
        return _BeeScope(self, name)

    def end_profiling(self, stream=None) -> None:
        """Print the stats table sorted by name (profiler.h:103-127)."""
        import sys

        stream = stream or sys.stderr
        if not self._stats:
            return
        width = max(len(k) for k in self._stats)
        for name in sorted(self._stats):
            s = self._stats[name]
            avg = s.total_s / max(s.calls, 1)
            print(
                f" [Bee] {name.ljust(width)}  total {s.total_s * 1e3:12.3f} ms"
                f"  calls {s.calls:10d}  avg {avg * 1e6:10.3f} us",
                file=stream,
            )

    def clear(self) -> None:
        self._stats.clear()

    def stats(self) -> dict[str, tuple[float, int]]:
        return {k: (v.total_s, v.calls) for k, v in self._stats.items()}


class _BeeScope:
    def __init__(self, profiler: BeeProfiler, name: str):
        self._p, self._name = profiler, name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._p.insert_stat_record(self._name, time.perf_counter() - self._t0)
        return False


class ZebraProfiler:
    """Per-(name, occupancy) latency histograms (profiler.h:170-260).
    Keyed by live-row count in 0..block_size; `to_csv` writes one file per
    name with (occupancy, total_seconds, calls) rows."""

    _instance: "ZebraProfiler | None" = None
    enabled: bool = True

    def __init__(self):
        # name -> occupancy -> [total_s, calls]
        self._hists: dict[str, dict[int, list]] = defaultdict(
            lambda: defaultdict(lambda: [0.0, 0])
        )

    @classmethod
    def get(cls) -> "ZebraProfiler":
        if cls._instance is None:
            cls._instance = ZebraProfiler()
        return cls._instance

    def insert_record(self, name: str, occupancy: int, seconds: float) -> None:
        if not self.enabled:
            return
        cell = self._hists[name][int(occupancy)]
        cell[0] += seconds
        cell[1] += 1

    def to_csv(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        for name, hist in self._hists.items():
            safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in name)
            with open(os.path.join(directory, f"{safe}.csv"), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["occupancy", "total_seconds", "calls"])
                for occ in sorted(hist):
                    total_s, calls = hist[occ]
                    w.writerow([occ, repr(total_s), calls])

    def clear(self) -> None:
        self._hists.clear()

    def histogram(self, name: str) -> dict[int, tuple[float, int]]:
        return {k: tuple(v) for k, v in self._hists[name].items()}


@dataclass
class PhaseStats:
    seconds: float = 0.0
    items: int = 0
    bytes_accessed: int = 0

    @property
    def ns_per_item(self) -> float:
        return self.seconds * 1e9 / max(self.items, 1)

    @property
    def gb_per_s(self) -> float:
        return self.bytes_accessed / max(self.seconds, 1e-12) / 1e9


class PhaseProfiler:
    """CycleProfiler (profiler.h:264-290) re-thought: 4 named phases —
    hash / match / gather / advance — timed at dispatch granularity with
    roofline byte accounting instead of rdtsc cycles."""

    PHASES = ("hash", "match", "gather", "advance")

    def __init__(self):
        self._stats: dict[str, PhaseStats] = {p: PhaseStats() for p in self.PHASES}

    def record(self, phase: str, seconds: float, items: int, nbytes: int = 0):
        s = self._stats[phase]
        s.seconds += seconds
        s.items += items
        s.bytes_accessed += nbytes

    def clear(self) -> None:
        for s in self._stats.values():
            s.seconds, s.items, s.bytes_accessed = 0.0, 0, 0

    def stats(self) -> dict[str, PhaseStats]:
        return dict(self._stats)

    def report(self, total_items: int | None = None) -> str:
        lines = []
        total = 0.0
        for p in self.PHASES:
            s = self._stats[p]
            total += s.seconds
            lines.append(
                f" [Phase] {p:8s} {s.seconds * 1e3:10.3f} ms"
                f"  {s.ns_per_item:8.3f} ns/item  {s.gb_per_s:8.2f} GB/s"
            )
        if total_items:
            lines.append(
                f" [Phase] {'total':8s} {total * 1e3:10.3f} ms"
                f"  {total * 1e9 / total_items:8.3f} ns/item"
            )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Spans: the steps of a query, on the host's clock and the device's
# ---------------------------------------------------------------------------

_recording = 0  # open `Spans.recording()` blocks


class _Off:
    """The span of a recorder that is off: one shared object that does
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _Off()


def span(name: str, device=None, follows: bool = False):
    """A context manager that records one step of a query as a span. A
    span opened with `device` while no span is open is a query's root; a
    span opened inside a root is its child; any other span is not
    recorded (a step called on its own).

    The recorder is on inside `Spans.recording()`, where it records every
    query, and while a torch.profiler session records, where it records
    one query in `Spans.EVERY` (the rest open no span), so that its own
    cost reaches a profiled stretch's readings a share that small. Off,
    this checks the two flags and returns `NO_SPAN`, with no allocation,
    clock read or CUDA call.

    On, a span keeps its host start and end (`time.perf_counter_ns`): a
    child's cover the recorder's own work for it, a root's leave its own
    out, so that a root less its children (`self_host_ms`) is the call's
    work alone. Where the root's device is a GPU, a child also records a
    device start and end: CUDA events on the stream current at the root's
    entry, at the child's entry and exit, from a pool. `follows` says
    that nothing was enqueued since the query's previous stamp (the
    previous sibling's exit, say): the span then starts at that stamp
    instead of recording its own. A root records no stamp: its device
    interval runs from its first child's start to its last child's end
    (a root without children has none). A device interval, read by
    `Spans.snapshot`, is the stretch of that stream's timeline from the
    start to the end: the span's work, and any wait of the device for its
    host enqueue, the event records' own included. A span never becomes a
    profiler annotation or an NVTX range, so a trace's device operations
    stay the program's."""
    if not (_recording or _torch_profiler._is_profiler_enabled):
        return NO_SPAN
    return _RECORDER._open(name, device, follows)


def count(name: str, value) -> None:
    """Adds `value` to the counter `name` of the innermost recorded span
    of the open query; outside a recorded query, nothing. `value` is a
    Python int or a 0-d device tensor: the tensor is kept as it is and
    read into an int by `Spans.snapshot`, after the device stamps it
    already waits on, so counting adds no host read to the query. Off,
    this checks the same two flags as `span`, with no allocation or CUDA
    call."""
    if not (_recording or _torch_profiler._is_profiler_enabled):
        return
    _RECORDER._count(name, value)


@dataclass(frozen=True)
class SpanRecord:
    """One recorded span, as `Spans.snapshot` returns it."""

    name: str
    id: int  # unique in the recorder
    parent: int | None  # the enclosing span's id; None for a root
    query: int  # the root's: the roots the recorder had opened before it
    host_ns: tuple  # (start, end), time.perf_counter_ns
    device_ms: tuple | None  # (start, end), ms after the root's device start
    counters: dict = field(default_factory=dict, hash=False)  # name -> int (`count`)

    @property
    def host_ms(self) -> float:
        return (self.host_ns[1] - self.host_ns[0]) * 1e-6

    @property
    def device_interval_ms(self) -> float | None:
        return None if self.device_ms is None else self.device_ms[1] - self.device_ms[0]


def self_host_ms(query: list) -> float:
    """The host ms of a query's root outside its direct children."""
    root = query[0]
    return root.host_ms - sum(s.host_ms for s in query if s.parent == root.id)


class _Span:
    """An open span of a recorder that is on."""

    __slots__ = ("root", "parent", "name", "follows", "t0", "t1", "ev0", "ev1", "spans",
                 "last", "stream", "query", "counters")

    def __enter__(self):
        root = self.root
        _RECORDER._stack.append(self)
        if root is self:
            self.t0 = _now()
        elif root.stream is not None:
            if self.follows and root.last is not None:
                self.ev0 = root.last
            else:
                self.ev0 = root.last = _RECORDER._event()
                self.ev0.record(root.stream)
                if root.ev0 is None:
                    root.ev0 = self.ev0
        return self

    def __exit__(self, *exc):
        root = self.root
        if root is self:
            self.t1 = _now()
            self.ev1 = self.last
        elif root.stream is not None:
            self.ev1 = root.last = _RECORDER._event()
            self.ev1.record(root.stream)
        _RECORDER._stack.pop()
        if root is self:
            _RECORDER._pending.append(self.spans)
            if self.stream is not None:
                _RECORDER._top_up()
        else:
            self.t1 = _now()
        return False


class _Unrecorded:
    """The root of a query that the recorder leaves out (past the store's
    cap, or between the queries it samples): its spans are not recorded
    either."""

    __slots__ = ()

    def __enter__(self):
        _RECORDER._stack.append(None)
        return self

    def __exit__(self, *exc):
        _RECORDER._stack.pop()
        return False


class Spans:
    """The span recorder (see `span`): the queries recorded in order, up
    to `CAP`, each a root and its children. `queries` counts the roots
    opened while it was on, recorded or not, and `dropped` those past the
    cap. One thread opens spans at a time."""

    CAP = 4096
    EVERY = 8  # under a torch.profiler session alone, one query recorded in EVERY
    POOL = 16  # events made at a root's exit when fewer are free

    def __init__(self):
        self._stack: list = []  # open spans, root first; None in a query not recorded
        self._pending: list = []  # closed queries whose device stamps are unread
        self._done: list = []  # closed queries as lists of SpanRecord
        self._pool: list = []  # CUDA events free for reuse
        self._streams: dict = {}  # (device index, raw stream) -> torch.cuda.Stream
        self._ids = 0  # span ids given so far
        self.queries = 0
        self.dropped = 0

    @classmethod
    def get(cls) -> "Spans":
        return _RECORDER

    @staticmethod
    @contextmanager
    def recording():
        """Turns the recorder on inside the block, for every query."""
        global _recording
        _recording += 1
        try:
            yield _RECORDER
        finally:
            _recording -= 1

    def _event(self):
        return self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)

    def _top_up(self) -> None:
        """Makes POOL events when fewer are free: at a root's exit, while
        the device still runs the query's tail, rather than at the next
        query's first stamps, where the device waits on the host."""
        if len(self._pool) < self.POOL:
            self._pool += [torch.cuda.Event(enable_timing=True) for _ in range(self.POOL)]

    def _stream(self, device: torch.device):
        """The current stream of `device`, its Stream object made once."""
        index = device.index if device.index is not None else torch.cuda.current_device()
        key = (index, torch._C._cuda_getCurrentRawStream(index))
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.current_stream(index)
        return stream

    def _open(self, name: str, device, follows: bool):
        t0 = _now()
        stack = self._stack
        if stack:
            root = stack[0]
            if root is None:
                return NO_SPAN
            s = _Span()
            s.parent = stack[-1]
            root.spans.append(s)
        elif device is None:
            return NO_SPAN
        else:
            query = self.queries
            self.queries += 1
            if len(self._pending) + len(self._done) >= self.CAP:
                self.dropped += 1
                return _UNRECORDED
            # sampled mid-way through each EVERY: a session's first query
            # finds the profiler starting up
            if not _recording and query % self.EVERY != self.EVERY // 2:
                return _UNRECORDED
            if not isinstance(device, torch.device):
                device = torch.device(device)
            s = _Span()
            root = s.parent = None
            s.spans, s.last, s.query = [s], None, query
            s.stream = self._stream(device) if device.type == "cuda" else None
        s.root = root or s
        s.name, s.follows, s.t0, s.ev0, s.ev1 = name, follows, t0, None, None
        s.counters = None
        return s

    def _count(self, name: str, value) -> None:
        stack = self._stack
        if not stack or stack[0] is None:
            return
        s = stack[-1]
        if s.counters is None:
            s.counters = {}
        s.counters.setdefault(name, []).append(value)

    def _free(self, spans: list) -> None:
        """Returns a query's events to the pool, each once (a span that
        follows shares its start)."""
        events = {id(e): e for s in spans for e in (s.ev0, s.ev1) if e is not None}
        self._pool += events.values()

    def snapshot(self) -> list:
        """The recorded queries in order, each a list of its SpanRecords
        in the order they opened, root first. Reads the device stamps of
        the queries closed since the last call (waiting for the device to
        pass them), sums each span's counted values into ints, and returns
        their events to the pool."""
        for spans in self._pending:
            root = spans[0]
            if root.ev0 is not None:
                root.ev1.synchronize()
            ids = {id(s): self._ids + k for k, s in enumerate(spans)}
            self._ids += len(spans)
            records = []
            for s in spans:
                device_ms = None
                if s.ev1 is not None:
                    device_ms = (root.ev0.elapsed_time(s.ev0), root.ev0.elapsed_time(s.ev1))
                parent = None if s.parent is None else ids[id(s.parent)]
                counters = {k: sum(int(v) for v in values)
                            for k, values in (s.counters or {}).items()}
                records.append(SpanRecord(s.name, ids[id(s)], parent, root.query, (s.t0, s.t1),
                                          device_ms, counters))
            self._free(spans)
            self._done.append(records)
        self._pending.clear()
        return list(self._done)

    def clear(self) -> None:
        """Forgets every recorded query and both counts."""
        for spans in self._pending:
            self._free(spans)
        self._pending.clear()
        self._done.clear()
        self.queries = self.dropped = 0


_now = time.perf_counter_ns
_UNRECORDED = _Unrecorded()
_RECORDER = Spans()  # the one recorder: it holds no CUDA state until a root needs it
