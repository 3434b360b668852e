"""Profiling suite: the reference's profilers, for the port.

Port of `ccve_tpu.utils.profiler` (host code, copied: the port imports
nothing of the JAX package). The reference instruments with
(profiler.h:28-290):
 (a) `BaseProfiler`: a wall-clock stopwatch (`Timer`);
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
"""

from __future__ import annotations

import csv
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field


class Timer:
    """BaseProfiler (profiler.h:28-57): a simple stopwatch."""

    def __init__(self):
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0


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
