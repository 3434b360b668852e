"""A kernel call's time on the host and on the device, beside the library
call that computes the same function, on the card.

Run from the repository root on a machine with a CUDA GPU:

    python -m ccve_tpu_torch.bench.kernel_split

For #11 (`chunk_rank`, one 2048-lane chunk against config 3's 50,000-row
table) and #4 (`merge_scan_build_counts`, config 1's 1M-row table against
its first 8192 probes, as the small-probe route calls it), and for each
one's library yardstick (two `torch.searchsorted`; two `torch.searchsorted`
and a subtraction), it prints one `SPLIT` line of `split`'s readings, in
turns kernel, library, library, kernel:

- `call_ms`: CUDA events around one eager call, median (min, max) of
  2 * REPS calls: what a caller pays, the larger of the host's enqueue
  and the device's work;
- `chain_ms`: CUDA events around CHAIN back-to-back calls, over CHAIN;
- `host_us`: the host clock around the same CHAIN calls without a
  synchronize, over CHAIN: the enqueue alone;
- `device_us`: torch.profiler's device events over TRACE_CALLS calls: the
  sum of their durations a call, the events a call, each kernel's
  (memsets among them) and the device's busy time a call (the union of
  the events; `device_split`, which bench/small_probe.py also reads). On
  the H100 machine the profiler drops device events in some windows (seen:
  8 of 20 calls' kernels, or all of them, and in a long process most
  windows), so TRACE_WINDOWS windows are read: a kernel's launches a call
  are the most any window saw, rounded up to a whole number a call, and
  its time a launch the mean over every event recorded; `complete` counts
  the windows that lost nothing;
- `allocs`: the caching allocator's allocation requests a call.

Both kernels' results are checked against their plain versions first. It
imports only what earlier versions of these two kernels also had, so the
same script reads a parent tree (copied into it) and the change back to
back on one card.
"""

from __future__ import annotations

import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from ccve_tpu_torch.bench.configs import config1_host
from ccve_tpu_torch.bench.profile_config1 import busy_window
from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table
from ccve_tpu_torch.kernels import bigsort, merge_scan
from ccve_tpu_torch.kernels.chunk_probe import chunk_rank, chunk_rank_plain
from ccve_tpu_torch.ops import sort_merge as sm

REPS = 10
CHAIN = 100
TRACE_CALLS = 20
TRACE_WINDOWS = 6
PAD_S = 0.005  # host idle at both ends of a window, so that no device event lies at its edge


def _event_ms(fn, calls: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / calls


def _window(fn, calls: int) -> tuple[dict, dict, float]:
    """({kernel: events}, {kernel: us a call}, busy us a call) of one
    profiler window over `calls` back-to-back calls of `fn`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    counts, us = defaultdict(int), defaultdict(float)
    for e in events:
        counts[e.name[:48]] += 1
        us[e.name[:48]] += (e.time_range.end - e.time_range.start) / calls
    busy, _ = busy_window([(e.time_range.start, e.time_range.end) for e in events])
    return dict(counts), dict(us), busy / calls


def device_split(fn, calls: int = TRACE_CALLS) -> dict:
    """{us, busy, events, kernels: {name: us}, complete}, a call, of
    `fn`'s device events under torch.profiler over TRACE_WINDOWS windows
    (see the module docstring); raises if no window saw any."""
    fn()
    torch.cuda.synchronize()
    windows = [_window(fn, calls) for _ in range(TRACE_WINDOWS)]
    most, total, seen = defaultdict(int), defaultdict(float), defaultdict(int)
    for counts, us, _ in windows:
        for name, c in counts.items():
            most[name] = max(most[name], c)
            total[name] += us[name] * calls
            seen[name] += c
    if not most:
        raise RuntimeError(f"torch.profiler recorded no device events in {TRACE_WINDOWS} "
                           f"windows of {calls} calls")
    per_call = {name: -(-c // calls) for name, c in most.items()}
    kernels = {name: per_call[name] * total[name] / seen[name] for name in most}
    complete = sum(all(counts.get(name, 0) == n * calls for name, n in per_call.items())
                   for counts, _, _ in windows)
    return {"us": sum(kernels.values()), "busy": max(busy for _, _, busy in windows),
            "events": sum(per_call.values()),
            "kernels": {k: round(v, 3) for k, v in kernels.items()}, "complete": complete}


def split(fn, reps: int = REPS) -> dict:
    """`fn`'s readings (see the module docstring); `reps` one-call timings."""
    fn()
    torch.cuda.synchronize()
    calls = [_event_ms(fn, 1) for _ in range(reps)]
    chain = _event_ms(fn, CHAIN)
    t0 = time.perf_counter()
    for _ in range(CHAIN):
        fn()
    host = (time.perf_counter() - t0) / CHAIN * 1e6
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(reps):
        fn()
    allocs = (torch.cuda.memory_stats()["allocation.all.allocated"] - before) / reps
    torch.cuda.synchronize()
    return {"call_ms": calls, "chain_ms": chain, "host_us": host,
            "device": device_split(fn), "allocs": allocs}


def in_turns(fns: dict, reps: int = REPS) -> dict:
    """{name: split} of each of two functions, read in turns a, b, b, a;
    the one-call times of both turns pooled, the other readings of the
    second turn."""
    a, b = fns
    out = {}
    for name in (a, b, b, a):
        r = split(fns[name], reps)
        if name in out:
            r["call_ms"] = out[name]["call_ms"] + r["call_ms"]
        out[name] = r
    return out


def summary(r: dict) -> str:
    c = r["call_ms"]
    d = r["device"]
    return (f"call {np.median(c):.4f} ms (min {min(c):.4f}, max {max(c):.4f}), chain "
            f"{r['chain_ms']:.4f} ms, host {r['host_us']:.1f} us, device {d['us']:.2f} us "
            f"in {d['events']:g} events ({json.dumps(d['kernels'])}; {d['complete']} of "
            f"{TRACE_WINDOWS} windows complete), allocations {r['allocs']:g}")


STEP_CALLS = 2000  # calls a timing of one host step


def rank_host_steps(table, chunk, valid) -> dict:
    """{step: host us a call} of `chunk_rank`'s wrapper on the card, each
    step timed alone (the best of 3 runs of STEP_CALLS calls), beside the
    whole call and one `torch.searchsorted`: where the enqueue goes."""
    import timeit

    from ccve_tpu_torch.kernels import _build, chunk_probe

    lib = _build.load()
    n, m = chunk.numel(), table.numel()
    out = chunk.new_empty((2, n), dtype=torch.int32)
    args = (table.data_ptr(), m, chunk_probe.index_stride_log(m), chunk.data_ptr(),
            valid.data_ptr(), n, out.data_ptr(), _build.stream(chunk))
    steps = {
        "checks": lambda: chunk_probe._check(table, chunk, valid),
        "allocation": lambda: chunk.new_empty((2, n), dtype=torch.int32),
        "stream": lambda: _build.stream(chunk),
        "ctypes call and launch": lambda: lib.ccve_chunk_rank_i64(*args),
        "row views": lambda: out.unbind(0),
        "whole call": lambda: chunk_rank(table, chunk, valid),
        "one torch.searchsorted": lambda: torch.searchsorted(table, chunk),
    }
    out_us = {}
    for name, fn in steps.items():
        torch.cuda.synchronize()
        out_us[name] = min(timeit.repeat(fn, number=STEP_CALLS, repeat=3)) / STEP_CALLS * 1e6
        torch.cuda.synchronize()
    return out_us


def rank_inputs(device):
    """#11's config-3 inputs: (table keys int64[50,000], one chunk of
    2048 level-0 probe keys int64, all valid)."""
    keys, payloads = gen_rhs_table(50_000, 1)
    table = sm.build_sorted(keys, payloads, device=device).keys
    probe = gen_probe_table(1_000_000, 4, 100_000)
    mid = probe.shape[0] // 2
    chunk = torch.from_numpy(probe[mid:mid + 2048, 0].astype(np.int64)).to(device)
    return table, chunk, torch.ones(2048, dtype=torch.bool, device=device)


def counts_inputs(device):
    """#4's inputs at the small-probe route's widest call: (the merged
    stream of config 1's first 8192 probes and its 1M build rows, m, the
    sorted probes, the build stream)."""
    keys, payloads, probe = config1_host(1_000_000, 8192)
    table = sm.build_sorted(keys, payloads, device=device)
    col = torch.from_numpy(probe[:, 0].astype(np.int32)).to(device)
    p, b = sm.pack32_streams(table, col)
    ps = p.sort().values
    return bigsort.merge_sorted_i32(ps, b), b.numel(), ps, b


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_split: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}")
    device = torch.device("cuda")
    table, chunk, valid = rank_inputs(device)
    got, want = chunk_rank(table, chunk, valid), chunk_rank_plain(table, chunk, valid)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("chunk_rank disagrees with its plain version")
    rank = in_turns({
        "chunk_rank": lambda: chunk_rank(table, chunk, valid),
        "two searchsorted": lambda: (torch.searchsorted(table, chunk, side="left"),
                                     torch.searchsorted(table, chunk, side="right")),
    })
    s, m, ps, b = counts_inputs(device)
    if not torch.equal(merge_scan.merge_scan_build_counts(s, m),
                       merge_scan.merge_scan_build_counts_plain(s, m)):
        raise AssertionError("merge_scan_build_counts disagrees with its plain version")
    want_b = b - 1
    counts = in_turns({
        "merge_scan_build_counts": lambda: merge_scan.merge_scan_build_counts(s, m),
        "two searchsorted and a subtraction": lambda: (
            torch.searchsorted(ps, want_b, right=True) - torch.searchsorted(ps, want_b)),
    })
    print(f"#11 at config 3's shape (2048 lanes, m = {table.numel()}) and #4 at 8192 probes "
          f"against config 1's 1M rows ({s.numel()} merged elements), on [{card}]:")
    for name, r in {**rank, **counts}.items():
        print(f"SPLIT {name}: {summary(r)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
