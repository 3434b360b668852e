"""Where the time of config 1's `bulk_count` goes on the card.

Run from the repository root on a machine with a CUDA GPU:

    python -m ccve_tpu_torch.bench.profile_config1

It makes the config-1 data (1M build rows, 16M probe rows) and prints:

- `SWEEP` lines: `bulk_count`'s median, min and max over REPS calls (CUDA
  events, after a warm-up) for the early-stop rule's own choice (skip
  `None`) and for each forced `ops.sort_merge.SKIP_LEVELS_OVERRIDE`, with
  the number of sorted runs each leaves. Every call's count and checksum
  are checked against numpy.
- a `HOST` line: wall time per call, each call ending in a synchronize.
- torch.profiler's table over TRACE_CALLS back-to-back calls, then a
  `TRACE` line: the device's busy time (the union of its events), the
  window from the first device event to the last, and the idle share,
  1 - busy / window.

`--n-build` and `--n-probe` shrink the data. `--device cpu` runs the plain
path, times it with the host clock and skips the trace.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from ccve_tpu_torch.bench.configs import config1_data, require_device
from ccve_tpu_torch.exec.bulk import bulk_count
from ccve_tpu_torch.kernels import bigsort
from ccve_tpu_torch.ops import sort_merge

SKIPS = (None, 0, 1, 2, 3, 4, 5, 6, 8, 11)  # None: the rule's own choice
REPS = 10
TRACE_CALLS = 5


def _times_ms(fn, device: torch.device) -> list[float]:
    """Milliseconds of REPS calls of `fn` after one warm-up: CUDA events on
    a GPU, the host clock on the CPU."""
    fn()
    out = []
    for _ in range(REPS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            out.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def busy_window(intervals) -> tuple[float, float]:
    """(busy, window) of [start, end) intervals: busy is the length of
    their union, window runs from the first start to the last end."""
    ivs = sorted(intervals)
    if not ivs:
        return 0.0, 0.0
    busy = 0.0
    lo, hi = ivs[0]
    for s, e in ivs[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    return busy, max(e for _, e in ivs) - ivs[0][0]


def sweep(table, probe, expected, device: torch.device):
    """[(skip, n_runs, times_ms)] for each entry of SKIPS. At each skip
    one untimed call's (count, checksum) must equal `expected`; the hook is
    restored after."""
    n, m = probe.shape[0], table.keys.numel()
    saved = sort_merge.SKIP_LEVELS_OVERRIDE
    rows = []
    try:
        for skip in SKIPS:
            sort_merge.SKIP_LEVELS_OVERRIDE = skip
            res = bulk_count([table], probe)
            got = (int(res.count), int(res.payload_checksums[0]))
            if got != expected:
                raise AssertionError(f"skip {skip}: {got} != numpy {expected}")
            n_pad, run_log = sort_merge.count_side_plan(n, m, bigsort.TILE_LOG)
            ts = _times_ms(lambda: bulk_count([table], probe), device)
            rows.append((skip, -(-n_pad >> run_log), ts))
    finally:
        sort_merge.SKIP_LEVELS_OVERRIDE = saved
    return rows


def trace(table, probe) -> None:
    """Print torch.profiler's table and the device's idle share over
    TRACE_CALLS back-to-back `bulk_count` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bulk_count([table], probe)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_CALLS):
            bulk_count([table], probe)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=14))
    events = [
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    ]
    if not events:
        raise RuntimeError("torch.profiler recorded no device events")
    busy, window = busy_window(events)
    print(
        f"TRACE device events {len(events)}, window {window:.1f} us, busy "
        f"{busy:.1f} us, idle share {1 - busy / window:.4f} "
        f"({TRACE_CALLS} calls back to back)"
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="profile_config1")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--n-build", type=int, default=1_000_000)
    parser.add_argument("--n-probe", type=int, default=16_000_000)
    args = parser.parse_args(argv)
    device = require_device(args.device)
    table, probe, expected, _ = config1_data(args.n_build, args.n_probe, device)
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        print(f"card: {card}")
    print(f"config 1: {args.n_build} build x {args.n_probe} probe rows, "
          f"numpy (count, checksum) {expected}")
    print("SWEEP skip n_runs median min max (ms)")
    for skip, n_runs, ts in sweep(table, probe, expected, device):
        print(f"SWEEP {skip} {n_runs} {np.median(ts):.4f} {min(ts):.4f} {max(ts):.4f}")

    def synced():
        bulk_count([table], probe)
        if device.type == "cuda":
            torch.cuda.synchronize()

    synced()
    wall = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        synced()
        wall.append((time.perf_counter() - t0) * 1e3)
    print(f"HOST wall ms per bulk_count incl sync: median {np.median(wall):.4f} "
          f"min {min(wall):.4f} max {max(wall):.4f}")
    if device.type == "cuda":
        trace(table, probe)
    return 0


if __name__ == "__main__":
    sys.exit(main())
