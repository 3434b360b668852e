"""The small-probe count route beside the tile route, on the card.

Run from the repository root on a machine with a CUDA GPU:

    python -m ccve_tpu_torch.bench.small_probe

It makes config 1's table (1M build rows) and, for each n in NS, takes
config 1's first n probe rows and prints:

- a `ROUTES` line: CUDA-event medians, minima and maxima over 2 * REPS
  calls of `sorted_match_totals` (for n <= 2^SMALL_PROBE_LOG the
  small-probe route: sort, #5's merge, #4's dense counts, sums) and of the
  tile route's steps called directly (pack, pad, tile sort, merge counts,
  sums), in turns tile, small, small, tile; and the host's wall time a
  call, each call ending in a synchronize. Both answers are checked
  against numpy first.
- a `DEVICE` line per route: the device's busy time a call (the union of
  its events under torch.profiler over TRACE_CALLS back-to-back calls,
  `kernel_split.device_split`), the device events a call, and each
  kernel's device time a call.

`--n-build` and `--ns` shrink the data. `--device cpu` runs the plain
path with the host clock and skips the trace.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from ccve_tpu_torch.bench.configs import config1_host, numpy_totals
from ccve_tpu_torch.bench.kernel_split import device_split
from ccve_tpu_torch.bench.profile_config1 import times_ms
from ccve_tpu_torch.device import require_device
from ccve_tpu_torch.kernels import bigsort, merge_scan
from ccve_tpu_torch.ops import sort_merge as sm

NS = (1, 100, 1024, 8192)
TRACE_CALLS = 5


def tile_route(table: sm.SortedTable, col: torch.Tensor):
    """(count, checksum) of `col` (int32 probe keys) against a `pack32`
    table by the tile route's steps, called directly: the route
    `sorted_match_totals` takes above 2^SMALL_PROBE_LOG probes (the build
    stream, then `sort_runs_narrowed` of the column and the merge
    counts)."""
    n = col.numel()
    b = (sm._build_key32(table) | 1).contiguous()
    n_pad, run_log = sm.count_side_plan(n, b.numel(), bigsort.TILE_LOG)
    runs = bigsort.sort_runs_narrowed(col, *sm._narrow_bounds(table), n_pad, run_log)
    bc = merge_scan.MERGE_COUNTS[runs.dtype](runs, 1 << run_log, n, b, b.numel()).long()
    return bc.sum(), (bc * table.payloads).sum()


# "small": `sorted_match_totals`, the small-probe route for n <= 2^SMALL_PROBE_LOG
ROUTES = {"tile": tile_route, "small": sm.sorted_match_totals}


def route_times(table, col, device: torch.device, reps: int = 10) -> dict:
    """{route: [ms]} of 2 * reps calls each, in turns tile, small, small,
    tile (CUDA events on a GPU, the host clock on the CPU), and
    {route + " host": [ms]}: wall time a call ending in a synchronize."""
    out = defaultdict(list)
    for which in ("tile", "small", "small", "tile"):
        out[which] += times_ms(lambda: ROUTES[which](table, col), device, reps)
    for which, fn in ROUTES.items():
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(table, col)
            if device.type == "cuda":
                torch.cuda.synchronize()
            out[which + " host"].append((time.perf_counter() - t0) * 1e3)
    return dict(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="small_probe")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--n-build", type=int, default=1_000_000)
    parser.add_argument("--ns", type=int, nargs="+", default=list(NS))
    args = parser.parse_args(argv)
    device = require_device(args.device)
    keys, payloads, probe = config1_host(args.n_build, max(args.ns))
    table = sm.build_sorted(keys, payloads, device=device)
    col = torch.from_numpy(probe[:, 0].astype(np.int32)).to(device)
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        print(f"card: {card}")
    print(f"config 1's table ({args.n_build} build rows) against its first n probe rows; "
          f"small-probe route up to n = 2^{sm.SMALL_PROBE_LOG}")
    print("ROUTES n route median min max (ms, events) host_median (ms, wall)")
    for n in args.ns:
        col_n = col[:n].contiguous()
        want = numpy_totals(keys, payloads, probe[:n, 0])
        for which, fn in ROUTES.items():
            got = tuple(int(x) for x in fn(table, col_n))
            if got != want:
                raise AssertionError(f"n={n} {which} route gave {got}, numpy {want}")
        ts = route_times(table, col_n, device)
        for which in ROUTES:
            t = ts[which]
            print(f"ROUTES {n} {which} {np.median(t):.4f} {min(t):.4f} {max(t):.4f} "
                  f"{np.median(ts[which + ' host']):.4f}")
        if device.type == "cuda":
            for which, fn in ROUTES.items():
                d = device_split(lambda: fn(table, col_n), TRACE_CALLS)
                top = sorted(d["kernels"].items(), key=lambda kv: -kv[1])
                print(f"DEVICE {n} {which} busy {d['busy']:.1f} us, {d['events']:g} events a "
                      "call: " + "; ".join(f"{k} {v:.1f}" for k, v in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
