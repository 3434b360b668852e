"""A kernel call's time on the host and on the device, beside the library
call that computes the same function, on the card.

Run from the repository root on a machine with a CUDA GPU:

    python -m ccve_tpu_torch.bench.kernel_split

For #11 (`chunk_rank`, one 2048-lane chunk against config 3's 50,000-row
table) and #4 (`merge_scan_build_counts`, config 1's 1M-row table against
its first 8192 probes, as the small-probe route calls it), and for each
one's library yardstick (two `torch.searchsorted`; two `torch.searchsorted`
and a subtraction), it prints one `SPLIT` line of `split`'s readings, in
turns kernel, library, library, kernel. For #10 (`drain_segment`, no
library call computes it) it prints one `SPLIT` line a shape: config 3's
whole stream (489 chunks of 4 levels, block 2048) under FULL and NONE
thresholds, its first 64 chunks (a streamed segment) under FULL, config
7's 977 chunks under FULL, and the occupancy variant at config 3 FULL,
with the launches a call and the grid. For #5 (`merge_sorted_i32`, the
same 8192 probes and 1M rows) it prints its line beside one `torch.sort`
of the concatenation. For #6 and #7, the stats side's probe sort, at
config 3's level 0 (1M probes), config 1 materialized (16M) and config 1
wide's stats (2^24 int64 keys), it prints one line each for the tile sort,
the first merge level, the whole sort (`sort_multi`: the tile sort and the
ladder) and the merge of two, with the launches a call by counter, and the
one-call `torch.sort` yardsticks of the packed (key << 32 | index) words,
per tile and of the whole stream (`probe_sort_cases`). For #15
(`merge_stats_i64` at config 1 wide's stats stream, and its generic entry
`merge_scan_stats` on the same stream untagged) and #8 (`merge_stats_i32`
at config 3's level 0) it prints each one's line, with its launches by
kernel, beside the wrapper's two `torch.zeros` of the outputs alone, and
the host us of each step of the row-form wrapper (`stats_host_steps`);
for #1 and #13's count-side tile sort (`sort_tiles_i32` at config 1's 16M
probes, `sort_tiles_i64` at config 1 wide's 2^24) one line each beside
one `torch.sort(dim=1)` of the tiles (`tile_sort_cases`). At the same two
shapes, for #2 and #13's count-side merge level (`merge_level_i32`,
`merge_level_i64`) one line for the ladder's first level beside one
`torch.sort(dim=1)` of the run pairs, and one for the whole ladder
(`sort_runs`: the tile sort and every level `count_side_plan` keeps)
beside one `torch.sort(dim=1)` of the runs (`count_level_cases`). For #3
and #14 (`merge_counts_i32`, `merge_counts_i64`) at the same two shapes,
over the runs that ladder leaves, one line each beside `torch.searchsorted`
of the build keys in the runs, right minus left, summed over the runs
(`merge_counts_cases`). For #9
(`compact_i32`) at config 1 materialized's candidates (three planes) and
at the LP ladder's first stage on config 1 (two planes, the lanes live
after step 0), one line each beside the one library call `planes[:,
mask]` alone, without the plain version's zeros and copy
(`compact_cases`). For #17 (`ce_stages_i32`, the roofline's calibration)
over 2^24 keys at K = 16, 32, 48 and 64 it prints one line a K with its
launches a call, and, with `--parent DIR` (a tree unpacked from a parent
commit), one for that tree's csrc/ce_stages.cu built beside this tree's
and launched raw, in turns; then each K's shared-memory floor
(`roofline.smem_floor_ms` on the card's SMs at its largest SM clock) and
bound, each tree's K-slope with its times' largest deviation from one
line, and both builds' ptxas -v lines (`ce_stages_splits`). `--only`
names the groups to read (rank, counts, merge_two, probe_sort, stats,
tile_sort, count_levels, merge_counts, compact, drain, ce_stages; all by
default). Every line gives:

- `call_ms`: CUDA events around one eager call, median (min, max) of
  2 * REPS calls: what a caller pays, the larger of the host's enqueue
  and the device's work;
- `chain_ms`: CUDA events around CHAIN back-to-back calls, over CHAIN;
- `host_us`: the host clock around the same CHAIN calls without a
  synchronize, over CHAIN: the enqueue alone;
- `device_us`: torch.profiler's device events over TRACE_CALLS calls: the
  sum of their durations a call, the events a call, each kernel's
  (memsets among them) and the device's busy time a call (the union of
  the events; `device_split`). On
  the H100 machine the profiler drops device events in some windows (seen:
  8 of 20 calls' kernels, or all of them, and in a long process most
  windows), so TRACE_WINDOWS windows are read: a kernel's launches a call
  are the most any window saw, rounded up to a whole number a call, and
  its time a launch the mean over every event recorded; `complete` counts
  the windows that lost nothing;
- `allocs`: the caching allocator's allocation requests a call.

Every kernel's results are checked against its plain version first. It
imports only what earlier versions of these kernels also had, so the same
script reads a parent tree (copied into it) and the change back to back on
one card.
"""

from __future__ import annotations

import functools
import json
import subprocess
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ccve_tpu_torch.bench.configs import config1_host
from ccve_tpu_torch.bench.profile_config1 import busy_window
from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table
from ccve_tpu_torch.kernels import _build, bigsort, drain, merge_scan, pairsort
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
    return _host_us(steps, STEP_CALLS)


def _host_us(steps: dict, number: int, repeat: int = 3) -> dict:
    """{step: host us a call}: the best of `repeat` runs of `number` calls,
    the device idle before each run."""
    import timeit

    out_us = {}
    for name, fn in steps.items():
        best = float("inf")
        for _ in range(repeat):
            torch.cuda.synchronize()
            best = min(best, timeit.timeit(fn, number=number))
        torch.cuda.synchronize()
        out_us[name] = best / number * 1e6
    return out_us


LADDER_CALLS = 20  # calls a timing of one host step of the ladder: its launches stay queued


def ladder_host_steps(p) -> dict:
    """{step: host us a call} of `sort_multi_i32(p, [rows])` on the card,
    each step of the wrapper timed alone (the best of 3 runs of
    LADDER_CALLS calls, few enough that the launch queue never fills and
    holds the host back), beside the whole call and one `torch.sort` of the
    packed words: where a host-bound call's enqueue goes. Needs the ladder
    entry (`pairsort._ladder_kernels`)."""
    from ccve_tpu_torch.kernels import _build

    lib = _build.load()
    tl = pairsort.TILE_LOG
    n = p.numel()
    rows = torch.arange(n, dtype=torch.int32, device=p.device)
    n_pad = n + (-n) % (1 << tl)
    n_levels = max((n_pad >> tl) - 1, 0).bit_length()
    yk, yv, splits = pairsort._merge_outputs(p, [rows], n_pad, tl)
    tk, tv = torch.empty_like(yk), torch.empty_like(yv[0])
    stream = _build.stream(p)
    words = (p.long() << 32) | rows.long()
    steps = {
        "checks": lambda: pairsort._check_planes(p, [rows], "sort", torch.int32),
        "ctypes size call": lambda: lib.ccve_merge_splits_bytes(n_pad, tl),
        "allocations (4)": lambda: (pairsort._merge_outputs(p, [rows], n_pad, tl),
                                    torch.empty_like(yk), torch.empty_like(yv[0])),
        "stream": lambda: _build.stream(p),
        f"ladder C call ({1 + 2 * n_levels} launches)": lambda: lib.ccve_sort_multi_i32(
            p.data_ptr(), rows.data_ptr(), None, None, yk.data_ptr(), yv[0].data_ptr(), None,
            None, tk.data_ptr(), tv.data_ptr(), None, None, splits, 1, n, tl,
            n_levels, stream),
        "tile sort C call (1 launch)": lambda: lib.ccve_sort_tiles_multi_i32(
            p.data_ptr(), rows.data_ptr(), None, None, yk.data_ptr(), yv[0].data_ptr(), None,
            None, 1, n, tl, stream),
        "merge level C call (2 launches)": lambda: lib.ccve_merge_level_multi_i32(
            yk.data_ptr(), yv[0].data_ptr(), None, None, tk.data_ptr(), tv.data_ptr(), None,
            None, splits, 1, n_pad, tl, stream),
        "slices": lambda: (yk[:n], [yv[0][:n]]),
        "whole sort_multi_i32": lambda: pairsort.sort_multi_i32(p, [rows]),
        "one torch.sort of the words": lambda: torch.sort(words),
    }
    return _host_us(steps, LADDER_CALLS)


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


DRAIN_BLOCK = 2048


def drain_args(tables, probe: np.ndarray, thr: int, occupancy=False) -> tuple:
    """#10's arguments for a probe table int[n, L] as the sorted executor
    hands it a preloaded stream at FULL (thr = the block) or NONE (thr =
    0): its rank pass's mult planes int32[S, L, 2048], the chunk counts,
    the thresholds and zero caches."""
    from ccve_tpu_torch.config import CompactionStrategy, EngineConfig
    from ccve_tpu_torch.exec.sorted_pipeline import SortedPipeline

    device = tables[0].keys.device
    n, L = probe.shape
    S = -(-n // DRAIN_BLOCK)
    cols = np.zeros((S * DRAIN_BLOCK, L), np.int64)
    cols[:n] = probe
    cols = torch.from_numpy(cols.reshape(S, DRAIN_BLOCK, L).transpose(0, 2, 1).copy())
    cfg = EngineConfig(block_size=DRAIN_BLOCK, n_joins=L, lhs_size=n, rhs_size=50_000,
                       strategy=CompactionStrategy.FULL)
    mults = SortedPipeline(list(tables), cfg)._seg_mults(cols.to(device))
    counts = np.minimum(DRAIN_BLOCK, n - DRAIN_BLOCK * np.arange(S)).astype(np.int32)
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)  # noqa: E731
    return (mults, torch.from_numpy(counts).to(device), z(L) + thr, z(L - 1, L, DRAIN_BLOCK),
            z(L if occupancy else L - 1))


def drain_cases(device) -> dict:
    """{name: (args, kwargs)} of #10 at config 3's and config 7's shapes."""
    from ccve_tpu_torch.bench.configs import config3_data, config7_data

    tables3, probe3, _ = config3_data(1_000_000, 50_000, device)
    host3 = probe3.cpu().numpy()
    table7, host7, _ = config7_data(2_000_000, 50_000, device)
    full3 = drain_args(tables3, host3, DRAIN_BLOCK)
    kw = dict(block=DRAIN_BLOCK, fanouts=(1,) * host3.shape[1])
    S3 = full3[0].shape[0]
    return {
        f"drain_segment config 3 FULL S={S3}": (full3, kw),
        f"drain_segment config 3 NONE S={S3}": (full3[:2] + (full3[2] * 0,) + full3[3:], kw),
        "drain_segment config 3 FULL S=64": (drain_args(tables3, host3[:64 * DRAIN_BLOCK],
                                                        DRAIN_BLOCK), kw),
        f"drain_segment config 7 FULL S={-(-host7.shape[0] // DRAIN_BLOCK)}": (
            drain_args([table7] * host7.shape[1], host7, DRAIN_BLOCK), kw),
        f"drain_segment_occ config 3 FULL S={S3}": (
            drain_args(tables3, host3, DRAIN_BLOCK, occupancy=True),
            dict(kw, record_occupancy=True)),
    }


def drain_splits(device) -> dict:
    """{name: split, with the launches a call and the grid} of #10 at each
    of `drain_cases`' shapes, each first held against the plain version."""
    out = {}
    for name, (args, kw) in drain_cases(device).items():
        got = drain.drain_segment(*args, **kw)
        want = drain.drain_segment_plain(*args, **kw)
        if int(got[0]) != int(want[0]) or not all(
                torch.equal(g, w) for g, w in zip(got[2:], want[2:])):
            raise AssertionError(f"{name}: #10 disagrees with its plain version")
        counter = drain.occupancy_variant if kw.get("record_occupancy") else drain.drain_segment
        before, calls = counter.launches, [0]

        def call(args=args, kw=kw):
            calls[0] += 1
            return drain.drain_segment(*args, **kw)

        r = split(call)
        r["launches"] = (counter.launches - before) / calls[0]
        # a drain without `grid` is the one-block kernel it replaced
        occupancy = kw.get("record_occupancy", False)
        r["grid"] = (drain.grid(args[0].shape[0], kw["fanouts"], occupancy)
                     if hasattr(drain, "grid") else 1)
        out[name] = r
    return out


@functools.lru_cache(maxsize=1)
def stats_streams(device) -> dict:
    """{shape: (packed probe keys, build stream, its int32 payloads)} of the
    stats side's probe sort (`sort_merge.merged_stream`) at config 3's level
    0 (1M probes against 50,000 rows), config 1 materialized (16M against
    1M) and config 1 wide's stats (2^24 int64 keys against 1M)."""
    from ccve_tpu_torch.bench.configs import config1_wide_host

    out = {}
    keys, payloads = gen_rhs_table(50_000, 1)
    probe = gen_probe_table(1_000_000, 4, 100_000)[:, 0]
    keys1, payloads1, probe1 = config1_host(1_000_000, 16_000_000)
    keys_w, payloads_w, probe_w = config1_wide_host(1_000_000, 1 << 24, 40)
    for shape, (k, pay, col, pack) in {
        "config 3 1M": (keys, payloads, probe.astype(np.int32), sm.stats_pack32_streams),
        "materialize 16M": (keys1, payloads1, probe1[:, 0].astype(np.int32),
                            sm.stats_pack32_streams),
        "wide stats 2^24 i64": (keys_w, payloads_w, probe_w, sm.stats_pack64_streams),
    }.items():
        table = sm.build_sorted(k, pay, device=device)
        b, p = pack(table, torch.from_numpy(col).to(device))
        out[shape] = (p, b, table.payloads.to(torch.int32))
    return out


def _same(got, want, what: str) -> None:
    """Raise unless (keys, planes) `got` equals `want` bit for bit."""
    if not (torch.equal(got[0], want[0])
            and all(torch.equal(g, w) for g, w in zip(got[1], want[1]))):
        raise AssertionError(f"{what}: the kernel disagrees with its plain version")


def probe_sort_cases(device) -> list:
    """[(name, fn, {counter name: counter}, yardstick name, yardstick fn or
    None)] of #6 (`sort_tiles_multi`), one #7 merge level (the first, over
    the sorted tiles), the whole sort (`sort_multi`: #6 and the ladder) and
    #7's merge of two (the sorted probes and the build stream) at each of
    `stats_streams`' shapes, each first held against its plain version.
    The yardsticks are one `torch.sort` call: per tile, of the tile's
    (key << 32 | tile index) words, for #6; of the stream's (key << 32 |
    row) words, for the whole sort (int64 keys: a stable sort of the keys,
    whose order a gather would then apply to the rows)."""
    tl = pairsort.TILE_LOG
    out = []
    for shape, (p, b, pay) in stats_streams(device).items():
        key = "i32" if p.dtype == torch.int32 else "i64"
        sort_tiles = getattr(pairsort, f"sort_tiles_multi_{key}")
        merge_level = getattr(pairsort, f"merge_level_multi_{key}")
        merge_two = getattr(pairsort, f"merge_two_multi_{key}")
        sort_multi = getattr(pairsort, f"sort_multi_{key}")
        rows = torch.arange(p.numel(), dtype=torch.int32, device=device)
        pk, pv = pairsort.pad_to_tile(p, [rows], tl)
        tiles = sort_tiles(pk, pv, tl)
        _same(tiles, pairsort.sort_tiles_multi_plain(pk, pv, tl), f"#6 {shape}")
        _same(merge_level(*tiles, tl), pairsort.merge_level_multi_plain(*tiles, tl),
              f"#7 level {shape}")
        sk, sv = sort_multi(p, [rows])
        _same((sk, sv), pairsort.sort_multi_plain(p, [rows]), f"sort_multi {shape}")
        two = (sk, sv, b, [pay])
        _same(merge_two(*two), pairsort.merge_two_multi_plain(*two), f"#7 merge two {shape}")
        if key == "i32":
            local = torch.arange(pk.numel(), device=device) & ((1 << tl) - 1)
            tile_words = ((pk.long() << 32) | local).view(-1, 1 << tl)
            words = (p.long() << 32) | rows.long()
            whole = torch.sort(words).values
            if not (torch.equal(whole >> 32, sk.long())
                    and torch.equal(whole & 0xFFFFFFFF, sv[0].long())):
                raise AssertionError(f"torch.sort of the packed words, {shape}: not sort_multi's")
            tile_lib = (f"torch.sort of a tile's words, {shape}",
                        lambda w=tile_words: torch.sort(w, dim=1))
            whole_lib = (f"torch.sort of the stream's words, {shape}",
                         lambda w=words: torch.sort(w))
        else:
            tile_lib = (f"torch.sort of a tile's keys, stable, {shape}",
                        lambda k=pk.view(-1, 1 << tl): torch.sort(k, dim=1, stable=True))
            whole_lib = (f"torch.sort of the stream's keys, stable, {shape}",
                         lambda k=p: torch.sort(k, stable=True))
        # the partition kernel's counter exists only since #7's redesign
        part = ({"merge_partition": pairsort.merge_partition}
                if hasattr(pairsort, "merge_partition") else {})
        tiles_c = {sort_tiles.__name__: sort_tiles}
        level_c = {merge_level.__name__: merge_level, **part}
        out += [
            (f"sort_tiles_multi, {shape}", lambda f=sort_tiles, a=(pk, pv, tl): f(*a), tiles_c,
             *tile_lib),
            (f"merge level {tl}, {shape}", lambda f=merge_level, a=tiles: f(*a, tl), level_c,
             None, None),
            (f"sort_multi (#6 + ladder), {shape}", lambda f=sort_multi, a=(p, [rows]): f(*a),
             {**tiles_c, **level_c}, *whole_lib),
            (f"merge two, {shape}", lambda f=merge_two, a=two: f(*a),
             {merge_two.__name__: merge_two, **part}, None, None),
        ]
    return out


def probe_sort_splits(device) -> dict:
    """{name: split} of `probe_sort_cases`, each kernel read in turns with
    its yardstick where it has one, alone otherwise; a kernel's split also
    holds its launches a call by counter."""
    out = {}
    for name, fn, counters, lib_name, lib in probe_sort_cases(device):
        before = {c: k.launches for c, k in counters.items()}
        calls = [0]

        def call(fn=fn, calls=calls):
            calls[0] += 1
            return fn()

        out.update(in_turns({name: call, lib_name: lib}) if lib else {name: split(call)})
        out[name]["launches"] = {c: (k.launches - before[c]) / calls[0]
                                 for c, k in counters.items()}
    return out


@functools.lru_cache(maxsize=1)
def stats_scan_inputs(device) -> dict:
    """{shape: (s, v, n)}: the merged stream, its int32 plane and the probe
    rows that #15 (`merge_stats_i64`) gets on config 1 wide's stats (2^24
    int64 probes against 1M rows) and #8 (`merge_stats_i32`) on config 3's
    level 0 (1M int32 probes against 50,000), from `stats_streams`."""
    out = {}
    for shape in ("wide stats 2^24 i64", "config 3 1M"):
        p, b, pay = stats_streams(device)[shape]
        key = "i32" if p.dtype == torch.int32 else "i64"
        rows = torch.arange(p.numel(), dtype=torch.int32, device=device)
        sk, sv = getattr(pairsort, f"sort_multi_{key}")(p, [rows])
        s, (v,) = getattr(pairsort, f"merge_two_multi_{key}")(sk, sv, b, [pay])
        out[shape] = (s, v, p.numel())
    return out


def _same_stats(got, want, what: str) -> None:
    """Raise unless (mult, psum) `got` equals `want` bit for bit."""
    _same((got[0], [got[1]]), (want[0], [want[1]]), what)


def _generic(s, v):
    """The generic entry's (sk, st) of a row-form stream: the untagged key,
    and a build's payload as pay * 2 + 1 beside 0 at a probe."""
    return s >> 1, torch.where((s & 1) == 0, v.to(torch.int64) * 2 + 1, 0)


def stats_cases(device) -> list:
    """[(name, fn, counter)] of #15 at config 1 wide's stats stream (the
    row form, and its generic entry on the same stream untagged), #8 at
    config 3's, and the wrapper's two `torch.zeros` of the outputs alone,
    each kernel first held against its plain version."""
    out = []
    for shape, (s, v, n) in stats_scan_inputs(device).items():
        key = "i32" if s.dtype == torch.int32 else "i64"
        wrapper = getattr(merge_scan, f"merge_stats_{key}")
        _same_stats(wrapper(s, v, n), merge_scan.merge_stats_plain(s, v, n),
                    f"merge_stats_{key} {shape}")
        out += [(f"merge_stats_{key}, {shape}", lambda f=wrapper, a=(s, v, n): f(*a), wrapper),
                (f"two torch.zeros of the outputs, n = {n}", lambda n=n: (
                    torch.zeros(n, dtype=torch.int32, device=device),
                    torch.zeros(n, dtype=torch.int64, device=device)), None)]
        if key == "i64":
            sk, st = _generic(s, v)
            _same_stats(merge_scan.merge_scan_stats(sk, st),
                        merge_scan.merge_scan_stats_plain(sk, st), f"merge_scan_stats {shape}")
            out.append((f"merge_scan_stats (generic entry), {shape} untagged",
                        lambda a=(sk, st): merge_scan.merge_scan_stats(*a),
                        merge_scan.merge_scan_stats))
    return out


def stats_host_steps(s, v, n) -> dict:
    """{step: host us a call} of `merge_stats_{i32,i64}(s, v, n)`'s wrapper
    on the card, each step timed alone (the best of 3 runs of
    LADDER_CALLS calls), beside the whole call: where the enqueue goes."""
    from ccve_tpu_torch.kernels import _build

    lib = _build.load()
    key = _build.SUFFIX[s.dtype]
    mult = torch.zeros(n, dtype=torch.int32, device=s.device)
    psum = torch.zeros(n, dtype=torch.int64, device=s.device)
    size = lib.ccve_merge_stats_scratch_bytes
    size_args = (s.numel(), n)[:len(_build._SIZE_FUNCTIONS["ccve_merge_stats_scratch_bytes"])]
    scratch = torch.empty(size(*size_args), dtype=torch.uint8, device=s.device)
    entry = getattr(lib, f"ccve_merge_stats_{key}")
    steps = {
        "checks": lambda: (_build.check_int(s, "s", s.dtype), _build.check_i32(v, "v")),
        "two torch.zeros": lambda: (torch.zeros(n, dtype=torch.int32, device=s.device),
                                    torch.zeros(n, dtype=torch.int64, device=s.device)),
        "scratch size call": lambda: size(*size_args),
        "scratch allocation": lambda: torch.empty(size(*size_args), dtype=torch.uint8,
                                                  device=s.device),
        "stream": lambda: _build.stream(s),
        "ctypes call and launches": lambda: entry(
            s.data_ptr(), v.data_ptr(), s.numel(), n, scratch.data_ptr(), mult.data_ptr(),
            psum.data_ptr(), _build.stream(s)),
        "whole call": lambda: getattr(merge_scan, f"merge_stats_{key}")(s, v, n),
    }
    return _host_us(steps, LADDER_CALLS)


def stats_splits(device) -> dict:
    """{name: split} of `stats_cases`, with a kernel's launches a call by
    counter."""
    out = {}
    for name, fn, counter in stats_cases(device):
        if counter is None:
            out[name] = split(fn)
            continue
        before, calls = counter.launches, [0]

        def call(fn=fn, calls=calls):
            calls[0] += 1
            return fn()

        out[name] = split(call)
        out[name]["launches"] = {counter.__name__: (counter.launches - before) / calls[0]}
    return out


@functools.lru_cache(maxsize=1)
def count_streams(device) -> dict:
    """{shape: (padded probe stream, real probes n, build stream b)} of the
    count side: config 1's 16M int32 probes and config 1 wide's 2^24 int64
    probes, packed (`pack32_streams`, `pack64_streams`) and padded to whole
    tiles with the key type's maximum."""
    from ccve_tpu_torch.bench.configs import config1_wide_host

    out = {}
    for shape, (k, pay, col), pack in (
            ("config 1 16M i32", config1_host(1_000_000, 16_000_000), sm.pack32_streams),
            ("wide count 2^24 i64", config1_wide_host(1_000_000, 1 << 24, 40),
             sm.pack64_streams)):
        table = sm.build_sorted(k, pay, device=device)
        col = col[:, 0] if col.ndim == 2 else col
        p, b = pack(table, torch.from_numpy(col).to(device))
        n_pad = -(-p.numel() >> bigsort.TILE_LOG) << bigsort.TILE_LOG
        out[shape] = (torch.cat([p, p.new_full((n_pad - p.numel(),), bigsort.PAD[p.dtype])]),
                      p.numel(), b)
    return out


def count_tiles(device) -> dict:
    """{shape: padded probe stream} that the count side's tile sort gets:
    `count_streams`' config 1 (#1, `sort_tiles_i32`) and config 1 wide
    (#13's count-side build, `sort_tiles_i64`)."""
    return {shape: x for shape, (x, _, _) in count_streams(device).items()}


def tile_sort_cases(device) -> list:
    """[(name, fn, counter, yardstick name, yardstick fn)] of #1 and #13's
    count-side tile sort at `count_tiles`' shapes, each first held against
    its plain version; the yardstick is one `torch.sort(dim=1)` of the
    tiles (the plain version's sort)."""
    out = []
    T = 1 << bigsort.TILE_LOG
    for shape, x in count_tiles(device).items():
        wrapper = bigsort.KERNELS[x.dtype][0]
        if not torch.equal(wrapper(x), bigsort.sort_tiles_plain(x, bigsort.TILE_LOG)):
            raise AssertionError(f"{wrapper.__name__} {shape}: disagrees with its plain version")
        out.append((f"{wrapper.__name__}, {shape}", lambda f=wrapper, x=x: f(x), wrapper,
                    f"torch.sort(dim=1) of the tiles, {shape}",
                    lambda x=x.view(-1, T): torch.sort(x, dim=1)))
    return out


COUNT_BUILD_ROWS = 1_000_000  # the build side of both `count_tiles` shapes


def _padded_view(x: torch.Tensor, width: int) -> torch.Tensor:
    """x padded with its key type's maximum to a multiple of `width`, as
    rows of `width`: a row sort of it sorts each run of `width` of x, the
    ragged last one too, and puts the padding after it."""
    pad = x.new_full(((-x.numel()) % width,), bigsort.PAD[x.dtype])
    return torch.cat([x, pad]).view(-1, width)


def count_level_cases(device) -> list:
    """[(name, fn, {counter name: counter}, yardstick name, yardstick fn)]
    of #2 and #13's count-side merge level at `count_tiles`' shapes: the
    ladder's first level (over the sorted tiles) beside one
    `torch.sort(dim=1)` of the run pairs, and the whole ladder (`sort_runs`
    at `count_side_plan`'s run_log for COUNT_BUILD_ROWS build rows) beside
    one `torch.sort(dim=1)` of the runs, each first held against its plain
    version and the yardstick against the kernel."""
    tl = bigsort.TILE_LOG
    out = []
    for shape, x in count_tiles(device).items():
        sort_tiles, merge_level = bigsort.KERNELS[x.dtype]
        run_log = sm.count_side_plan(x.numel(), COUNT_BUILD_ROWS, tl)[1]
        tiles = bigsort.sort_tiles_plain(x, tl)
        level = merge_level(tiles, tl)
        runs = bigsort.sort_runs(x, run_log, tl)
        pairs = _padded_view(tiles, 2 << tl)
        whole = _padded_view(x, 1 << run_log)
        for what, got, want, lib in (
                ("level", level, bigsort.merge_level_plain(tiles, tl), pairs),
                ("sort_runs", runs, bigsort.sort_runs_plain(x, run_log, tl), whole)):
            if not (torch.equal(got, want)
                    and torch.equal(torch.sort(lib, dim=1).values.view(-1)[:x.numel()], got)):
                raise AssertionError(f"{merge_level.__name__} {what} {shape}: disagrees with "
                                     f"its plain version or its yardstick")
        # the partition kernel's counter is shared with #7's
        part = {"merge_partition": pairsort.merge_partition}
        n_levels = run_log - tl
        out += [
            (f"{merge_level.__name__} level {tl}, {shape}",
             lambda f=merge_level, a=tiles: f(a, tl),
             {merge_level.__name__: merge_level, **part},
             f"torch.sort(dim=1) of the run pairs, {shape}",
             lambda v=pairs: torch.sort(v, dim=1)),
            (f"sort_runs ({n_levels} levels), {shape}",
             lambda a=x, r=run_log: bigsort.sort_runs(a, r, tl),
             {sort_tiles.__name__: sort_tiles, merge_level.__name__: merge_level, **part},
             f"torch.sort(dim=1) of the runs of 2^{run_log}, {shape}",
             lambda v=whole: torch.sort(v, dim=1)),
        ]
    return out


def merge_counts_cases(device) -> list:
    """[(name, fn, counter, yardstick name, yardstick fn)] of #3 and #14 at
    `count_streams`' shapes, over the runs the count side's ladder leaves
    (`sort_runs` at `count_side_plan`'s run_log for COUNT_BUILD_ROWS build
    rows), each first held against its plain version. The yardstick is
    `torch.searchsorted` of b - 1 in the [R, run_len] runs (padded with the
    key type's maximum, which is odd and never equals an even b - 1), right
    minus left, summed over the runs: the plain version's function in one
    batch, without its batching loop, zeros or cast."""
    tl = bigsort.TILE_LOG
    out = []
    for shape, (x, n, b) in count_streams(device).items():
        m = b.numel()
        run_log = sm.count_side_plan(n, m, tl)[1]
        runs = bigsort.sort_runs(x, run_log, tl)
        wrapper = merge_scan.MERGE_COUNTS[x.dtype]
        rows = _padded_view(runs, 1 << run_log)
        want = (b - 1).expand(rows.shape[0], -1).contiguous()

        def library(rows=rows, want=want):
            return (torch.searchsorted(rows, want, right=True)
                    - torch.searchsorted(rows, want)).sum(0)

        got = wrapper(runs, 1 << run_log, n, b, m)
        if not (torch.equal(got, merge_scan.merge_counts_plain(runs, 1 << run_log, n, b, m))
                and torch.equal(library(), got.long())):
            raise AssertionError(f"{wrapper.__name__} {shape}: disagrees with its plain version "
                                 f"or its yardstick")
        out.append((f"{wrapper.__name__}, {shape} ({rows.shape[0]} runs of 2^{run_log}, "
                    f"m = {m})", lambda f=wrapper, a=(runs, 1 << run_log, n, b, m): f(*a),
                    wrapper, f"torch.searchsorted of the {rows.shape[0]} runs, {shape}",
                    library))
    return out


@functools.lru_cache(maxsize=1)
def compact_inputs(device) -> dict:
    """{shape: (planes, mask)} that #9 gets: config 1 materialized's
    candidates (`expand_candidates`: probe row, key', payload over the
    merged stream) and the LP ladder's first stage on config 1 (cursor and
    probe row of each lane, the lanes live after step 0 of config 1's LP
    table)."""
    from ccve_tpu_torch.exec import bulk
    from ccve_tpu_torch.kernels.murmur import murmurhash64_i64
    from ccve_tpu_torch.ops.hash_table import build_lp

    keys, payloads, probe = config1_host(1_000_000, 16_000_000)
    table = sm.build_sorted(keys, payloads, device=device)
    planes, valid, _ = sm.expand_candidates(table, torch.from_numpy(
        probe[:, 0].astype(np.int32)).to(device))
    lp = build_lp(keys, payloads, device=device)
    col = torch.from_numpy(probe[:, 0].astype(np.int64)).to(device)
    h = murmurhash64_i64(col) & (lp.n_slots - 1)
    _, _, live, cursor = bulk._lp_step(lp, col, h, torch.ones_like(col, dtype=torch.bool))
    rows = torch.arange(col.numel(), dtype=torch.int32, device=device)
    return {f"materialize C=3 n={valid.numel()}": (planes, valid),
            f"LP ladder stage 1 C=2 n={live.numel()}": (
                torch.stack([cursor.to(torch.int32), rows]), live)}


def compact_cases(device) -> list:
    """[(name, fn, counter, yardstick name, yardstick fn)] of #9 at
    `compact_inputs`' shapes, each first held against its plain version;
    the yardstick is the one library call `planes[:, mask]`, which gives
    the kept rows without the plain version's zeros and copy."""
    from ccve_tpu_torch.kernels import compact

    out = []
    for shape, (planes, mask) in compact_inputs(device).items():
        got, count = compact.compact_i32(planes, mask)
        want, want_count = compact.compact_plain(planes, mask)
        kept = planes[:, mask]
        if not (torch.equal(got, want) and int(count) == int(want_count)
                and torch.equal(got[:, :kept.shape[1]], kept)):
            raise AssertionError(f"compact_i32 {shape}: disagrees with its plain version or "
                                 f"its yardstick")
        out.append((f"compact_i32, {shape}", lambda a=(planes, mask): compact.compact_i32(*a),
                    compact.compact_i32, f"planes[:, mask], {shape}",
                    lambda a=(planes, mask): a[0][:, a[1]]))
    return out


CE_N = 1 << 24  # #17's keys, as `roofline.measure_anchors` times them
CE_STAGES = (16, 32, 48, 64)


def build_ce_stages(src: Path, lib_path: Path):
    """(ctypes entry `ccve_ce_stages_i32`, ptxas' -v lines) of one copy of
    csrc/ce_stages.cu (this tree's or a parent tree's), built alone into
    `lib_path`."""
    import ctypes

    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                           "-o", str(lib_path), str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    entry = ctypes.CDLL(str(lib_path)).ccve_ce_stages_i32
    entry.argtypes = _build._ENTRY_POINTS["ccve_ce_stages_i32"]
    entry.restype = ctypes.c_int
    return entry, [line.strip() for line in proc.stderr.splitlines() if line.strip()]


def ce_stages_splits(device, parent: Path | None) -> dict:
    """{name: split} of #17 over CE_N keys at each of CE_STAGES: through
    its wrapper, with its launches a call by counter, and, where `parent`
    (a tree unpacked from a parent commit) is given, that tree's
    csrc/ce_stages.cu built beside it and launched raw into one output, in
    turns this tree, parent, parent, this tree; each first held exactly
    against the plain version. Prints both builds' ptxas lines (this
    tree's source built alone, as the parent's)."""
    from ccve_tpu_torch.kernels import ce_stages

    x = torch.from_numpy(np.random.default_rng(11).integers(0, 2**30, CE_N)
                         .astype(np.int32)).to(device)
    y = torch.empty_like(x)
    trees = {"this tree": _build.CSRC / "ce_stages.cu"}
    if parent is not None:
        trees["parent"] = parent / "ccve_tpu_torch" / "kernels" / "csrc" / "ce_stages.cu"
    out = {}
    with tempfile.TemporaryDirectory(prefix="ce_stages_") as tmp:
        entries = {}
        for i, (tree, src) in enumerate(trees.items()):
            entries[tree], lines = build_ce_stages(src, Path(tmp) / f"ce_stages_{i}.so")
            for line in lines:
                print(f"PTXAS #17 {tree}: {line}")
        for k in CE_STAGES:
            want = ce_stages.ce_stages_plain(x, k)
            if not torch.equal(ce_stages.ce_stages_i32(x, k), want):
                raise AssertionError(f"ce_stages_i32 K={k}: disagrees with its plain version")
            name, calls = f"ce_stages_i32 K={k} (this tree)", [0]

            def wrapper(k=k, calls=calls):
                calls[0] += 1
                return ce_stages.ce_stages_i32(x, k)

            fns = {name: wrapper}
            if parent is not None:
                def raw(k=k, entry=entries["parent"]):
                    _build.check(entry(x.data_ptr(), y.data_ptr(), CE_N >> ce_stages.TILE_LOG,
                                       k, _build.stream(x)), "the parent's ce_stages_i32")

                y.fill_(-1)
                raw()
                if not torch.equal(y, want):
                    raise AssertionError(f"the parent's ce_stages_i32 K={k}: disagrees with "
                                         "the plain version")
                fns[f"ce_stages_i32 K={k} (parent)"] = raw
            before = ce_stages.ce_stages_i32.launches
            got = in_turns(fns) if parent is not None else {name: split(wrapper)}
            got[name]["launches"] = {
                "ce_stages_i32": (ce_stages.ce_stages_i32.launches - before) / calls[0]}
            out.update(got)
    return out


def print_ce_stages(splits: dict) -> None:
    """The SPLIT lines of `ce_stages_splits`, each K's shared-memory floor
    and bound, and each tree's K-slope with its largest deviation from
    one line, from the chain and the device times."""
    from ccve_tpu_torch.bench import roofline

    _print_splits(splits)
    sms, clock_hz = roofline.smem_rate()
    for k in CE_STAGES:
        b_ms, b_by = roofline.bound_ms(8 * CE_N, k * CE_N)
        print(f"FLOOR #17 K={k}: shared-memory floor "
              f"{roofline.smem_floor_ms(CE_N, k, sms, clock_hz):.4f} ms ({sms} SMs at "
              f"{clock_hz / 1e9:.3f} GHz, {roofline.SMEM_BYTES_PER_CLOCK} B a clock), bound "
              f"{b_ms:.4f} ms ({b_by})")
    for tree in ("this tree", "parent"):
        rows = [splits.get(f"ce_stages_i32 K={k} ({tree})") for k in CE_STAGES]
        if None in rows:
            continue
        for what, ms in (("chain", [r["chain_ms"] for r in rows]),
                         ("device", [r["device"]["us"] / 1e3 for r in rows])):
            slope, intercept, worst = roofline.stage_line(CE_STAGES, ms)
            print(f"SLOPE #17 {tree} ({what}): {slope / CE_N * 1e9:.4f} ps a key a stage "
                  f"(intercept {intercept:.4f} ms), (t64 - t16) / 48 / n "
                  f"{(ms[-1] - ms[0]) / 48 / CE_N * 1e9:.4f} ps, largest deviation from the "
                  f"line {worst * 100:.2f}%; floor "
                  f"{roofline.smem_floor_ms(1, 1, sms, clock_hz) * 1e9:.4f} ps")


def counted_splits(cases) -> dict:
    """{name: split} of (name, fn, counters, yardstick name, yardstick fn)
    cases, each kernel read in turns with its yardstick, with its launches
    a call by counter (a counter alone stands for {its name: it})."""
    out = {}
    for name, fn, counters, lib_name, lib in cases:
        if not isinstance(counters, dict):
            counters = {counters.__name__: counters}
        before = {c: k.launches for c, k in counters.items()}
        calls = [0]

        def call(fn=fn, calls=calls):
            calls[0] += 1
            return fn()

        out.update(in_turns({name: call, lib_name: lib}))
        out[name]["launches"] = {c: (k.launches - before[c]) / calls[0]
                                 for c, k in counters.items()}
    return out


GROUPS = ("rank", "counts", "merge_two", "probe_sort", "stats", "tile_sort", "count_levels",
          "merge_counts", "compact", "drain", "ce_stages")


def _print_splits(splits: dict) -> None:
    for name, r in splits.items():
        launches = f"; launches a call {json.dumps(r['launches'])}" if "launches" in r else ""
        print(f"SPLIT {name}: {summary(r)}{launches}")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default=",".join(GROUPS),
                        help=f"comma-separated groups to read, of {', '.join(GROUPS)}")
    parser.add_argument("--parent", type=Path, default=None,
                        help="a tree unpacked from a parent commit: its csrc/ce_stages.cu is "
                        "built and timed beside this tree's (group ce_stages)")
    args = parser.parse_args(argv)
    groups = set(args.only.split(","))
    if groups - set(GROUPS):
        parser.error(f"unknown groups {sorted(groups - set(GROUPS))}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_split: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}")
    device = torch.device("cuda")
    if "rank" in groups:
        table, chunk, valid = rank_inputs(device)
        got, want = chunk_rank(table, chunk, valid), chunk_rank_plain(table, chunk, valid)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError("chunk_rank disagrees with its plain version")
        print(f"#11 at config 3's shape (2048 lanes, m = {table.numel()}), on [{card}]:")
        _print_splits(in_turns({
            "chunk_rank": lambda: chunk_rank(table, chunk, valid),
            "two searchsorted": lambda: (torch.searchsorted(table, chunk, side="left"),
                                         torch.searchsorted(table, chunk, side="right")),
        }))
    if groups & {"counts", "merge_two"}:
        s, m, ps, b = counts_inputs(device)
        print(f"#4 and #5 at 8192 probes against config 1's 1M rows ({s.numel()} merged "
              f"elements), on [{card}]:")
    if "counts" in groups:
        if not torch.equal(merge_scan.merge_scan_build_counts(s, m),
                           merge_scan.merge_scan_build_counts_plain(s, m)):
            raise AssertionError("merge_scan_build_counts disagrees with its plain version")
        want_b = b - 1
        _print_splits(in_turns({
            "merge_scan_build_counts": lambda: merge_scan.merge_scan_build_counts(s, m),
            "two searchsorted and a subtraction": lambda: (
                torch.searchsorted(ps, want_b, right=True) - torch.searchsorted(ps, want_b)),
        }))
    if "merge_two" in groups:
        if not torch.equal(bigsort.merge_sorted_i32(ps, b),
                           bigsort.merge_sorted_i32_plain(ps, b)):
            raise AssertionError("merge_sorted_i32 disagrees with its plain version")
        _print_splits(in_turns({
            "merge_sorted_i32": lambda: bigsort.merge_sorted_i32(ps, b),
            "torch.sort of the concatenation": lambda: torch.cat([ps, b]).sort(),
        }))
    if "probe_sort" in groups:
        sorts = probe_sort_splits(device)
        print(f"#6 and #7, the stats side's probe sort (tile 2^{pairsort.TILE_LOG}, one cargo "
              f"plane), at config 3's, config 1 materialized's and config 1 wide's shapes, on "
              f"[{card}]:")
        _print_splits(sorts)
        if hasattr(pairsort, "_ladder_kernels"):
            p = stats_streams(device)["config 3 1M"][0]
            print(f"host us a call of each step of sort_multi_i32 at config 3's 1M probes, on "
                  f"[{card}]:")
            for step, us in ladder_host_steps(p).items():
                print(f"HOST {step}: {us:.1f} us")
    if "stats" in groups:
        stats = stats_splits(device)
        print(f"#15 (row form at config 1 wide's stats, generic entry on the same stream) and "
              f"#8 (config 3's level 0), with the wrapper's output zeroing alone, on [{card}]:")
        _print_splits(stats)
        for shape, (s, v, n) in stats_scan_inputs(device).items():
            print(f"host us a call of each step of merge_stats at {shape} ({s.numel()} "
                  f"elements, {n} rows), on [{card}]:")
            for step, us in stats_host_steps(s, v, n).items():
                print(f"HOST {step}: {us:.1f} us")
    if "tile_sort" in groups:
        tiles = counted_splits(tile_sort_cases(device))
        print(f"#1 and #13's count-side tile sort (tile 2^{bigsort.TILE_LOG}) at config 1's 16M "
              f"and config 1 wide's 2^24 probes, on [{card}]:")
        _print_splits(tiles)
    if "count_levels" in groups:
        levels = counted_splits(count_level_cases(device))
        print(f"#2 and #13's count-side merge level and ladder at config 1's 16M and config 1 "
              f"wide's 2^24 probes, on [{card}]:")
        _print_splits(levels)
    if "merge_counts" in groups:
        counts = counted_splits(merge_counts_cases(device))
        print(f"#3 and #14, the count side's merge counts, at config 1's 16M and config 1 "
              f"wide's 2^24 probes against 1M build rows, on [{card}]:")
        _print_splits(counts)
    if "compact" in groups:
        compactions = counted_splits(compact_cases(device))
        print(f"#9 at config 1 materialized's candidates and the LP ladder's first stage, on "
              f"[{card}]:")
        _print_splits(compactions)
    if "drain" in groups:
        drains = drain_splits(device)
        print(f"#10 at config 3's and config 7's shapes (4 levels, block {DRAIN_BLOCK}, "
              f"fanouts 1), on [{card}]:")
        for name, r in drains.items():
            print(f"SPLIT {name}: {summary(r)}; launches a call {r['launches']:g}, grid "
                  f"{r['grid']}")
    if "ce_stages" in groups:
        ce = ce_stages_splits(device, args.parent)
        print(f"#17 over 2^24 keys at K = {', '.join(map(str, CE_STAGES))}"
              f"{', beside the parent tree' if args.parent else ''}, on [{card}]:")
        print_ce_stages(ce)
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
