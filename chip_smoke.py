#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ccve_tpu_torch`) on one NVIDIA GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.

 1. Requires a CUDA device; prints the card's name and power limit.
 2. Builds the kernels of `ccve_tpu_torch/kernels/csrc` with nvcc (sm_90a).
 3. Holds each kernel of the config-1 path against its plain PyTorch
    version on the card, at small ragged shapes: exact integer equality
    (tolerance 0, the outputs are integers).
 4. Drives the config-1 join (1M build rows against 16M probe rows) once
    through `build_sorted` and `bulk_count`, with every launch counter set
    to 0 just before; checks that each kernel launched, and that count and
    checksum equal numpy's and the all-plain path's.
 5. Holds each kernel against its plain version again at the shapes that
    run gave it, and times kernels, plain versions, `bulk_count` and the
    all-plain path with CUDA events.
 6. Runs `bench.configs.config1_single_join` as the CLI would.
 7. Slice 2's kernels (multi-plane tile sort, multi-plane merges, stats
    scan, compaction) against their plain versions at small ragged
    shapes, exactly.
 8. Config 3's bulk engine at full size (1M probe rows x 4 levels, 50K
    build rows each) through `bulk_count`, launch counters zeroed just
    before: count and four checksums against the numpy oracle and the
    all-plain path; the kernels again at its shapes; times.
 9. Config 1 materialized at full size (phase 4's data) through
    `sorted_expand_tiled`, counters zeroed just before: total, Σ payload
    and sampled triples against numpy, every tensor against the
    all-plain path; the kernels again at its shapes; times.
10. Duplicate keys (256K build rows, 4 per key, 4M probes): per-probe
    stats and the expanded triple multiset against numpy.
11. Runs `config3_four_way` and `config1_materialize` as the CLI would.
12. Slice 3's int64 kernels (tile sort, merge level, counts, multi-plane
    tile sort, multi-plane merges, stats scan) against their plain
    versions at small ragged shapes, exactly: keys near ±2^62 and at the
    int64 extremes, INT64_MAX padding, n off the tile, P = 1..3, empty
    streams.
13. `config1_wide` at full size (1M build rows with keys over 2^40, 2^24
    probes) through `bulk_count` and `sorted_match_totals`, counters zeroed
    just before: count and checksum against numpy and the all-plain path;
    the int64 count-side kernels again at its shapes; times.
14. The wide stats side on phase 13's data: `sorted_match_stats` (mult and
    psum on every row against numpy's searchsorted ranges, the all-plain
    route identical), `sorted_match_ranks` on the rank twin, a 2-level
    `bulk_count` against the numpy oracle, each with counters zeroed just
    before; the int64 stats kernels again at its shapes; times.
15. The int64/int32 ratio: config 1's own streams (phase 4) widened to
    int64 through the same count side, timed beside the int32 streams.
16. Slice 4's kernel, the murmur64 hash (#12), against its plain version
    at small shapes, exactly: the int64 extremes, unaligned n, n = 0.
17. Config 1 (phase 4's data) through `build_lp` and `build_csr` at full
    size and `bulk_count`, counters zeroed just before: count and checksum
    against numpy and each table's all-plain route, per-row mult and psum
    against `sorted_match_stats` on the same column; the hash launched on
    both, the compaction on the LP drain. Build seconds, max_run, max_len.
18. The hash at config 1's 16M probe keys against its plain version,
    timed.
19. `bulk_count` on the LP and CSR tables beside the sort-merge table on
    the same data (medians of 20, min and max), the hash tables' all-plain
    routes, and each engine's device idle share from torch.profiler.
20. `bulk_materialize` over LP and CSR tables on phase 10's duplicate-key
    data: the triple multiset against the sort-merge route's and numpy's.
21. Runs `config1_single_join` with `engine` hash_lp and hash_csr as the
    CLI would.
22. The LP ladder at 5, 25 and 50 % hits on config 1's LP table (16M
    probes): counters zeroed just before each ladder call; where at most a
    quarter of the probes hit, the ladder must hold (one hash launch, four
    compactions), so its own answer is the one returned. Ladder, full
    width and the all-plain ladder against the exact per-row answer, CSR
    and sort-merge counts against it; times of the four.

Prints the per-kernel JSON line (each kernel's launches on its main path,
max |kernel - plain|, its time, its plain version's, its bound and the
library call's), then the card line, then, only when every phase passed,
the last line `{"ok": true, "device": {...}}`. Any failure raises and
exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# The run drives one card: only the first visible device is exposed, so
# the device count it reports is the count it used.
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The port comes from the checkout this script sits in; without it the
# script stops here, before any device work.
from ccve_tpu_torch.bench.configs import (  # noqa: E402
    check_sampled_triples,
    config1_materialize,
    config1_single_join,
    config1_wide_host,
    config3_data,
    config3_four_way,
    numpy_totals,
)
from ccve_tpu_torch.config import PayloadMode  # noqa: E402
from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table  # noqa: E402
from ccve_tpu_torch.bench.profile_config1 import busy_window  # noqa: E402
from ccve_tpu_torch.exec.bulk import (  # noqa: E402
    HASH_PLAIN,
    bulk_count,
    bulk_materialize,
    combine_levels,
    csr_match_stats,
    lp_match_stats,
)
from ccve_tpu_torch.exec.oracle import OracleBuildTable, oracle_join, oracle_pipeline  # noqa: E402
from ccve_tpu_torch.kernels import _build, bigsort, compact, merge_scan, murmur, pairsort  # noqa: E402
from ccve_tpu_torch.ops import sort_merge as sm  # noqa: E402
from ccve_tpu_torch.ops.hash_table import build_csr, build_lp  # noqa: E402
from ccve_tpu_torch.ops.hashing import murmurhash64_np  # noqa: E402

N_BUILD = 1_000_000
N_PROBE = 16_000_000
N_PROBE_WIDE = 1 << 24
REPS = 10
I32_MAX = 2**31 - 1
I64_MAX = 2**63 - 1
# The card's peaks from NVIDIA's H100 SXM data sheet, for the bounds: HBM
# bandwidth, and the non-tensor float32 rate as the rate of one integer
# compare or add (the data sheet lists no int32 or int64 rate).
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn) -> list[float]:
    """Per-call milliseconds of REPS calls of `fn` by CUDA events, after one
    warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def med(ts) -> float:
    return float(np.median(ts))


# slice 2's wrappers; #7's two entry points share one kernel source
NEW_WRAPPERS = {
    "sort_tiles_multi_i32": (pairsort.sort_tiles_multi_i32,),
    "merge_multi_i32": (pairsort.merge_level_multi_i32, pairsort.merge_two_multi_i32),
    "merge_stats_i32": (merge_scan.merge_stats_i32,),
    "compact_i32": (compact.compact_i32,),
}


# slice 3's wrappers, the int64 builds
WIDE_WRAPPERS = {
    "sort_tiles_i64": (bigsort.sort_tiles_i64,),
    "merge_level_i64": (bigsort.merge_level_i64,),
    "merge_counts_i64": (merge_scan.merge_counts_i64,),
    "sort_tiles_multi_i64": (pairsort.sort_tiles_multi_i64,),
    "merge_multi_i64": (pairsort.merge_level_multi_i64, pairsort.merge_two_multi_i64),
    "merge_stats_i64": (merge_scan.merge_stats_i64,),
}
# slice 4's kernel and the compaction it shares with slice 2, as the hash
# engines launch them
HASH_WRAPPERS = {
    "murmurhash64_i64": (murmur.murmurhash64_i64,),
    "compact_i32": (compact.compact_i32,),
}
HASH_OPS_PER_KEY = 10  # three shifts and xors, two 64-bit multiplies
PROFILED_CALLS = 5  # back-to-back calls in each idle-share trace
LADDER_HIT_PCTS = (5, 25, 50)  # hit rates of phase 22's probes, in percent
WIDE_COUNT = ("sort_tiles_i64", "merge_level_i64", "merge_counts_i64")
WIDE_STATS = ("sort_tiles_multi_i64", "merge_multi_i64", "merge_stats_i64")
# kernels whose plain version is itself the one PyTorch call that computes
# the same function (torch.sort per tile or run pair, torch.searchsorted,
# boolean indexing): their library time is the plain time, not taken twice
LIBRARY_IS_PLAIN = {
    "sort_tiles_i32", "merge_level_i32", "merge_counts_i32", "compact_i32",
    "sort_tiles_i64", "merge_level_i64", "merge_counts_i64",
}


def zero_counters(wrappers: dict) -> None:
    for fns in wrappers.values():
        for fn in fns:
            fn.launches = 0


def read_counters(wrappers: dict) -> dict:
    return {name: sum(fn.launches for fn in fns) for name, fns in wrappers.items()}


def bound(nbytes: float, ops: float):
    """(ms, what bounds it): the least time the card could take to move
    `nbytes` through HBM and to do `ops` integer operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ALU_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def log2_ceil(x: int) -> int:
    return max(int(x) - 1, 0).bit_length()


def idle_share(fn) -> tuple[float, int]:
    """(the device's idle share, device events) over PROFILED_CALLS
    back-to-back calls of `fn` under torch.profiler: 1 - busy / window, as
    bench/profile_config1.py takes it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    events = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError("torch.profiler recorded no device events")
    busy, window = busy_window(events)
    return 1 - busy / window, len(events)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        raise AssertionError(f"{torch.cuda.device_count()} devices visible, expected 1")

    # ---- 1. device -------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    log(f"phase build: ok ({time.perf_counter() - t0:.1f} s, {_build.LIB_PATH.name})")

    wrappers = {
        "sort_tiles_i32": bigsort.sort_tiles_i32,
        "merge_level_i32": bigsort.merge_level_i32,
        "merge_counts_i32": merge_scan.merge_counts_i32,
    }
    max_err = dict.fromkeys([*wrappers, *NEW_WRAPPERS, *WIDE_WRAPPERS, *HASH_WRAPPERS], 0)

    def same(name: str, got, want, what: str):
        """Exact equality of a kernel's output with its plain version's:
        a tensor, or a (keys, [planes]) / (a, b) structure of them."""
        if isinstance(want, (tuple, list)):
            if len(got) != len(want):
                raise AssertionError(f"{name} {what}: {len(got)} outputs vs {len(want)}")
            for g, w in zip(got, want):
                same(name, g, w, what)
            return
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {what}: {got.shape}/{got.dtype} "
                                 f"vs plain {want.shape}/{want.dtype}")
        err = 0
        if got.numel():
            err = int((got.long() - want.long()).abs().max())
        max_err[name] = max(max_err[name], err)
        if err:
            raise AssertionError(f"{name} {what}: max |kernel - plain| = {err}")

    # ---- 3. kernels against plain versions, small ragged shapes ------------
    rng = np.random.default_rng(0)

    def values(n, dom=None):
        if dom is None:
            v = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64)
        else:
            v = rng.integers(0, dom, n)
        return torch.from_numpy(v.astype(np.int32)).cuda()

    for tile_log in (bigsort.TILE_LOG, 11, 4, 1):
        for nt in (1, 3, 13):
            for dom in (None, 7):
                x = values(nt << tile_log, dom)
                same("sort_tiles_i32", bigsort.sort_tiles_i32(x, tile_log),
                     bigsort.sort_tiles_plain(x, tile_log),
                     f"tile_log={tile_log} nt={nt}")
    for n in (1, 5, 2049, 10_000, 13 << 11):
        for dom in (None, 3):
            runs = values(n, dom)  # runs of one value are sorted
            for run_log in range(0, 16):
                same("merge_level_i32", bigsort.merge_level_i32(runs, run_log),
                     bigsort.merge_level_plain(runs, run_log),
                     f"n={n} run_log={run_log}")
                runs = bigsort.merge_level_plain(runs, run_log)
    for nt in (1, 2, 3, 5, 13):
        x = values(nt << bigsort.TILE_LOG)
        for run_log in range(bigsort.TILE_LOG, bigsort.TILE_LOG + 5):
            same("merge_level_i32", bigsort.sort_runs(x, run_log),
                 bigsort.sort_runs_plain(x, run_log),
                 f"sort_runs nt={nt} run_log={run_log}")

    def counts_case(n, m, run_log, dom, builds, what):
        probes = rng.integers(0, dom + 8, n).astype(np.int64) * 2  # some above every build
        probes[: min(n, 5)] = 0  # clamped-low probes
        tile = 1 << 11
        n_pad = n + (-n) % tile
        p = torch.from_numpy(
            np.concatenate([probes, np.full(n_pad - n, I32_MAX)]).astype(np.int32)
        ).cuda()
        runs = bigsort.sort_runs_plain(p, run_log, 11)
        b32 = torch.from_numpy((np.sort(builds) * 2 + 3).astype(np.int32)).cuda()
        same("merge_counts_i32",
             merge_scan.merge_counts_i32(runs, 1 << run_log, n, b32, m),
             merge_scan.merge_counts_plain(runs, 1 << run_log, n, b32, m), what)

    counts_case(100_000, 30_000, 11, 40_000, rng.choice(40_000, 30_000, replace=False), "many runs")
    counts_case(40_000, 70_000, 13, 50_000, rng.integers(0, 50_000, 70_000), "dup builds, m > n")
    counts_case(33_333, 100, 14, 1000, rng.integers(0, 1000, 100), "ragged n")
    counts_case(300_000, 5_000, 16, 200_000, rng.integers(40_000, 40_500, 5_000), "clustered builds")
    counts_case(0, 10, 11, 50, np.arange(10), "no probes")
    counts_case(4096, 1, 11, 3, np.array([1]), "one build")
    torch.cuda.synchronize()
    log(f"phase kernels (small shapes): ok, max |kernel - plain| {max_err}")

    # ---- 4. the config-1 slice through bulk_count --------------------------
    t0 = time.perf_counter()
    keys, payloads = gen_rhs_table(N_BUILD, 1)
    probe = gen_probe_table(N_PROBE, 1, N_BUILD)
    order = np.argsort(keys, kind="stable")
    prefix = np.concatenate([[0], np.cumsum(payloads[order])])
    lo = np.searchsorted(keys[order], probe[:, 0], side="left")
    hi = np.searchsorted(keys[order], probe[:, 0], side="right")
    want_count = int((hi - lo).sum())
    want_checksum = int((prefix[hi] - prefix[lo]).sum())
    log(f"phase data: ok ({time.perf_counter() - t0:.1f} s), numpy count "
        f"{want_count}, checksum {want_checksum}")

    table = sm.build_sorted(keys, payloads, device="cuda")
    probe_dev = torch.from_numpy(probe.astype(np.int32)).cuda()
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    res = bulk_count([table], probe_dev)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    count, checksum = int(res.count), int(res.payload_checksums[0])
    if (count, checksum) != (want_count, want_checksum):
        raise AssertionError(f"bulk_count gave ({count}, {checksum}), numpy "
                             f"({want_count}, {want_checksum})")
    idle = [name for name, k in launches.items() if k == 0]
    if idle:
        raise AssertionError(f"kernels not launched by bulk_count: {idle}")

    col = probe_dev[:, 0].contiguous()
    p32, b32 = sm.pack32_streams(table, col)
    n, m = p32.numel(), b32.numel()
    n_pad, run_log = sm.count_side_plan(n, m, bigsort.TILE_LOG)
    padded = torch.cat([p32, p32.new_full((n_pad - n,), I32_MAX)])

    def plain_totals():
        runs = bigsort.sort_runs_plain(padded, run_log)
        bc = merge_scan.merge_counts_plain(runs, 1 << run_log, n, b32, m).long()
        return bc.sum(), (bc * table.payloads).sum()

    pc, ps = plain_totals()
    if (int(pc), int(ps)) != (want_count, want_checksum):
        raise AssertionError(f"plain path gave ({int(pc)}, {int(ps)})")
    n_runs = -(-n_pad // (1 << run_log))
    log(f"phase slice: ok, bulk_count count {count} checksum {checksum} "
        f"(numpy and plain path agree); launches {launches}; "
        f"{n_runs} runs of 2^{run_log}, n_pad {n_pad}")

    # ---- 5. kernels at the slice's shapes, and times -----------------------
    tile_log = bigsort.TILE_LOG
    levels = list(range(tile_log, tile_log + launches["merge_level_i32"]))
    tiles = bigsort.sort_tiles_i32(padded, tile_log)
    same("sort_tiles_i32", tiles, bigsort.sort_tiles_plain(padded, tile_log), "config 1")
    level_in = [tiles]
    for lv in levels:
        out = bigsort.merge_level_i32(level_in[-1], lv)
        same("merge_level_i32", out,
             bigsort.merge_level_plain(level_in[-1], lv), f"config 1 run_log={lv}")
        level_in.append(out)
    runs = level_in.pop()
    same("merge_counts_i32",
         merge_scan.merge_counts_i32(runs, 1 << run_log, n, b32, m),
         merge_scan.merge_counts_plain(runs, 1 << run_log, n, b32, m), "config 1")
    torch.cuda.synchronize()
    log(f"phase kernels (config-1 shapes): ok, max |kernel - plain| {max_err}")

    def level_ms(fn):
        return sum(med(cuda_ms(lambda x=x, lv=lv: fn(x, lv))) for x, lv in zip(level_in, levels))

    kernel_ms = {
        "sort_tiles_i32": (
            med(cuda_ms(lambda: bigsort.sort_tiles_i32(padded, tile_log))),
            med(cuda_ms(lambda: bigsort.sort_tiles_plain(padded, tile_log))),
        ),
        "merge_level_i32": (
            level_ms(bigsort.merge_level_i32), level_ms(bigsort.merge_level_plain)
        ),
        "merge_counts_i32": (
            med(cuda_ms(lambda: merge_scan.merge_counts_i32(runs, 1 << run_log, n, b32, m))),
            med(cuda_ms(lambda: merge_scan.merge_counts_plain(runs, 1 << run_log, n, b32, m))),
        ),
    }
    # (bytes, operations) of each kernel's work in one bulk_count: keys read
    # and written once per launch; tile_log compares per key in the tile
    # sort, one per key and level in the merges, two binary searches per
    # build row and run in the counts
    work = {
        "sort_tiles_i32": (8 * n_pad, n_pad * tile_log),
        "merge_level_i32": (8 * n_pad * len(levels), n_pad * len(levels)),
        "merge_counts_i32": (4 * (n + 2 * m), 2 * m * n_runs * log2_ceil(1 << run_log)),
    }
    # end to end, in turns: plain, kernel, kernel, plain
    e2e = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = plain_totals if which == "plain" else (lambda: bulk_count([table], probe_dev))
        e2e[which] += cuda_ms(fn)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    bulk_count([table], probe_dev)
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    k_ms, p_ms = med(e2e["kernel"]), med(e2e["plain"])
    log(f"times on [{card}], CUDA events, median of {2 * REPS}:")
    log(f"  bulk_count config 1 (1M build x 16M probe), kernel path: {k_ms:.4f} ms "
        f"= {N_PROBE / k_ms / 1e3:.1f}M probe rows/s "
        f"(min {min(e2e['kernel']):.4f}, max {max(e2e['kernel']):.4f}); "
        f"peak extra device memory {peak_mib:.1f} MiB")
    log(f"  all-plain torch path: {p_ms:.4f} ms = {N_PROBE / p_ms / 1e3:.1f}M probe rows/s "
        f"(min {min(e2e['plain']):.4f}, max {max(e2e['plain']):.4f})")
    for name, (kt, pt) in kernel_ms.items():
        log(f"  {name}: kernel {kt:.4f} ms, plain {pt:.4f} ms "
            f"({launches[name]} launch(es) per bulk_count)")
    glue = k_ms - sum(kt for kt, _ in kernel_ms.values())
    log(f"  outside the kernels (pack, pad, sums, allocation): {glue:.4f} ms")

    # ---- 6. the benchmark entry point --------------------------------------
    result = config1_single_join(device="cuda")
    log(f"phase config1_single_join: ok {json.dumps(result)}")

    # ---- 7. slice 2's kernels against plain versions, small ragged shapes --
    t0 = time.perf_counter()

    def planes_of(n, count, dom=None):
        return [values(n, dom) for _ in range(count)]

    for tile_log in (pairsort.TILE_LOG, 11, 4, 1):
        for n_planes in (1, 2, 3):
            for dom in (None, 3):
                keys_s, vals_s = values(3 << tile_log, dom), planes_of(3 << tile_log, n_planes)
                same("sort_tiles_multi_i32",
                     pairsort.sort_tiles_multi_i32(keys_s, vals_s, tile_log),
                     pairsort.sort_tiles_multi_plain(keys_s, vals_s, tile_log),
                     f"tile_log={tile_log} P={n_planes}")
    for n in (1, 5, 2049, 10_000, 3 << 13):
        for n_planes in (1, 3):
            keys_s, vals_s = values(n, 3), planes_of(n, n_planes)  # runs of one value are sorted
            for run_log in range(16):
                same("merge_multi_i32", pairsort.merge_level_multi_i32(keys_s, vals_s, run_log),
                     pairsort.merge_level_multi_plain(keys_s, vals_s, run_log),
                     f"level n={n} P={n_planes} run_log={run_log}")
                keys_s, vals_s = pairsort.merge_level_multi_plain(keys_s, vals_s, run_log)
    for na, nb in ((0, 0), (0, 9), (9, 0), (3000, 2100), (1, 70_000), (100_003, 17)):
        for n_planes in (1, 2, 3):
            ak, bk = values(na, 50).sort().values, values(nb, 50).sort().values
            avs, bvs = planes_of(na, n_planes), planes_of(nb, n_planes)
            same("merge_multi_i32", pairsort.merge_two_multi_i32(ak, avs, bk, bvs),
                 pairsort.merge_two_multi_plain(ak, avs, bk, bvs),
                 f"merge two {na}+{nb} P={n_planes}")
    for n in (1, 8191, 8193, 100_000):
        keys_s, vals_s = values(n), planes_of(n, 2)
        same("sort_tiles_multi_i32", pairsort.sort_multi_i32(keys_s, vals_s),
             pairsort.sort_multi_plain(keys_s, vals_s), f"sort_multi n={n}")
        for run_log in (pairsort.TILE_LOG, pairsort.TILE_LOG + 2):
            same("merge_multi_i32", pairsort.sort_multi_i32_runs(keys_s, vals_s, run_log),
                 pairsort.sort_multi_runs_plain(keys_s, vals_s, run_log),
                 f"sort_multi_runs n={n} run_log={run_log}")

    def stats_case(n, m, dom, pay_lo, pay_hi, what, pad=0):
        builds = np.sort(rng.integers(0, dom, m))
        probes = rng.integers(0, dom + 3, n)  # some above every build
        s_np = np.concatenate([builds * 2, probes * 2 + 1])
        v_np = np.concatenate([rng.integers(pay_lo, pay_hi, m), np.arange(n)])
        order = np.argsort(s_np, kind="stable")
        s_np = np.concatenate([s_np[order], np.full(pad, I32_MAX)])
        v_np = np.concatenate([v_np[order], np.zeros(pad, np.int64)])
        s_d = torch.from_numpy(s_np.astype(np.int32)).cuda()
        v_d = torch.from_numpy(v_np.astype(np.int32)).cuda()
        same("merge_stats_i32", merge_scan.merge_stats_i32(s_d, v_d, n),
             merge_scan.merge_stats_plain(s_d, v_d, n), what)

    stats_case(0, 10, 5, 0, 9, "no probes")
    stats_case(10, 0, 5, 0, 9, "no builds")
    stats_case(50_000, 30_000, 5000, 0, 2**20, "duplicate builds")
    stats_case(70_000, 2000, 300, 2**29, 2**30, "psum past 2^31")
    stats_case(40_000, 15_000, 700, -(2**31), 2**31 - 1, "negative payloads")
    stats_case(300_000, 5, 2, 0, 1, "zero payloads, long runs")
    stats_case(30_000, 9000, 1000, 0, 100, "sort padding at the end", pad=777)
    for n_planes in (1, 2, 3):
        for n in (1, 2047, 2049, 100_003):
            for fill in ("all", "none", "random"):
                planes_c = torch.stack(planes_of(n, n_planes))
                mask_np = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
                           "random": rng.random(n) < 0.4}[fill]
                mask_c = torch.from_numpy(mask_np).cuda()
                same("compact_i32", compact.compact_i32(planes_c, mask_c),
                     compact.compact_plain(planes_c, mask_c), f"C={n_planes} n={n} {fill}")
    torch.cuda.synchronize()
    log(f"phase slice-2 kernels (small shapes): ok ({time.perf_counter() - t0:.1f} s), "
        f"max |kernel - plain| {max_err}")

    def path_kernels(tbl, col, path, key="i32"):
        """The stats side's kernel route step by step at a path's shapes,
        on int32 (`key` "i32") or int64 ("i64") keys, each kernel against
        its plain version on the same input; returns the inputs, for the
        times."""
        tl = pairsort.TILE_LOG
        n = col.numel()
        pack = sm.stats_pack32_streams if key == "i32" else sm.stats_pack64_streams
        sort_tiles = getattr(pairsort, f"sort_tiles_multi_{key}")
        merge_level = getattr(pairsort, f"merge_level_multi_{key}")
        merge_two = getattr(pairsort, f"merge_two_multi_{key}")
        b32, p32 = pack(tbl, col)
        rows = torch.arange(n, dtype=torch.int32, device=col.device)
        pk, pv = pairsort.pad_to_tile(p32, [rows], tl)
        level_in = [sort_tiles(pk, pv, tl)]
        same(f"sort_tiles_multi_{key}", level_in[0], pairsort.sort_tiles_multi_plain(pk, pv, tl), path)
        for lv in range(max((pk.numel() >> tl) - 1, 0).bit_length()):
            k, v = level_in[-1]
            level_in.append(merge_level(k, v, tl + lv))
            same(f"merge_multi_{key}", level_in[-1],
                 pairsort.merge_level_multi_plain(k, v, tl + lv), f"{path} level {tl + lv}")
        sk, sv = level_in.pop()
        two = (sk[:n], [x[:n] for x in sv], b32, [tbl.payloads.to(torch.int32)])
        merged = merge_two(*two)
        same(f"merge_multi_{key}", merged, pairsort.merge_two_multi_plain(*two), f"{path} merge two")
        return {"tile": (pk, pv), "levels": level_in, "two": two, "merged": merged}

    def path_ms(inputs, key="i32"):
        """(kernel ms, plain ms) of the sort and merges of one call."""
        tl = pairsort.TILE_LOG
        pk, pv = inputs["tile"]
        two = inputs["two"]
        sort_tiles = getattr(pairsort, f"sort_tiles_multi_{key}")
        merge_level = getattr(pairsort, f"merge_level_multi_{key}")
        merge_two = getattr(pairsort, f"merge_two_multi_{key}")

        def levels(fn):
            return sum(med(cuda_ms(lambda k=k, v=v, r=tl + i: fn(k, v, r)))
                       for i, (k, v) in enumerate(inputs["levels"]))

        return {
            f"sort_tiles_multi_{key}": (
                med(cuda_ms(lambda: sort_tiles(pk, pv, tl))),
                med(cuda_ms(lambda: pairsort.sort_tiles_multi_plain(pk, pv, tl))),
            ),
            f"merge_multi_{key}": (
                levels(merge_level) + med(cuda_ms(lambda: merge_two(*two))),
                levels(pairsort.merge_level_multi_plain)
                + med(cuda_ms(lambda: pairsort.merge_two_multi_plain(*two))),
            ),
        }

    def path_work(inputs):
        """(bytes, operations) of the multi-plane sort and of the merges of
        one call: each key and plane read and written once per launch; a
        tile sort's tile_log compares per key, a merge's one."""
        tl = pairsort.TILE_LOG
        pk, pv = inputs["tile"]
        width = pk.element_size() + 4 * len(pv)
        n_pad, n_levels = pk.numel(), len(inputs["levels"])
        merged = inputs["merged"][0].numel()
        return {
            "sort": (2 * n_pad * width, n_pad * tl),
            "merge": (2 * (n_levels * n_pad + merged) * width, n_levels * n_pad + merged),
        }

    def in_turns(kernel_fn, plain_fn):
        """CUDA-event ms of both, in turns plain, kernel, kernel, plain."""
        e = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            e[which] += cuda_ms(plain_fn if which == "plain" else kernel_fn)
        return e

    def spread(ts):
        return f"{med(ts):.4f} ms (min {min(ts):.4f}, max {max(ts):.4f})"

    # ---- 8. config 3's bulk engine at full size ----------------------------
    t0 = time.perf_counter()
    tables3, probe3, (want3, want3_chk) = config3_data(1_000_000, 50_000, torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"phase config-3 data: ok ({time.perf_counter() - t0:.1f} s), oracle count "
        f"{want3}, checksums {want3_chk}")
    zero_counters(NEW_WRAPPERS)
    res3 = bulk_count(tables3, probe3)
    torch.cuda.synchronize()
    launches3 = read_counters(NEW_WRAPPERS)
    got3 = (int(res3.count), [int(c) for c in res3.payload_checksums])
    if got3 != (want3, want3_chk):
        raise AssertionError(f"config 3 bulk_count gave {got3}, oracle {(want3, want3_chk)}")
    idle = [k for k in ("sort_tiles_multi_i32", "merge_multi_i32", "merge_stats_i32")
            if launches3[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched by config 3's bulk_count: {idle}")
    cols3 = [probe3[:, level].contiguous() for level in range(len(tables3))]

    def plain3():
        return combine_levels([sm.sorted_match_stats(t, c, route=sm.PLAIN)
                               for t, c in zip(tables3, cols3)])

    res3p = plain3()
    if (int(res3p.count), [int(c) for c in res3p.payload_checksums]) != got3:
        raise AssertionError("config 3: the all-plain path disagrees")
    log(f"phase config 3: ok, bulk_count count {got3[0]} checksums {got3[1]} "
        f"(oracle and plain path agree); launches {launches3}")
    inputs3 = path_kernels(tables3[0], cols3[0], "config 3")
    ms3, mv3 = inputs3["merged"]
    mv3 = mv3[0]
    n3 = cols3[0].numel()
    same("merge_stats_i32", merge_scan.merge_stats_i32(ms3, mv3, n3),
         merge_scan.merge_stats_plain(ms3, mv3, n3), "config 3")
    torch.cuda.synchronize()
    log(f"phase kernels (config-3 shapes): ok, max |kernel - plain| {max_err}")
    ms_cfg3 = path_ms(inputs3)
    ms_cfg3["merge_stats_i32"] = (
        med(cuda_ms(lambda: merge_scan.merge_stats_i32(ms3, mv3, n3))),
        med(cuda_ms(lambda: merge_scan.merge_stats_plain(ms3, mv3, n3))),
    )
    L3 = ms3.numel()
    # the stats scan reads the stream and its plane and writes mult and
    # psum per probe row; a few operations (compare, tag, two adds) per
    # element
    work["merge_stats_i32"] = (8 * L3 + 12 * n3, 4 * L3)
    e3 = in_turns(lambda: bulk_count(tables3, probe3), plain3)
    log(f"times on [{card}], CUDA events, medians (per level: 1M probes, 50K builds):")
    log(f"  bulk_count config 3 (1M x 4 levels), kernel path: {spread(e3['kernel'])} "
        f"= {1e6 / med(e3['kernel']) / 1e3:.1f}M probe rows/s")
    log(f"  all-plain torch path: {spread(e3['plain'])}")
    for name, (kt, pt) in ms_cfg3.items():
        log(f"  {name}: kernel {kt:.4f} ms, plain {pt:.4f} ms per level "
            f"({launches3[name]} launch(es) per bulk_count)")

    # ---- 9. config 1 materialized at full size (phase 4's data) ------------
    col1 = probe_dev[:, 0].contiguous()
    zero_counters(NEW_WRAPPERS)
    tiles, total = sm.sorted_expand_tiled(table, col1)
    torch.cuda.synchronize()
    launches_m = read_counters(NEW_WRAPPERS)
    psum_m = sum(int(t[2].sum()) for t in tiles)
    if (total, psum_m) != (want_count, want_checksum):
        raise AssertionError(f"sorted_expand_tiled gave ({total}, {psum_m}), numpy "
                             f"({want_count}, {want_checksum})")
    sampled = check_sampled_triples(tiles, probe[:, 0], keys, payloads)
    idle = [k for k in ("sort_tiles_multi_i32", "merge_multi_i32", "compact_i32")
            if launches_m[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched by sorted_expand_tiled: {idle}")
    cap = col1.numel() * max(table.max_mult, 1)
    got_m = sm.sorted_expand(table, col1, cap)
    want_m = sm.sorted_expand(table, col1, cap, route=sm.PLAIN)
    for g, w in zip(got_m, want_m):
        if not torch.equal(g, w):
            raise AssertionError("sorted_expand: the kernel and all-plain routes disagree")
    log(f"phase config-1 materialize: ok, {len(tiles)} tile(s), {total} triples, "
        f"payload sum {psum_m} (numpy agrees), {sampled} sampled triples match the "
        f"generators, all-plain route identical; launches {launches_m}")
    inputs_m = path_kernels(table, col1, "materialize")
    planes_m, valid_m, _ = sm.expand_candidates(table, col1)
    same("compact_i32", compact.compact_i32(planes_m, valid_m),
         compact.compact_plain(planes_m, valid_m), "materialize")
    torch.cuda.synchronize()
    log(f"phase kernels (materialize shapes): ok, max |kernel - plain| {max_err}")
    ms_mat = path_ms(inputs_m)
    ms_mat["compact_i32"] = (
        med(cuda_ms(lambda: compact.compact_i32(planes_m, valid_m))),
        med(cuda_ms(lambda: compact.compact_plain(planes_m, valid_m))),
    )
    w_m = path_work(inputs_m)
    n_c = planes_m.shape[1]
    work["sort_tiles_multi_i32"] = w_m["sort"]
    work["merge_multi_i32"] = w_m["merge"]
    # the compaction reads C planes and the mask and writes C planes
    work["compact_i32"] = (8 * planes_m.numel() + n_c, n_c * planes_m.shape[0])
    em = in_turns(lambda: sm.sorted_expand_tiled(table, col1),
                  lambda: sm.sorted_expand_tiled(table, col1, route=sm.PLAIN))
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    sm.sorted_expand_tiled(table, col1)
    torch.cuda.synchronize()
    peak_m = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    log(f"times on [{card}], CUDA events, medians:")
    log(f"  sorted_expand_tiled config 1 (1M build x 16M probe, {total} triples), "
        f"kernel path: {spread(em['kernel'])} = "
        f"{total / med(em['kernel']) / 1e3:.1f}M triples/s; peak extra device "
        f"memory {peak_m:.1f} MiB")
    log(f"  all-plain torch path: {spread(em['plain'])}")
    for name, (kt, pt) in ms_mat.items():
        log(f"  {name}: kernel {kt:.4f} ms, plain {pt:.4f} ms "
            f"({launches_m[name]} launch(es) per call)")

    # ---- 10. duplicate keys: mult > 1 and the F > 1 expand loop ------------
    t0 = time.perf_counter()
    keys_d, pays_d = gen_rhs_table(262_144, 4)
    probe_d = gen_probe_table(4_000_000, 1, 262_144)[:, 0]
    table_d = sm.build_sorted(keys_d, pays_d, device="cuda")
    col_d = torch.from_numpy(probe_d.astype(np.int32)).cuda()
    zero_counters(NEW_WRAPPERS)
    stats_d = sm.sorted_match_stats(table_d, col_d)
    tiles_d, total_d = sm.sorted_expand_tiled(table_d, col_d)
    torch.cuda.synchronize()
    launches_d = read_counters(NEW_WRAPPERS)
    order_d = np.argsort(keys_d, kind="stable")
    sk_d, sp_d = keys_d[order_d], pays_d[order_d]
    lo_d = np.searchsorted(sk_d, probe_d, side="left")
    hi_d = np.searchsorted(sk_d, probe_d, side="right")
    mult_d = hi_d - lo_d
    prefix_d = np.concatenate([[0], np.cumsum(sp_d)])
    if not (np.array_equal(stats_d.mult.cpu().numpy(), mult_d)
            and np.array_equal(stats_d.psum.cpu().numpy(), prefix_d[hi_d] - prefix_d[lo_d])):
        raise AssertionError("duplicate keys: per-probe stats disagree with numpy")
    if total_d != int(mult_d.sum()) or int(mult_d.max()) != 4:
        raise AssertionError(f"duplicate keys: total {total_d}, numpy {int(mult_d.sum())}")
    got_t = [torch.cat([t[i][t[0] >= 0] for t in tiles_d]).cpu().numpy() for i in range(3)]
    # the oracle's FULL-mode rows of (key, row id) probes: (key, row, key, payload)
    want_rows = oracle_join(np.stack([probe_d, np.arange(probe_d.size)], axis=1), 0,
                            OracleBuildTable(keys_d, pays_d), PayloadMode.FULL)
    want_t = [want_rows[:, 1], want_rows[:, 2], want_rows[:, 3]]

    def by_row_payload(cols):
        order = np.lexsort((cols[2], cols[0]))
        return [c[order] for c in cols]

    if not all(np.array_equal(g, w) for g, w in
               zip(by_row_payload(got_t), by_row_payload(want_t))):
        raise AssertionError("duplicate keys: the triple multiset disagrees with numpy")
    idle = [k for k, v in launches_d.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels not launched by the duplicate-key phase: {idle}")
    log(f"phase duplicate keys: ok ({time.perf_counter() - t0:.1f} s), 262144 build rows "
        f"(4 per key) x 4M probes: stats and {total_d} triples match numpy; "
        f"launches {launches_d}")

    # ---- 11. the benchmark entry points ------------------------------------
    result = config3_four_way(device="cuda")
    log(f"phase config3_four_way: ok {json.dumps(result)}")
    result = config1_materialize(device="cuda")
    log(f"phase config1_materialize: ok {json.dumps(result)}")

    # ---- 12. slice 3's int64 kernels against plain versions, small shapes -
    t0 = time.perf_counter()

    def wide_values(n, dom=None):
        """int64 keys: half near ±2^62, some at the int64 extremes, the
        rest over the range; or uniform in [0, dom)."""
        if dom is not None:
            return torch.from_numpy(rng.integers(0, dom, n).astype(np.int64)).cuda()
        v = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
        near = rng.random(n) < 0.5
        k = int(near.sum())
        v[near] = rng.integers(2**62 - 64, 2**62 + 64, k) * rng.choice([-1, 1], k)
        v[rng.random(n) < 0.02] = I64_MAX
        v[rng.random(n) < 0.02] = -(2**63)
        return torch.from_numpy(v).cuda()

    for tile_log_w in (bigsort.TILE_LOG, 11, 4, 1):
        for nt in (1, 3, 13):
            for dom in (None, 7):
                x = wide_values(nt << tile_log_w, dom)
                same("sort_tiles_i64", bigsort.sort_tiles_i64(x, tile_log_w),
                     bigsort.sort_tiles_plain(x, tile_log_w), f"tile_log={tile_log_w} nt={nt}")
    for n_w in (1, 5, 2049, 10_000, 13 << 11):
        for dom in (None, 3):
            runs_w = wide_values(n_w, dom)  # runs of one value are sorted
            for run_log_w in range(16):
                same("merge_level_i64", bigsort.merge_level_i64(runs_w, run_log_w),
                     bigsort.merge_level_plain(runs_w, run_log_w), f"n={n_w} run_log={run_log_w}")
                runs_w = bigsort.merge_level_plain(runs_w, run_log_w)
    for nt in (1, 2, 3, 5, 13):
        x = wide_values(nt << bigsort.TILE_LOG)
        for run_log_w in range(bigsort.TILE_LOG, bigsort.TILE_LOG + 5):
            same("merge_level_i64", bigsort.sort_runs(x, run_log_w),
                 bigsort.sort_runs_plain(x, run_log_w), f"sort_runs nt={nt} run_log={run_log_w}")

    def counts64_case(n_c, m_c, run_log_c, dom, builds, what):
        base = 2**61 - 4 * dom  # packed keys near 2^62
        probes = (base + rng.integers(0, dom + 8, n_c)) * 2
        probes[: min(n_c, 5)] = 0  # clamped-low probes
        n_pad_c = n_c + (-n_c) % (1 << 11)
        p = torch.from_numpy(np.concatenate([probes, np.full(n_pad_c - n_c, I64_MAX)])).cuda()
        runs_c = bigsort.sort_runs_plain(p, run_log_c, 11)
        b = torch.from_numpy((base + np.sort(builds)) * 2 + 1).cuda()
        same("merge_counts_i64", merge_scan.merge_counts_i64(runs_c, 1 << run_log_c, n_c, b, m_c),
             merge_scan.merge_counts_plain(runs_c, 1 << run_log_c, n_c, b, m_c), what)

    counts64_case(100_000, 30_000, 11, 40_000, rng.choice(40_000, 30_000, replace=False), "many runs")
    counts64_case(40_000, 70_000, 13, 50_000, rng.integers(0, 50_000, 70_000), "dup builds, m > n")
    counts64_case(33_333, 100, 14, 1000, rng.integers(0, 1000, 100), "ragged n")
    counts64_case(0, 10, 11, 50, np.arange(10), "no probes")
    counts64_case(4096, 1, 11, 3, np.array([1]), "one build")

    for tile_log_w in (pairsort.TILE_LOG, 11, 4, 1):
        for n_planes in (1, 2, 3):
            for dom in (None, 3):
                keys_s, vals_s = wide_values(3 << tile_log_w, dom), planes_of(3 << tile_log_w, n_planes)
                same("sort_tiles_multi_i64",
                     pairsort.sort_tiles_multi_i64(keys_s, vals_s, tile_log_w),
                     pairsort.sort_tiles_multi_plain(keys_s, vals_s, tile_log_w),
                     f"tile_log={tile_log_w} P={n_planes}")
    for n_w in (1, 5, 2049, 10_000, 3 << 13):
        for n_planes in (1, 3):
            keys_s, vals_s = wide_values(n_w, 3), planes_of(n_w, n_planes)
            for run_log_w in range(16):
                same("merge_multi_i64", pairsort.merge_level_multi_i64(keys_s, vals_s, run_log_w),
                     pairsort.merge_level_multi_plain(keys_s, vals_s, run_log_w),
                     f"level n={n_w} P={n_planes} run_log={run_log_w}")
                keys_s, vals_s = pairsort.merge_level_multi_plain(keys_s, vals_s, run_log_w)
    for na, nb in ((0, 0), (0, 9), (9, 0), (3000, 2100), (1, 70_000), (100_003, 17)):
        for n_planes in (1, 2, 3):
            ak, bk = wide_values(na).sort().values, wide_values(nb).sort().values
            avs, bvs = planes_of(na, n_planes), planes_of(nb, n_planes)
            same("merge_multi_i64", pairsort.merge_two_multi_i64(ak, avs, bk, bvs),
                 pairsort.merge_two_multi_plain(ak, avs, bk, bvs), f"merge two {na}+{nb} P={n_planes}")
    for n_w in (1, 8191, 8193, 100_000):
        keys_s, vals_s = wide_values(n_w), planes_of(n_w, 2)
        same("sort_tiles_multi_i64", pairsort.sort_multi_i64(keys_s, vals_s),
             pairsort.sort_multi_plain(keys_s, vals_s), f"sort_multi n={n_w}")

    def stats64_case(n_s, m_s, dom, pay_lo, pay_hi, what, pad=0):
        base = 2**61  # key' near 2^61: the packed stream near 2^62
        builds = np.sort(rng.integers(0, dom, m_s))
        probes = rng.integers(0, dom + 3, n_s)
        s_np = np.concatenate([(base + builds) * 2, (base + probes) * 2 + 1])
        v_np = np.concatenate([rng.integers(pay_lo, pay_hi, m_s), np.arange(n_s)])
        order = np.argsort(s_np, kind="stable")
        s_np = np.concatenate([s_np[order], np.full(pad, I64_MAX)])
        v_np = np.concatenate([v_np[order], np.zeros(pad, np.int64)])
        s_d = torch.from_numpy(s_np).cuda()
        v_d = torch.from_numpy(v_np.astype(np.int32)).cuda()
        same("merge_stats_i64", merge_scan.merge_stats_i64(s_d, v_d, n_s),
             merge_scan.merge_stats_plain(s_d, v_d, n_s), what)

    stats64_case(0, 10, 5, 0, 9, "no probes")
    stats64_case(10, 0, 5, 0, 9, "no builds")
    stats64_case(50_000, 30_000, 5000, 0, 2**20, "duplicate builds")
    stats64_case(70_000, 2000, 300, 2**29, 2**30, "psum past 2^31")
    stats64_case(40_000, 15_000, 700, -(2**31), 2**31 - 1, "negative payloads")
    stats64_case(300_000, 5, 2, 0, 1, "zero payloads, long runs")
    stats64_case(30_000, 9000, 1000, 0, 100, "sort padding at the end", pad=777)
    torch.cuda.synchronize()
    log(f"phase slice-3 kernels (small shapes): ok ({time.perf_counter() - t0:.1f} s), "
        f"max |kernel - plain| {max_err}")

    # ---- 13. config1_wide at full size: the int64 count side --------------
    t0 = time.perf_counter()
    keys_w, pays_w, probe_w = config1_wide_host(N_BUILD, N_PROBE_WIDE, 40)
    want_w = numpy_totals(keys_w, pays_w, probe_w)
    sk_w = np.sort(keys_w)
    lo_w = np.searchsorted(sk_w, probe_w, side="left")
    hi_w = np.searchsorted(sk_w, probe_w, side="right")
    table_w = sm.build_sorted(keys_w, pays_w)
    if table_w.pack32 is not None or not table_w.span62:
        raise AssertionError("config1_wide's table is not a wide one")
    col_w = torch.from_numpy(probe_w).cuda()
    torch.cuda.synchronize()
    log(f"phase config1_wide data: ok ({time.perf_counter() - t0:.1f} s), numpy count "
        f"{want_w[0]}, checksum {want_w[1]}")
    zero_counters(WIDE_WRAPPERS)
    res_w = bulk_count([table_w], col_w.view(-1, 1))
    torch.cuda.synchronize()
    launches_w = read_counters(WIDE_WRAPPERS)
    got_w = (int(res_w.count), int(res_w.payload_checksums[0]))
    if got_w != want_w:
        raise AssertionError(f"config1_wide bulk_count gave {got_w}, numpy {want_w}")
    idle = [k for k in WIDE_COUNT if launches_w[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched by config1_wide's bulk_count: {idle}")
    tot_w = sm.sorted_match_totals(table_w, col_w)
    if (int(tot_w[0]), int(tot_w[1])) != want_w:
        raise AssertionError(f"sorted_match_totals gave {tot_w}, numpy {want_w}")
    p64, b64 = sm.pack64_streams(table_w, col_w)
    n_w, m_w = p64.numel(), b64.numel()
    n_pad_w, run_log_w = sm.count_side_plan(n_w, m_w, bigsort.TILE_LOG)
    padded_w = torch.cat([p64, p64.new_full((n_pad_w - n_w,), I64_MAX)])

    def plain_totals_w():
        runs_p = bigsort.sort_runs_plain(padded_w, run_log_w)
        bc = merge_scan.merge_counts_plain(runs_p, 1 << run_log_w, n_w, b64, m_w).long()
        return bc.sum(), (bc * table_w.payloads).sum()

    pc_w, ps_w = plain_totals_w()
    if (int(pc_w), int(ps_w)) != want_w:
        raise AssertionError(f"config1_wide plain path gave ({int(pc_w)}, {int(ps_w)})")
    n_runs_w = -(-n_pad_w // (1 << run_log_w))
    log(f"phase config1_wide: ok, bulk_count and sorted_match_totals count {got_w[0]} "
        f"checksum {got_w[1]} (numpy and plain path agree); launches "
        f"{ {k: launches_w[k] for k in WIDE_COUNT} }; {n_runs_w} runs of 2^{run_log_w}, "
        f"n_pad {n_pad_w}")
    levels_w = list(range(bigsort.TILE_LOG, bigsort.TILE_LOG + launches_w["merge_level_i64"]))
    tiles_w = bigsort.sort_tiles_i64(padded_w)
    same("sort_tiles_i64", tiles_w, bigsort.sort_tiles_plain(padded_w, bigsort.TILE_LOG), "config1_wide")
    level_in_w = [tiles_w]
    for lv in levels_w:
        out = bigsort.merge_level_i64(level_in_w[-1], lv)
        same("merge_level_i64", out, bigsort.merge_level_plain(level_in_w[-1], lv),
             f"config1_wide run_log={lv}")
        level_in_w.append(out)
    runs_w = level_in_w.pop()
    same("merge_counts_i64", merge_scan.merge_counts_i64(runs_w, 1 << run_log_w, n_w, b64, m_w),
         merge_scan.merge_counts_plain(runs_w, 1 << run_log_w, n_w, b64, m_w), "config1_wide")
    torch.cuda.synchronize()
    log(f"phase kernels (config1_wide shapes): ok, max |kernel - plain| {max_err}")
    for name, (kt, pt) in {
        "sort_tiles_i64": (
            med(cuda_ms(lambda: bigsort.sort_tiles_i64(padded_w))),
            med(cuda_ms(lambda: bigsort.sort_tiles_plain(padded_w, bigsort.TILE_LOG))),
        ),
        "merge_level_i64": (
            sum(med(cuda_ms(lambda x=x, lv=lv: bigsort.merge_level_i64(x, lv)))
                for x, lv in zip(level_in_w, levels_w)),
            sum(med(cuda_ms(lambda x=x, lv=lv: bigsort.merge_level_plain(x, lv)))
                for x, lv in zip(level_in_w, levels_w)),
        ),
        "merge_counts_i64": (
            med(cuda_ms(lambda: merge_scan.merge_counts_i64(runs_w, 1 << run_log_w, n_w, b64, m_w))),
            med(cuda_ms(lambda: merge_scan.merge_counts_plain(runs_w, 1 << run_log_w, n_w, b64, m_w))),
        ),
    }.items():
        kernel_ms[name] = (kt, pt)
    work["sort_tiles_i64"] = (16 * n_pad_w, n_pad_w * bigsort.TILE_LOG)
    work["merge_level_i64"] = (16 * n_pad_w * len(levels_w), n_pad_w * len(levels_w))
    work["merge_counts_i64"] = (8 * (n_w + m_w) + 4 * m_w,
                                2 * m_w * n_runs_w * log2_ceil(1 << run_log_w))
    ew = in_turns(lambda: bulk_count([table_w], col_w.view(-1, 1)), plain_totals_w)
    log(f"times on [{card}], CUDA events, medians:")
    log(f"  bulk_count config1_wide (1M build x 2^24 probe, span 2^40), kernel path: "
        f"{spread(ew['kernel'])} = {N_PROBE_WIDE / med(ew['kernel']) / 1e3:.1f}M probe rows/s")
    log(f"  all-plain torch path: {spread(ew['plain'])}")
    for name in WIDE_COUNT:
        kt, pt = kernel_ms[name]
        log(f"  {name}: kernel {kt:.4f} ms, plain {pt:.4f} ms ({launches_w[name]} launch(es) "
            f"per bulk_count)")

    # ---- 14. the wide stats side on phase 13's data ------------------------
    t0 = time.perf_counter()
    zero_counters(WIDE_WRAPPERS)
    stats_w = sm.sorted_match_stats(table_w, col_w)
    torch.cuda.synchronize()
    launches_s = read_counters(WIDE_WRAPPERS)
    prefix_w = np.concatenate([[0], np.cumsum(pays_w[np.argsort(keys_w, kind="stable")])])
    if not (np.array_equal(stats_w.mult.cpu().numpy(), hi_w - lo_w)
            and np.array_equal(stats_w.psum.cpu().numpy(), prefix_w[hi_w] - prefix_w[lo_w])):
        raise AssertionError("config1_wide stats: mult or psum disagree with numpy")
    idle = [k for k in WIDE_STATS if launches_s[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched by the wide sorted_match_stats: {idle}")
    plain_s = sm.sorted_match_stats(table_w, col_w, route=sm.PLAIN)
    if not (torch.equal(plain_s.mult, stats_w.mult) and torch.equal(plain_s.psum, stats_w.psum)):
        raise AssertionError("config1_wide stats: the all-plain route disagrees")
    rt_w = sm.rank_table(table_w)
    zero_counters(WIDE_WRAPPERS)
    mult_r, start_r = sm.sorted_match_ranks(rt_w, col_w)
    torch.cuda.synchronize()
    launches_r = read_counters(WIDE_WRAPPERS)
    live = (hi_w - lo_w) > 0
    if not (np.array_equal(mult_r.cpu().numpy(), hi_w - lo_w)
            and np.array_equal(start_r.cpu().numpy()[live], lo_w[live])):
        raise AssertionError("config1_wide ranks disagree with numpy")
    half = 1 << 20
    probe2 = np.stack([probe_w[:half], probe_w[half : 2 * half]], axis=1)
    rows2 = oracle_pipeline(probe2, [OracleBuildTable(keys_w, pays_w)] * 2, PayloadMode.FULL)
    want2 = (rows2.shape[0], [int(rows2[:, 3].sum()), int(rows2[:, 5].sum())])
    probe2_d = torch.from_numpy(probe2).cuda()
    zero_counters(WIDE_WRAPPERS)
    res2 = bulk_count([table_w, table_w], probe2_d)
    torch.cuda.synchronize()
    launches_2 = read_counters(WIDE_WRAPPERS)
    got2 = (int(res2.count), [int(c) for c in res2.payload_checksums])
    if got2 != want2:
        raise AssertionError(f"2-level wide bulk_count gave {got2}, oracle {want2}")
    for what, lc in (("ranks", launches_r), ("2-level bulk_count", launches_2)):
        idle = [k for k in WIDE_STATS if lc[k] == 0]
        if idle:
            raise AssertionError(f"kernels not launched by the wide {what}: {idle}")
    res2p = combine_levels([sm.sorted_match_stats(table_w, probe2_d[:, i].contiguous(),
                                                  route=sm.PLAIN) for i in range(2)])
    if (int(res2p.count), [int(c) for c in res2p.payload_checksums]) != got2:
        raise AssertionError("2-level wide bulk_count: the all-plain path disagrees")
    log(f"phase config1_wide stats: ok ({time.perf_counter() - t0:.1f} s), mult and psum of "
        f"{N_PROBE_WIDE} rows, ranks and a 2-level bulk_count (count {got2[0]}, checksums "
        f"{got2[1]}) match numpy and its oracle, all-plain identical; launches "
        f"{ {k: launches_s[k] for k in WIDE_STATS} } (stats), "
        f"{ {k: launches_2[k] for k in WIDE_STATS} } (2 levels)")
    inputs_w = path_kernels(table_w, col_w, "config1_wide stats", key="i64")
    ms_w, mv_w = inputs_w["merged"]
    mv_w = mv_w[0]
    same("merge_stats_i64", merge_scan.merge_stats_i64(ms_w, mv_w, n_w),
         merge_scan.merge_stats_plain(ms_w, mv_w, n_w), "config1_wide")
    torch.cuda.synchronize()
    log(f"phase kernels (wide stats shapes): ok, max |kernel - plain| {max_err}")
    kernel_ms.update(path_ms(inputs_w, key="i64"))
    kernel_ms["merge_stats_i64"] = (
        med(cuda_ms(lambda: merge_scan.merge_stats_i64(ms_w, mv_w, n_w))),
        med(cuda_ms(lambda: merge_scan.merge_stats_plain(ms_w, mv_w, n_w))),
    )
    w_w = path_work(inputs_w)
    work["sort_tiles_multi_i64"] = w_w["sort"]
    work["merge_multi_i64"] = w_w["merge"]
    work["merge_stats_i64"] = (12 * ms_w.numel() + 12 * n_w, 4 * ms_w.numel())
    es = in_turns(lambda: sm.sorted_match_stats(table_w, col_w),
                  lambda: sm.sorted_match_stats(table_w, col_w, route=sm.PLAIN))
    log(f"times on [{card}], CUDA events, medians:")
    log(f"  sorted_match_stats config1_wide (1M build x 2^24 probe), kernel path: "
        f"{spread(es['kernel'])}")
    log(f"  all-plain torch path: {spread(es['plain'])}")
    for name in WIDE_STATS:
        kt, pt = kernel_ms[name]
        log(f"  {name}: kernel {kt:.4f} ms, plain {pt:.4f} ms ({launches_s[name]} launch(es) "
            f"per call)")

    # ---- 15. the int64/int32 ratio on config 1's own data ------------------
    p32_c, b32_c = sm.pack32_streams(table, col)
    p64_c, b64_c = p32_c.long(), b32_c.long()
    m_c = b32_c.numel()
    bc32 = sm._count_side_bc(p32_c, b32_c, m_c)
    bc64 = sm._count_side_bc(p64_c, b64_c, m_c)
    if not torch.equal(bc32, bc64):
        raise AssertionError("config 1: the int64 count side disagrees with the int32 one")
    er = {"i32": [], "i64": []}
    for which in ("i32", "i64", "i64", "i32"):
        er[which] += cuda_ms((lambda: sm._count_side_bc(p32_c, b32_c, m_c)) if which == "i32"
                             else (lambda: sm._count_side_bc(p64_c, b64_c, m_c)))
    ratio = med(er["i64"]) / med(er["i32"])
    log(f"phase int64/int32 ratio: ok, config 1's streams (1M x 16M) through the count side: "
        f"int32 {spread(er['i32'])}, int64 {spread(er['i64'])}, ratio {ratio:.4f} [{card}]")

    # ---- 16. slice 4's kernel against its plain version, small shapes -----
    t0 = time.perf_counter()
    extremes = np.array([0, 1, -1, -(2**63), I64_MAX, 2**32 - 1, 2**32, -(2**32)], dtype=np.int64)
    for n_h in (0, 1, 7, 8, 1001, (1 << 20) + 3):
        x_np = rng.integers(-(2**63), I64_MAX, n_h, dtype=np.int64, endpoint=True)
        x_np[: min(n_h, extremes.size)] = extremes[:n_h]
        x_h = torch.from_numpy(x_np).cuda()
        same("murmurhash64_i64", murmur.murmurhash64_i64(x_h), murmur.murmurhash64_plain(x_h),
             f"n={n_h}")
    got_np = murmur.murmurhash64_i64(torch.from_numpy(extremes).cuda()).cpu().numpy()
    if not np.array_equal(got_np.view(np.uint64), murmurhash64_np(extremes)):
        raise AssertionError("murmurhash64_i64 disagrees with numpy's uint64 hash")
    torch.cuda.synchronize()
    log(f"phase slice-4 kernel (small shapes): ok ({time.perf_counter() - t0:.1f} s), "
        f"max |kernel - plain| {max_err['murmurhash64_i64']}, numpy's uint64 hash agrees")

    # ---- 17. config 1 through the hash engines at full size ----------------
    col64 = col.to(torch.int64)
    ref = sm.sorted_match_stats(table, col)  # the cross-engine reference, per row
    hash_tables, launches_h = {}, {}
    for engine, builder, drain in (("hash_lp", build_lp, lp_match_stats),
                                   ("hash_csr", build_csr, csr_match_stats)):
        t0 = time.perf_counter()
        tbl = builder(keys, payloads, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        hash_tables[engine] = (tbl, drain)
        zero_counters(HASH_WRAPPERS)
        res_h = bulk_count([tbl], probe_dev)
        torch.cuda.synchronize()
        launches_h[engine] = read_counters(HASH_WRAPPERS)
        got_h = (int(res_h.count), int(res_h.payload_checksums[0]))
        if got_h != (want_count, want_checksum):
            raise AssertionError(f"{engine} bulk_count gave {got_h}, numpy "
                                 f"{(want_count, want_checksum)}")
        plain_h = combine_levels([drain(tbl, col64, route=HASH_PLAIN)])
        if (int(plain_h.count), int(plain_h.payload_checksums[0])) != got_h:
            raise AssertionError(f"{engine}: the all-plain route disagrees")
        stats_h = drain(tbl, col64)
        if not (torch.equal(stats_h.mult, ref.mult) and torch.equal(stats_h.psum, ref.psum)):
            raise AssertionError(f"{engine}: per-row mult or psum differ from sorted_match_stats")
        needed = ("murmurhash64_i64", "compact_i32") if engine == "hash_lp" else ("murmurhash64_i64",)
        idle = [k for k in needed if launches_h[engine][k] == 0]
        if idle:
            raise AssertionError(f"kernels not launched by {engine}'s bulk_count: {idle}")
        # a second hash launch is the LP ladder's full-width recompute
        bound_what = (f"max_run {tbl.max_run} of {tbl.n_slots} slots, ladder "
                      f"{'overflowed' if launches_h[engine]['murmurhash64_i64'] > 1 else 'held'}"
                      if engine == "hash_lp"
                      else f"max_len {tbl.max_len} of {tbl.n_buckets} buckets")
        log(f"phase config 1 {engine}: ok, build {build_s:.3f} s on the host ({bound_what}); "
            f"bulk_count count {got_h[0]} checksum {got_h[1]} (numpy and the all-plain route "
            f"agree; mult and psum of all {col.numel()} rows equal sorted_match_stats'); "
            f"launches {launches_h[engine]}")

    # ---- 18. kernel #12 at config 1's probe keys, timed ---------------------
    same("murmurhash64_i64", murmur.murmurhash64_i64(col64), murmur.murmurhash64_plain(col64),
         "config 1 probes")
    torch.cuda.synchronize()
    kernel_ms["murmurhash64_i64"] = (
        med(cuda_ms(lambda: murmur.murmurhash64_i64(col64))),
        med(cuda_ms(lambda: murmur.murmurhash64_plain(col64))),
    )
    n_h = col64.numel()
    work["murmurhash64_i64"] = (16 * n_h, HASH_OPS_PER_KEY * n_h)
    bound_h = bound(*work["murmurhash64_i64"])
    log(f"phase slice-4 kernel (config-1 shapes): ok, {n_h} keys: kernel "
        f"{kernel_ms['murmurhash64_i64'][0]:.4f} ms, plain {kernel_ms['murmurhash64_i64'][1]:.4f} "
        f"ms, bound {bound_h[0]:.4f} ms ({bound_h[1]}) [{card}]")

    # ---- 19. the hash engines beside sort-merge on config 1 -----------------
    calls = {"sort_merge": lambda: bulk_count([table], probe_dev)}
    for engine, (tbl, drain) in hash_tables.items():
        calls[engine] = lambda tbl=tbl: bulk_count([tbl], probe_dev)
        calls[f"{engine} all-plain"] = (
            lambda tbl=tbl, drain=drain: combine_levels([drain(tbl, col64, route=HASH_PLAIN)]))
    lp_table = hash_tables["hash_lp"][0]
    calls["hash_lp full width (no ladder)"] = (
        lambda: combine_levels([lp_match_stats(lp_table, col64, compact_lanes=False)]))
    e19 = {k: [] for k in calls}
    for order in (list(calls), list(calls)[::-1]):
        for k in order:
            e19[k] += cuda_ms(calls[k])
    log(f"times on [{card}], CUDA events, medians of {2 * REPS}, config 1 (1M build x 16M probe):")
    for k, ts in e19.items():
        share = ""
        if "plain" not in k:
            idle_k, n_events = idle_share(calls[k])
            share = f"; device idle share {idle_k:.4f} ({n_events} device events in {PROFILED_CALLS} calls)"
        log(f"  bulk_count {k}: {spread(ts)} = {N_PROBE / med(ts) / 1e3:.1f}M probe rows/s{share}")

    # ---- 20. bulk_materialize over hash tables, duplicate keys --------------
    t0 = time.perf_counter()
    want_trip = by_row_payload([want_rows[:, 0], want_rows[:, 2], want_rows[:, 3]])
    rows_sm = bulk_materialize([table_d], col_d.view(-1, 1), PayloadMode.FULL)
    got_sm = by_row_payload([rows_sm[:, i].cpu().numpy() for i in range(3)])
    if not all(np.array_equal(g, w) for g, w in zip(got_sm, want_trip)):
        raise AssertionError("bulk_materialize (sort-merge): triples disagree with numpy")
    for engine, builder in (("hash_lp", build_lp), ("hash_csr", build_csr)):
        tbl = builder(keys_d, pays_d, device="cuda")
        zero_counters(HASH_WRAPPERS)
        rows_h = bulk_materialize([tbl], col_d.view(-1, 1), PayloadMode.FULL)
        torch.cuda.synchronize()
        launches_mh = read_counters(HASH_WRAPPERS)
        got_trip = by_row_payload([rows_h[:, i].cpu().numpy() for i in range(3)])
        if not all(np.array_equal(g, w) for g, w in zip(got_trip, want_trip)):
            raise AssertionError(f"bulk_materialize ({engine}): triples differ from numpy's "
                                 "and the sort-merge route's")
        idle = [k for k, v in launches_mh.items() if v == 0]
        if idle:
            raise AssertionError(f"kernels not launched by {engine}'s bulk_materialize: {idle}")
        log(f"phase materialize {engine}: ok, {rows_h.shape[0]} triples (262144 build rows, "
            f"4 per key, x 4M probes) equal numpy's and the sort-merge route's; launches "
            f"{launches_mh}")
    log(f"phase hash materialize: ok ({time.perf_counter() - t0:.1f} s)")

    # ---- 21. the benchmark entry point on the hash engines -----------------
    for engine in ("hash_lp", "hash_csr"):
        result = config1_single_join(engine=engine, device="cuda")
        log(f"phase config1_single_join {engine}: ok {json.dumps(result)}")

    # ---- 22. the LP ladder's own answer, and its time, at lower hit rates --
    # Config 1's build keys are 0 .. N_BUILD - 1 with payload key + 10^7, so
    # probes uniform over [0, N_BUILD * 100 / pct) hit pct % of the time and
    # every row's (mult, psum) is known exactly.
    t0 = time.perf_counter()
    csr_table = hash_tables["hash_csr"][0]
    gen = torch.Generator(device="cuda").manual_seed(22)
    ladder_log = []
    for pct in LADDER_HIT_PCTS:
        col_l = torch.randint(0, N_BUILD * 100 // pct, (N_PROBE,), generator=gen,
                              device="cuda", dtype=torch.int64)
        hit = col_l < N_BUILD
        want_m, want_p = hit.to(torch.int32), torch.where(hit, col_l + 10_000_000, 0)
        zero_counters(HASH_WRAPPERS)
        ladder = lp_match_stats(lp_table, col_l, compact_lanes=True)
        torch.cuda.synchronize()
        lc = read_counters(HASH_WRAPPERS)
        held = lc["murmurhash64_i64"] == 1  # a second hash is the full-width recompute
        if pct <= 25 and not (held and lc["compact_i32"] == 4):
            raise AssertionError(f"LP ladder at {pct} % hits: launches {lc}, expected the "
                                 "ladder to hold (1 hash, 4 compactions)")
        for what, s in (("ladder", ladder),
                        ("full width", lp_match_stats(lp_table, col_l, compact_lanes=False)),
                        ("all-plain ladder", lp_match_stats(lp_table, col_l, compact_lanes=True,
                                                            route=HASH_PLAIN))):
            if not (torch.equal(s.mult, want_m) and torch.equal(s.psum, want_p)):
                raise AssertionError(f"LP {what} at {pct} % hits: mult or psum differ from "
                                     "the exact answer")
        want_l = (int(want_m.sum()), int(want_p.sum()))
        calls = {
            "ladder": lambda c=col_l: lp_match_stats(lp_table, c, compact_lanes=True),
            "full width": lambda c=col_l: lp_match_stats(lp_table, c, compact_lanes=False),
            "hash_csr": lambda c=col_l: bulk_count([csr_table], c.view(-1, 1)),
            "sort_merge": lambda c=col_l.to(torch.int32): bulk_count([table], c.view(-1, 1)),
        }
        for engine in ("hash_csr", "sort_merge"):
            res_l = calls[engine]()
            if (int(res_l.count), int(res_l.payload_checksums[0])) != want_l:
                raise AssertionError(f"{engine} at {pct} % hits: bulk_count gave "
                                     f"{(int(res_l.count), int(res_l.payload_checksums[0]))}, "
                                     f"exact {want_l}")
        e22 = {k: [] for k in calls}
        for order in (list(calls), list(calls)[::-1]):
            for k in order:
                e22[k] += cuda_ms(calls[k])
        ladder_log.append(f"  {pct} % hits ({want_l[0]} matches; ladder "
                          f"{'held' if held else 'overflowed'}, launches {lc}): "
                          + "; ".join(f"{k} {spread(ts)}" for k, ts in e22.items()))
    log(f"phase LP ladder: ok ({time.perf_counter() - t0:.1f} s), at "
        f"{', '.join(map(str, LADDER_HIT_PCTS))} % hits the ladder's, full width's and the "
        "all-plain ladder's mult and psum equal the exact answer on every row; CSR and "
        "sort-merge count and checksum equal it")
    log(f"times on [{card}], CUDA events, medians of {2 * REPS}, {N_PROBE} probes over config "
        "1's tables (LP: lp_match_stats; CSR, sort-merge: bulk_count):")
    for line in ladder_log:
        log(line)

    sources = {
        "sort_tiles_i32": ("ccve_tpu_torch/kernels/csrc/sort_tiles.cu",
                           "ccve_tpu/kernels/bigsort.py:94"),
        "merge_level_i32": ("ccve_tpu_torch/kernels/csrc/merge_level.cu",
                            "ccve_tpu/kernels/bigsort.py:286"),
        "merge_counts_i32": ("ccve_tpu_torch/kernels/csrc/merge_counts.cu",
                             "ccve_tpu/kernels/merge_scan.py:548"),
        "sort_tiles_multi_i32": ("ccve_tpu_torch/kernels/csrc/sort_tiles_multi.cu",
                                 "ccve_tpu/kernels/pairsort.py:99"),
        "merge_multi_i32": ("ccve_tpu_torch/kernels/csrc/merge_multi.cu",
                            "ccve_tpu/kernels/pairsort.py:133"),
        "merge_stats_i32": ("ccve_tpu_torch/kernels/csrc/merge_stats.cu",
                            "ccve_tpu/kernels/merge_scan.py:240"),
        "compact_i32": ("ccve_tpu_torch/kernels/csrc/compact.cu",
                        "ccve_tpu/kernels/compact.py:77"),
        "sort_tiles_i64": ("ccve_tpu_torch/kernels/csrc/sort_tiles.cu",
                           "ccve_tpu/kernels/pairsort.py:563"),
        "merge_level_i64": ("ccve_tpu_torch/kernels/csrc/merge_level.cu",
                            "ccve_tpu/kernels/pairsort.py:592"),
        "merge_counts_i64": ("ccve_tpu_torch/kernels/csrc/merge_counts.cu",
                             "ccve_tpu/kernels/merge_scan.py:784"),
        "sort_tiles_multi_i64": ("ccve_tpu_torch/kernels/csrc/sort_tiles_multi.cu",
                                 "ccve_tpu/kernels/pairsort.py:563"),
        "merge_multi_i64": ("ccve_tpu_torch/kernels/csrc/merge_multi.cu",
                            "ccve_tpu/kernels/pairsort.py:592"),
        "merge_stats_i64": ("ccve_tpu_torch/kernels/csrc/merge_stats.cu",
                            "ccve_tpu/kernels/merge_scan.py:47"),
        "murmurhash64_i64": ("ccve_tpu_torch/kernels/csrc/murmur.cu",
                             "ccve_tpu/kernels/murmur.py:68"),
    }
    # Slice 2's launches are those of its two main-path runs (config 3's
    # bulk_count and config 1's sorted_expand_tiled); its times are per
    # call at the materialize shapes, and per level at config 3's for the
    # stats scan, which only the stats path runs. Slice 3's are those of
    # config1_wide's bulk_count (count side) and sorted_match_stats
    # (stats side), with the times at their shapes.
    for name in NEW_WRAPPERS:
        launches[name] = launches3[name] + launches_m[name]
        kernel_ms[name] = ms_cfg3[name] if name == "merge_stats_i32" else ms_mat[name]
    for name in WIDE_COUNT:
        launches[name] = launches_w[name]
    for name in WIDE_STATS:
        launches[name] = launches_s[name]
    # slice 4: the hash's launches in phase 17's two bulk_count runs; the
    # compaction's on the LP drain add to its slice-2 launches
    launches["murmurhash64_i64"] = sum(lc["murmurhash64_i64"] for lc in launches_h.values())
    launches["compact_i32"] += launches_h["hash_lp"]["compact_i32"]
    entries = []
    for name in sources:
        bound_ms, bound_by = bound(*work[name])
        entries.append({
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": kernel_ms[name][0],
            "plain_ms": kernel_ms[name][1],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": kernel_ms[name][1] if name in LIBRARY_IS_PLAIN else None,
        })
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
