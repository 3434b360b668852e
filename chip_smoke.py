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

Prints the per-kernel JSON line, then the card line, then, only when every
phase passed, the last line `{"ok": true, "device": {...}}`. Any failure
raises and exits non-zero.
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
    config3_data,
    config3_four_way,
)
from ccve_tpu_torch.config import PayloadMode  # noqa: E402
from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table  # noqa: E402
from ccve_tpu_torch.exec.bulk import bulk_count, combine_levels  # noqa: E402
from ccve_tpu_torch.exec.oracle import OracleBuildTable, oracle_join  # noqa: E402
from ccve_tpu_torch.kernels import _build, bigsort, compact, merge_scan, pairsort  # noqa: E402
from ccve_tpu_torch.ops import sort_merge as sm  # noqa: E402

N_BUILD = 1_000_000
N_PROBE = 16_000_000
REPS = 10
I32_MAX = 2**31 - 1


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


def zero_new_counters() -> None:
    for fns in NEW_WRAPPERS.values():
        for fn in fns:
            fn.launches = 0


def new_counters() -> dict:
    return {name: sum(fn.launches for fn in fns) for name, fns in NEW_WRAPPERS.items()}


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
    max_err = dict.fromkeys([*wrappers, *NEW_WRAPPERS], 0)

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
            same("merge_level_i32", bigsort.sort_runs_i32(x, run_log),
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

    def path_kernels(tbl, col, path):
        """The stats side's kernel route step by step at a path's shapes,
        each kernel against its plain version on the same input; returns
        the inputs, for the times."""
        tl = pairsort.TILE_LOG
        n = col.numel()
        b32, p32 = sm.stats_pack32_streams(tbl, col)
        rows = torch.arange(n, dtype=torch.int32, device=col.device)
        pk, pv = pairsort.pad_to_tile(p32, [rows], tl)
        level_in = [pairsort.sort_tiles_multi_i32(pk, pv, tl)]
        same("sort_tiles_multi_i32", level_in[0], pairsort.sort_tiles_multi_plain(pk, pv, tl), path)
        for lv in range(max((pk.numel() >> tl) - 1, 0).bit_length()):
            k, v = level_in[-1]
            level_in.append(pairsort.merge_level_multi_i32(k, v, tl + lv))
            same("merge_multi_i32", level_in[-1],
                 pairsort.merge_level_multi_plain(k, v, tl + lv), f"{path} level {tl + lv}")
        sk, sv = level_in.pop()
        two = (sk[:n], [x[:n] for x in sv], b32, [tbl.payloads.to(torch.int32)])
        merged = pairsort.merge_two_multi_i32(*two)
        same("merge_multi_i32", merged, pairsort.merge_two_multi_plain(*two), f"{path} merge two")
        return {"tile": (pk, pv), "levels": level_in, "two": two, "merged": merged}

    def path_ms(inputs):
        """(kernel ms, plain ms) of the sort and merges of one call."""
        tl = pairsort.TILE_LOG
        pk, pv = inputs["tile"]
        two = inputs["two"]

        def levels(fn):
            return sum(med(cuda_ms(lambda k=k, v=v, r=tl + i: fn(k, v, r)))
                       for i, (k, v) in enumerate(inputs["levels"]))

        return {
            "sort_tiles_multi_i32": (
                med(cuda_ms(lambda: pairsort.sort_tiles_multi_i32(pk, pv, tl))),
                med(cuda_ms(lambda: pairsort.sort_tiles_multi_plain(pk, pv, tl))),
            ),
            "merge_multi_i32": (
                levels(pairsort.merge_level_multi_i32)
                + med(cuda_ms(lambda: pairsort.merge_two_multi_i32(*two))),
                levels(pairsort.merge_level_multi_plain)
                + med(cuda_ms(lambda: pairsort.merge_two_multi_plain(*two))),
            ),
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
    zero_new_counters()
    res3 = bulk_count(tables3, probe3)
    torch.cuda.synchronize()
    launches3 = new_counters()
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
    zero_new_counters()
    tiles, total = sm.sorted_expand_tiled(table, col1)
    torch.cuda.synchronize()
    launches_m = new_counters()
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
    zero_new_counters()
    stats_d = sm.sorted_match_stats(table_d, col_d)
    tiles_d, total_d = sm.sorted_expand_tiled(table_d, col_d)
    torch.cuda.synchronize()
    launches_d = new_counters()
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
    }
    # Slice 2's launches are those of its two main-path runs (config 3's
    # bulk_count and config 1's sorted_expand_tiled); its times are per
    # call at the materialize shapes, and per level at config 3's for the
    # stats scan, which only the stats path runs.
    for name in NEW_WRAPPERS:
        launches[name] = launches3[name] + launches_m[name]
        kernel_ms[name] = ms_cfg3[name] if name == "merge_stats_i32" else ms_mat[name]
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": kernel_ms[name][0],
            "plain_ms": kernel_ms[name][1],
        }
        for name in sources
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
