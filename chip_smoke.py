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
from ccve_tpu_torch.bench.configs import config1_single_join  # noqa: E402
from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table  # noqa: E402
from ccve_tpu_torch.exec.bulk import bulk_count  # noqa: E402
from ccve_tpu_torch.kernels import _build, bigsort, merge_scan  # noqa: E402
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
    kind = torch.cuda.get_device_name(0)
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
    max_err = dict.fromkeys(wrappers, 0)

    def same(name: str, got: torch.Tensor, want: torch.Tensor, what: str):
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

    def med(ts):
        return float(np.median(ts))

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

    sources = {
        "sort_tiles_i32": ("ccve_tpu_torch/kernels/csrc/sort_tiles.cu",
                           "ccve_tpu/kernels/bigsort.py:94"),
        "merge_level_i32": ("ccve_tpu_torch/kernels/csrc/merge_level.cu",
                            "ccve_tpu/kernels/bigsort.py:286"),
        "merge_counts_i32": ("ccve_tpu_torch/kernels/csrc/merge_counts.cu",
                             "ccve_tpu/kernels/merge_scan.py:548"),
    }
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
        for name in wrappers
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
