"""Tile sizes of the count side's merge level (#2, #13), of its merge
counts (#3, #14) and of the compaction (#9), read on the card.

Run from the repository root on a machine with a CUDA GPU and nvcc:

    python -m ccve_tpu_torch.bench.tile_sweep

It builds copies of csrc/ that differ from the sources only where this
script rewrites them (each copy one library with `-Xptxas -v`, of the
sources its kernel needs: merge_multi.cu and sort_tiles.cu, compact.cu, or
merge_counts.cu, with status.cu; the `source` copy of all four; all copies
at once), prints each copy's registers, spills and static shared memory
of its merge, compaction and counts kernels as ptxas reports them, with
the blocks an SM that the H100's limits then allow, and times each copy's
raw launches, outputs and scratch allocated once, at `kernel_split`'s
shapes: the key-only merge level at run_log 13 and the whole ladder
(`ccve_sort_runs`) at config 1's 16M int32 and config 1 wide's 2^24 int64
probes (`count_tiles`, the ladder's run_log from `count_side_plan`), the
merge counts over the runs that ladder leaves (`count_streams`; 8 runs of
2^21 at both shapes), and the compaction at `compact_inputs`' two shapes.
Each copy's result is first held exactly against the plain version; then
one `SWEEP` line a (copy, case) gives its call time (CUDA events, the
median (min-max) of 5 chains of CHAIN launches) and the device us of each
kernel and memset (`kernel_split.device_split`).

The copies: `source` (the merge: 256 threads of 16 outputs, 4096 a block;
the compaction: 256 threads of 32 rows, 8192 a tile; the counts: 256
threads of 4 build rows, 1024 a tile, stages of 2.75 tiles' keys, windows
of 24 (int32) and 32 (int64) keys); `merge 256 x 32` (8192 outputs a
block, 32 a thread); `merge 512 x 16` (8192 outputs, 512 threads of 16);
`compact 256 x 16` (tiles of 4096 rows, 16 a thread); `compact 2 an SM`
(the source held to two blocks an SM by its launch bounds); `compact 512
x 16` (8192 rows, 512 threads of 16); `compact streaming stores` (the
output written with `__stcs`, evict-first); `counts 256 x 8` and `counts
256 x 2` (tiles of 2048 and 512 rows, windows of 32 and 16 keys); `counts
512 x 4` (tiles of 2048, 512 threads; also with three buffers, and with
stages of 2.25 tiles); `counts window 16`, `32` and `40`; `counts walk`
(every thread walks its rows, no window); `counts stage 4` and `counts
stage 2.25`; `counts three buffers` (two slices load ahead, not one);
`counts one lane a search` (the slices' bounds by binary searches, one
lane each); `counts in device memory` (no staging: every slice walked
where it lies); and four diagnostics, timed but not checked: `compact no
look-back` (every tile's offset taken as its own first row, so that it
writes as many bytes to a range of its own: what the look-back costs),
`compact no stores` (the kept rows and zeros never written: the loads,
ranks, look-back and compaction in shared memory alone), `counts no walk`
(the searches, the staging and the barriers, no counting) and `counts
search only` (those and each thread's first search in each slice).
Beside each compaction shape, one `planes.clone()` (the same
planes read and written once, no mask) calibrates what the card's memory
gives a copy. `--only merge`, `--only compact` or `--only counts` reads
one kernel's cases. The script rewrites the sources by exact strings and
raises if one is gone: keep it in step when merge_multi.cu, compact.cu or
merge_counts.cu changes.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from ccve_tpu_torch.bench import kernel_split
from ccve_tpu_torch.kernels import _build, bigsort, compact, merge_scan

CHAIN = 20
MERGE, COMPACT, COUNTS = "merge_multi.cu", "compact.cu", "merge_counts.cu"
# the sources of each kernel's copies (and, all of them, of `source`)
UNITS = {"merge": (MERGE, "sort_tiles.cu", "status.cu"), "compact": (COMPACT, "status.cu"),
         "counts": (COUNTS, "status.cu")}
ENTRIES = {"merge": ("ccve_merge_level_i32", "ccve_merge_level_i64", "ccve_sort_runs_i32",
                     "ccve_sort_runs_i64"),
           "compact": ("ccve_compact_i32",),
           "counts": ("ccve_merge_counts_i32", "ccve_merge_counts_i64")}
SIZES = {"merge": ("ccve_merge_splits_bytes",), "compact": ("ccve_compact_scratch_bytes",),
         "counts": ()}
_COUNTS_STAGE = "constexpr int kStage = 11 * kTile / 4;"
_COUNTS_ROWS = "constexpr int kRows = 4;"
_COUNTS_WINDOW = "constexpr int kWindow = sizeof(K) == 4 ? 24 : 32;"
_COMPACT_16 = (COMPACT, "constexpr int kItems = 32; ", "constexpr int kItems = 16; ")
COPIES = {
    "source": [],
    "merge 256 x 32": [(MERGE, "constexpr int kPerThread = 16;", "constexpr int kPerThread = 32;")],
    "merge 512 x 16": [(MERGE, "constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "compact 256 x 16": [_COMPACT_16],
    "compact 2 an SM": [(
        COMPACT, "__global__ void __launch_bounds__(kThreads)\n    compact_kernel(",
        "__global__ void __launch_bounds__(kThreads, 2)\n    compact_kernel(")],
    "compact 512 x 16": [_COMPACT_16, (COMPACT, "constexpr int kThreads = 256;",
                                       "constexpr int kThreads = 512;")],
    "compact streaming stores": [
        (COMPACT, "row[excl + i] = s[i];", "__stcs(row + excl + i, s[i]);"),
        (COMPACT, "row[zeros0 + i] = 0;", "__stcs(row + zeros0 + i, 0);")],
    "compact no look-back": [
        (COMPACT, "  const long long excl = tile > 0 ? look_back(lb, tile) : 0;",
         "  const long long excl = tile0;")],
    "compact no stores": [
        (COMPACT, "for (int i = t; i < cnt; i += kThreads) row[excl + i] = s[i];",
         "if (cnt < 0) row[excl] = s[t];"),
        (COMPACT, "for (int i = t; i < u; i += kThreads) row[zeros0 + i] = 0;", "")],
    "counts 256 x 8": [(COUNTS, _COUNTS_ROWS, "constexpr int kRows = 8;"),
                       (COUNTS, _COUNTS_WINDOW, "constexpr int kWindow = 32;")],
    "counts 256 x 2": [(COUNTS, _COUNTS_ROWS, "constexpr int kRows = 2;"),
                       (COUNTS, _COUNTS_WINDOW, "constexpr int kWindow = 16;")],
    "counts 512 x 4": [(COUNTS, "constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "counts window 16": [(COUNTS, _COUNTS_WINDOW, "constexpr int kWindow = 16;")],
    "counts window 32": [(COUNTS, _COUNTS_WINDOW, "constexpr int kWindow = 32;")],
    "counts window 40": [(COUNTS, _COUNTS_WINDOW, "constexpr int kWindow = 40;")],
    "counts 512 x 4, three buffers": [
        (COUNTS, "constexpr int kThreads = 256;", "constexpr int kThreads = 512;"),
        (COUNTS, "constexpr int kBuffers = 2;", "constexpr int kBuffers = 3;")],
    "counts search only": [(COUNTS, "  const int a = i & ~(kVec<K> - 1);\n",
                            "  cnt[0] += i;\n  return;\n  const int a = i & ~(kVec<K> - 1);\n")],
    "counts walk": [(COUNTS, "if (a + kWindow<K> < n && buf[a + kWindow<K> - 1] < last) {",
                     "if (true) {")],
    "counts stage 4": [(COUNTS, _COUNTS_STAGE, "constexpr int kStage = 4 * kTile;")],
    "counts stage 2.25": [(COUNTS, _COUNTS_STAGE, "constexpr int kStage = 9 * kTile / 4;")],
    "counts 512 x 4, stage 2.25": [
        (COUNTS, "constexpr int kThreads = 256;", "constexpr int kThreads = 512;"),
        (COUNTS, _COUNTS_STAGE, "constexpr int kStage = 9 * kTile / 4;")],
    "counts three buffers": [(COUNTS, "constexpr int kBuffers = 2;", "constexpr int kBuffers = 3;")],
    "counts one lane a search": [(COUNTS, "    int g = kWarp;\n", "    int g = 1;\n")],
    "counts in device memory": [
        (COUNTS, "if (n <= kStage) {\n        K* const buf", "if (false) {\n        K* const buf"),
        (COUNTS, "if (n <= kStage) {\n        count_staged", "if (false) {\n        count_staged")],
    "counts no walk": [(COUNTS, "  if (rows == 0 || n == 0) return;\n  const auto s",
                        "  return;\n  const auto s")],
}
# copies whose results are not the function's (diagnostics: timed, not checked)
INEXACT = {"compact no look-back", "compact no stores", "counts no walk", "counts search only"}
# the H100's per-SM limits, for the blocks an SM of ptxas' numbers
SM_REGS, SM_SMEM, SM_THREADS, SM_BLOCKS = 65536, 233472, 2048, 32
# the kernels the sweep reads, by the start of their mangled names, and
# their copies' group: the key-only level's merge and partition (P = 0 over
# a Level), the compaction and the merge counts
KERNELS = {"merge_kernelIiLi0ENS_5LevelE": ("merge_kernel<int, 0, Level>", "merge"),
           "merge_kernelIxLi0ENS_5LevelE": ("merge_kernel<long long, 0, Level>", "merge"),
           "partition_kernelIiNS_5LevelE": ("partition_kernel<int, Level>", "merge"),
           "partition_kernelIxNS_5LevelE": ("partition_kernel<long long, Level>", "merge"),
           "compact_kernel": ("compact_kernel", "compact"),
           "merge_counts_kernelIiE": ("merge_counts_kernel<int>", "counts"),
           "merge_counts_kernelIxE": ("merge_counts_kernel<long long>", "counts")}


def group(copy: str) -> str | None:
    """The kernel a copy rewrites ("merge", "compact", "counts"), None for
    `source`."""
    return None if copy == "source" else copy.split()[0]


def units(copy: str) -> list[str]:
    g = group(copy)
    if g is None:
        return sorted({u for us in UNITS.values() for u in us})
    return list(UNITS[g])


def _sub(src: str, old: str, new: str, what: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"{what} no longer holds {old!r} once: update tile_sweep")
    return src.replace(old, new)


def sources(copy: str) -> dict:
    """{file: text} of csrc/ with `copy`'s rewrites."""
    out = {f.name: f.read_text() for f in _build.CSRC.iterdir() if f.suffix in (".cu", ".cuh")}
    for target, old, new in COPIES[copy]:
        out[target] = _sub(out[target], old, new, target)
    return out


def build(out_dir: Path, copies) -> tuple[dict, dict]:
    """({copy: ctypes library}, {copy: ptxas' lines}), one nvcc a copy, all
    at once."""
    cmds, dirs = {}, {}
    for copy in copies:
        d = out_dir / re.sub(r"\W+", "_", copy)
        d.mkdir()
        for name, text in sources(copy).items():
            (d / name).write_text(text)
        dirs[copy] = d
        cmds[copy] = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                      "-o", str(d / "lib.so"), *(str(d / u) for u in units(copy))]
    procs = {c: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c, cmd in cmds.items()}
    libs, ptxas = {}, {}
    for copy, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {copy}:\n{err}")
        ptxas[copy] = err.splitlines()
        lib = ctypes.CDLL(str(dirs[copy] / "lib.so"))
        groups = UNITS if group(copy) is None else (group(copy),)
        for entry in (e for g in groups for e in ENTRIES[g]):
            fn = getattr(lib, entry)
            fn.argtypes = _build._ENTRY_POINTS[entry]
            fn.restype = ctypes.c_int
        for entry in (e for g in groups for e in SIZES[g]):
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIZE_FUNCTIONS[entry]
            fn.restype = ctypes.c_longlong
        libs[copy] = lib
    return libs, ptxas


def resources(lines: list[str], threads: dict) -> list[str]:
    """ptxas' registers, spills and static shared memory of each kernel of
    KERNELS in its -v lines, with the blocks an SM that registers, threads
    and static shared memory allow (`threads`: {"merge", "compact",
    "counts"}: the block of each source; dynamic shared memory is not in
    ptxas' numbers)."""
    out, entry, spills = [], None, ""
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = next((v for k, v in KERNELS.items() if k in m.group(1)), None)
            continue
        if entry and "spill" in line:
            spills = line.strip()
            continue
        m = re.search(r"Used (\d+) registers", line)
        if entry and m:
            regs = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            smem = int(smem.group(1)) if smem else 0
            block = threads[entry[1]]
            warp_regs = -(-regs * 32 // 256) * 256
            blocks = min(SM_REGS // (warp_regs * (block // 32)), SM_THREADS // block, SM_BLOCKS,
                         SM_SMEM // (smem + 1024) if smem else SM_BLOCKS)
            out.append(f"{entry[0]}: {line.split(':', 1)[1].strip()}; {spills}; {blocks} "
                       f"blocks of {block} an SM by registers and static smem")
            entry = None
    return out


def _block_threads(copy: str) -> dict:
    return {"merge": 512 if copy == "merge 512 x 16" else 256,
            "compact": 512 if copy == "compact 512 x 16" else 256,
            "counts": 512 if copy.startswith("counts 512") else 256}


def merge_launchers(lib, x: torch.Tensor, run_log: int):
    """[(case, launch, exact)] of `lib`'s key-only level at run_log 13 over
    the sorted tiles of x and its ladder over x to run_log."""
    tl = bigsort.TILE_LOG
    n = x.numel()
    sfx = _build.SUFFIX[x.dtype]
    stream = _build.stream(x)
    tiles = bigsort.sort_tiles_plain(x, tl)
    y, t = torch.empty_like(x), torch.empty_like(x)
    splits = torch.empty(lib.ccve_merge_splits_bytes(n, tl), dtype=torch.uint8, device=x.device)
    level = getattr(lib, f"ccve_merge_level_{sfx}")
    ladder = getattr(lib, f"ccve_sort_runs_{sfx}")
    want_level = bigsort.merge_level_plain(tiles, tl)
    want_runs = bigsort.sort_runs_plain(x, run_log, tl)

    def run_level():
        _build.check(level(tiles.data_ptr(), y.data_ptr(), splits.data_ptr(), n, tl, stream),
                     "tile_sweep level")

    def run_ladder():
        _build.check(ladder(x.data_ptr(), y.data_ptr(), t.data_ptr(), splits.data_ptr(), n, tl,
                            run_log - tl, stream), "tile_sweep ladder")

    def exact(run, want):
        y.fill_(-1)
        run()
        return torch.equal(y, want)

    return [(f"merge_level_{sfx} level {tl}", run_level, lambda: exact(run_level, want_level)),
            (f"sort_runs_{sfx} ({run_log - tl} levels)", run_ladder,
             lambda: exact(run_ladder, want_runs))]


def compact_launcher(lib, planes: torch.Tensor, mask: torch.Tensor):
    """(launch, exact) of `lib`'s compaction of (planes, mask)."""
    n_planes, n = planes.shape
    out = torch.empty_like(planes)
    count = torch.empty((), dtype=torch.int64, device=planes.device)
    scratch = torch.empty(lib.ccve_compact_scratch_bytes(n), dtype=torch.uint8,
                          device=planes.device)
    stream = _build.stream(planes)
    want, want_count = compact.compact_plain(planes, mask)

    def launch():
        _build.check(lib.ccve_compact_i32(planes.data_ptr(), mask.data_ptr(), n, n_planes,
                                          scratch.data_ptr(), out.data_ptr(), count.data_ptr(),
                                          stream), "tile_sweep compact")

    def exact() -> bool:
        out.fill_(-1)
        launch()
        return torch.equal(out, want) and int(count) == int(want_count)

    return launch, exact


def counts_launcher(lib, runs: torch.Tensor, run_len: int, n: int, b: torch.Tensor):
    """(launch, exact) of `lib`'s merge counts of (runs, run_len, n, b)."""
    m = b.numel()
    bc = torch.empty(m, dtype=torch.int32, device=b.device)
    entry = getattr(lib, f"ccve_merge_counts_{_build.SUFFIX[b.dtype]}")
    stream = _build.stream(b)
    want = merge_scan.merge_counts_plain(runs, run_len, n, b, m)

    def launch():
        _build.check(entry(runs.data_ptr(), run_len, n, b.data_ptr(), m, bc.data_ptr(), stream),
                     "tile_sweep merge counts")

    def exact() -> bool:
        bc.fill_(-1)
        launch()
        return torch.equal(bc, want)

    return launch, exact


def timed(launch) -> str:
    chains = sorted(kernel_split._event_ms(launch, CHAIN) for _ in range(5))
    d = kernel_split.device_split(launch)
    return (f"call {chains[2]:.4f} ms ({chains[0]:.4f}-{chains[-1]:.4f}), device "
            f"{d['us']:.2f} us {d['kernels']}")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=tuple(UNITS), default=None)
    only = parser.parse_args(argv).only
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}")
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="tile_sweep_") as tmp:
        copies = [c for c in COPIES if only is None or group(c) in (None, only)]
        libs, ptxas = build(Path(tmp), copies)
        for copy in copies:
            for line in resources(ptxas[copy], _block_threads(copy)):
                print(f"PTXAS {copy}: {line}")
        cases = []  # (kernel group, shape, launchers of a library)
        for shape, x in (kernel_split.count_tiles(device).items()
                         if only in (None, "merge") else ()):
            run_log = kernel_split.sm.count_side_plan(x.numel(), kernel_split.COUNT_BUILD_ROWS,
                                                      bigsort.TILE_LOG)[1]
            cases.append(("merge", shape, lambda lib, x=x, r=run_log: merge_launchers(lib, x, r)))
        for shape, (x, n, b) in (kernel_split.count_streams(device).items()
                                 if only in (None, "counts") else ()):
            run_log = kernel_split.sm.count_side_plan(n, b.numel(), bigsort.TILE_LOG)[1]
            runs = bigsort.sort_runs(x, run_log)
            cases.append(("counts", shape, lambda lib, a=(runs, 1 << run_log, n, b): [
                (f"merge_counts_{_build.SUFFIX[a[3].dtype]}", *counts_launcher(lib, *a))]))
        for shape, (planes, mask) in (kernel_split.compact_inputs(device).items()
                                      if only in (None, "compact") else ()):
            cases.append(("compact", shape, lambda lib, a=(planes, mask): [
                ("compact_i32", *compact_launcher(lib, *a))]))
            print(f"SWEEP yardstick | planes.clone(), {shape}: "
                  f"{timed(lambda p=planes: p.clone())}")
        for kernel, shape, make in cases:
            for copy, lib in libs.items():
                if group(copy) not in (None, kernel):
                    continue
                for case, launch, exact in make(lib):
                    if copy not in INEXACT and not exact():
                        raise AssertionError(f"{copy} {case} {shape}: not the plain version's")
                    print(f"SWEEP {copy} | {case}, {shape}: {timed(launch)}")
        print(f"(on [{card}]; one chain of {CHAIN} launches a reading)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
