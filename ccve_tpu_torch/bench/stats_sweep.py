"""#15's row form read apart on the card: its scan against its scatter.

Run from the repository root on a machine with a CUDA GPU and nvcc:

    python -m ccve_tpu_torch.bench.stats_sweep

It builds copies of csrc/merge_stats.cu (with csrc/seg_scan.cuh), one nvcc
each, all at once, that differ from the source only where this script
rewrites them, and runs each copy's row form (`ccve_merge_stats_i64`,
`_i32`) raw, its outputs and scratch allocated once, at
`kernel_split.stats_scan_inputs`' shapes: config 1 wide's stats (2^24
int64 probes against 1M rows) and config 3's level 0 (1M int32 probes
against 50,000). Each copy is first held exactly against the plain
version, then one `SWEEP` line a (copy, shape) gives its call time (CUDA
events, the median (min-max) of 5 chains of CHAIN launches) and the
device us of each of its kernels and memsets (`kernel_split.device_split`).

The copies, for the design the tree holds:

- The three-launch scan (`seg_apply_kernel` in seg_scan.cuh): `source`,
  and `per element`, whose last pass writes every element's run value at
  its stream position (outputs of L rows) instead of scattering the probes
  to their rows: the scatter's cost is the difference.
- The single-pass scan (`look_back` in seg_scan.cuh) with the staged
  scatter: `source`; `per element` as above; `direct`, which scatters each
  probe straight to its row from the scan; `per-probe atomics`, where each
  probe takes its own staging slot (no block sort); `record`, which
  scatters one 16-byte (row, mult, psum) record a probe to a staging array
  in row order, then gathers each bucket's in shared memory and writes the
  two outputs in order (the other candidate of the design). Diagnostics,
  timed but not checked: `no look-back` (every tile's prefix taken as
  empty) and `no writes` (nothing staged).

The script rewrites the sources by exact strings and raises if one is
gone: keep it in step when merge_stats.cu or seg_scan.cuh changes. To read
a parent tree, copy this script into its `ccve_tpu_torch/bench/` and run
it there.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ccve_tpu_torch.bench import kernel_split
from ccve_tpu_torch.kernels import _build, merge_scan

CHAIN = 20

# the three-launch design: the apply pass's emit, per element instead of to the row
THREE_PASS = {
    "per element": [("merge_stats.cu",
        "  __device__ void emit(const Shared& sh, int j, long long, const Seg& run) const {\n"
        "    const K key = sh.key[j];\n"
        "    const int row = sh.val[j];\n"
        "    if ((key & 1) && key != Pad<K>::value && row >= 0 && row < n) {\n"
        "      mult[row] = run.count;\n"
        "      psum[row] = run.sum;\n"
        "    }\n",
        "  __device__ void emit(const Shared& sh, int j, long long i, const Seg& run) const {\n"
        "    {\n"
        "      mult[i] = run.count;\n"
        "      psum[i] = run.sum;\n"
        "    }\n")],
}

# the single-pass design; (file, old, new) rewrites, and copies whose
# results are not the function's (diagnostics: timed, not checked)
SCAN, STATS = "seg_scan.cuh", "merge_stats.cu"
SINGLE_PASS = {
    "per element": [(STATS, (
        "  __device__ void emit(Items& it, int k, long long, const Seg& run) const {\n"
        "    const K key = it.key[k];\n"
        "    const int row = it.val[k];\n"
        "    it.val[k] = (key & 1) && key != Pad<K>::value && row >= 0 && row < n ? row : -1;\n"),
        "  __device__ void emit(Items& it, int k, long long i, const Seg& run) const {\n"
        "    out.mult[i] = run.count;\n"
        "    out.psum[i] = run.sum;\n"
        "    it.val[k] = -1;\n")],
    "direct": [(STATS, "    if (buckets > kBins) {", "    if (true) {"),
               (STATS, "          const int slot = atomicAdd(cursor + b, 1);",
                "          const int slot = capacity;")],
    "per-probe atomics": [(STATS, "    if (buckets > kBins) {", "    if (true) {")],
    "record": [
        (STATS, "    if (buckets > kBins) {", "    if (true) {"),
        (STATS, "          const int slot = atomicAdd(cursor + b, 1);",
         "          const int slot = row[k] & ((1 << kBucketLog) - 1);"),
        (STATS, "  const int count = min(cursor[bucket], capacity);",
         "  const int count = capacity;"),
        (STATS, "  const int code = scan(p, L, lay, scratch, st);\n",
         "  cudaMemsetAsync(records, 0xFF, static_cast<size_t>(lay.bytes - lay.records), st);\n"
         "  const int code = scan(p, L, lay, scratch, st);\n")],
    "8 items": [(SCAN, "constexpr int kItems = 16;", "constexpr int kItems = 8;")],
    "1 block an SM": [(SCAN, "__global__ void __launch_bounds__(kThreads, 2) scan_kernel",
                       "__global__ void __launch_bounds__(kThreads) scan_kernel")],
    "3 blocks an SM": [(SCAN, "__global__ void __launch_bounds__(kThreads, 2) scan_kernel",
                        "__global__ void __launch_bounds__(kThreads, 3) scan_kernel")],
    "no look-back": [(SCAN, "    const Seg prefix = look_back(st, tile);",
                      "    const Seg prefix = Seg::identity();")],
    "no writes": [(STATS, "    out.put(it.val, it.count, it.sum,",
                   "    if (it.count[0] == -7) out.put(it.val, it.count, it.sum,")],
}
INEXACT = {"no look-back", "no writes"}



def _sub(src: str, old: str, new: str, what: str) -> str:
    if old not in src:
        raise RuntimeError(f"{what} no longer holds {old!r}: update stats_sweep")
    return src.replace(old, new)


def design() -> tuple[str, dict]:
    """(name, {copy: [(old, new), ...]}) of the design the tree holds."""
    scan = (_build.CSRC / "seg_scan.cuh").read_text()
    if "seg_apply_kernel" in scan:
        return "three-pass", THREE_PASS
    if "look_back" in scan:
        return "single-pass", SINGLE_PASS
    raise RuntimeError("stats_sweep: seg_scan.cuh holds no design this script knows")


def build(variants: dict, out_dir: Path) -> dict:
    """{name: ctypes library} of merge_stats.cu with each variant's
    rewrites, one nvcc each, all at once."""
    paths = {}
    for name, subs in {"source": [], **variants}.items():
        d = out_dir / name.replace(" ", "_")
        d.mkdir()
        for file in ("seg_scan.cuh", "merge_stats.cu"):
            src = (_build.CSRC / file).read_text()
            for target, old, new in subs:
                if target == file:
                    src = _sub(src, old, new, file)
            (d / file).write_text(src)
        paths[name] = (d / "merge_stats.cu", d / "lib.so")
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)]
                     for cu, so in paths.values()])
    libs = {}
    for name, (_, so) in paths.items():
        lib = ctypes.CDLL(str(so))
        for entry in ("ccve_merge_stats_i32", "ccve_merge_stats_i64", "ccve_merge_scan_stats_i64"):
            fn = getattr(lib, entry)
            fn.argtypes = _build._ENTRY_POINTS[entry]
            fn.restype = ctypes.c_int
        lib.ccve_merge_stats_scratch_bytes.argtypes = _build._SIZE_FUNCTIONS[
            "ccve_merge_stats_scratch_bytes"]
        lib.ccve_merge_stats_scratch_bytes.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def launcher(lib, s, v, n, per_element: bool):
    """(launch, exact): a raw launch of `lib`'s row form on (s, v, n), and
    a check of its outputs against the plain version's (per element: the
    run value at every stream position)."""
    L = s.numel()
    rows = L if per_element else n
    size_args = (L, n)[:len(_build._SIZE_FUNCTIONS["ccve_merge_stats_scratch_bytes"])]
    scratch = torch.empty(lib.ccve_merge_stats_scratch_bytes(*size_args), dtype=torch.uint8,
                          device=s.device)
    mult = torch.zeros(rows, dtype=torch.int32, device=s.device)
    psum = torch.zeros(rows, dtype=torch.int64, device=s.device)
    entry = getattr(lib, f"ccve_merge_stats_{_build.SUFFIX[s.dtype]}")
    stream = _build.stream(s)

    def launch():
        code = entry(s.data_ptr(), v.data_ptr(), L, n, scratch.data_ptr(), mult.data_ptr(),
                     psum.data_ptr(), stream)
        _build.check(code, "stats_sweep")

    def exact() -> bool:
        mult.zero_()
        psum.zero_()
        launch()
        if per_element:
            count, total = merge_scan._run_sums(s >> 1, (s & 1) == 0, v.to(torch.int64))
            want = (count.to(torch.int32), total)
        else:
            want = merge_scan.merge_stats_plain(s, v, n)
        return torch.equal(mult, want[0]) and torch.equal(psum, want[1])

    return launch, exact


def generic_launcher(lib, sk, st):
    """(launch, exact) of `lib`'s generic entry on (sk, st)."""
    L = sk.numel()
    scratch = torch.empty(lib.ccve_merge_stats_scratch_bytes(
        *(L, 0)[:len(_build._SIZE_FUNCTIONS["ccve_merge_stats_scratch_bytes"])]),
        dtype=torch.uint8, device=sk.device)
    mult = torch.empty(L, dtype=torch.int32, device=sk.device)
    psum = torch.empty(L, dtype=torch.int64, device=sk.device)
    stream = _build.stream(sk)

    def launch():
        code = lib.ccve_merge_scan_stats_i64(sk.data_ptr(), st.data_ptr(), L, scratch.data_ptr(),
                                             mult.data_ptr(), psum.data_ptr(), stream)
        _build.check(code, "stats_sweep")

    def exact() -> bool:
        launch()
        want = merge_scan.merge_scan_stats_plain(sk, st)
        return torch.equal(mult, want[0]) and torch.equal(psum, want[1])

    return launch, exact


def timed(launch) -> str:
    ts = sorted(kernel_split._event_ms(launch, CHAIN) * 1e3 for _ in range(5))
    return f"{ts[2]:.2f} ({ts[0]:.2f}-{ts[-1]:.2f}) us"


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stats_sweep: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    name, variants = design()
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(variants, Path(tmp))
        print(f"#15 and #8's row form, {name} design, raw launches: CUDA events, median "
              f"(min-max) of 5 chains of {CHAIN}, and device us a kernel, on [{card}]:")
        for shape, (s, v, n) in kernel_split.stats_scan_inputs(device).items():
            cases = {f"{shape} ({s.numel()} elements, {n} rows)":
                     lambda lib, copy, a=(s, v, n): launcher(lib, *a, copy == "per element")}
            if s.dtype == torch.int64:
                sk, st = kernel_split._generic(s, v)
                cases[f"generic entry, {shape} untagged"] = (
                    lambda lib, copy, a=(sk, st): generic_launcher(lib, *a))
            for case, make in cases.items():
                for copy, lib in libs.items():
                    launch, exact = make(lib, copy)
                    if copy not in INEXACT and not exact():
                        raise AssertionError(f"{copy}, {case}: disagrees with the plain version")
                    d = kernel_split.device_split(launch)
                    print(f"SWEEP {copy}, {case}: call {timed(launch)}, device {d['us']:.2f} us "
                          f"in {d['events']:g} events ({d['kernels']}; {d['complete']} of "
                          f"{kernel_split.TRACE_WINDOWS} windows complete)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
