"""#10's grid and block shape on the card, and where a call's time goes.

Run from the repository root on a machine with a CUDA GPU and nvcc:

    python -m ccve_tpu_torch.bench.drain_sweep

It builds copies of csrc/drain.cu (one nvcc each, all at once) that differ
from it only where this script rewrites it, holds every copy against
`drain_segment_plain`, and times each one's raw launches with CUDA events
(the median of 5 chains of CHAIN launches; min and max) at
`kernel_split.drain_cases`' shapes and at config 3's and config 7's first
16, 64, 128 and 264 chunks (FULL):

- `GRID` lines: the source's kernel at grids of 1/4 to 2 blocks an SM (and
  the odd 1.5), set from the host, against the grid the source picks;
- `SHAPE` lines: other (threads, most blocks an SM) at the source's rule;
- `STAMPS` lines: block 0's globaltimer read after each grid-wide barrier,
  the intervals in µs (median of 5 calls): per level, the count and its
  barrier, the scan, the scatter and its barrier; then the last level and
  the caches' gather.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ccve_tpu_torch.bench import kernel_split
from ccve_tpu_torch.kernels import _build, drain

CHAIN = 50
SHAPES = ((512, 1), (256, 2), (256, 4), (1024, 1))
STAMP = r'''
__device__ unsigned long long g_stamps[256];
__device__ unsigned int g_n;
__device__ __forceinline__ void stamp() {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (g_n < 256) g_stamps[g_n++] = t;
  }
}
}  // namespace
extern "C" int read_stamps(unsigned long long* out) {
  unsigned int n = 0;
  cudaMemcpyFromSymbol(&n, g_n, sizeof(n));
  cudaMemcpyFromSymbol(out, g_stamps, sizeof(unsigned long long) * (n < 256 ? n : 256));
  return static_cast<int>(n);
}
namespace {
'''


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"drain.cu no longer holds {old!r}: update drain_sweep")
    return src.replace(old, new)


def variant(threads=None, per_sm=None, grid_from_host=False, stamps=False) -> str:
    """drain.cu rewritten: another block shape, the grid set by
    `set_grid(g)` (0: the source's), or block 0's barrier stamps."""
    src = (_build.CSRC / "drain.cu").read_text()
    if threads is not None:
        src = re.sub(r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {threads};", src)
        src = re.sub(r"constexpr int kBlocksPerSM = \d+;",
                     f"constexpr int kBlocksPerSM = {per_sm};", src)
    if grid_from_host:
        src = _sub(src, "namespace {\n",
                   'namespace {\nint g_grid = 0;\n}\nextern "C" void set_grid(int g) '
                   "{ g_grid = g; }\nnamespace {\n")
        src = _sub(src, "  if (err != 0) return err;\n  void* args[] = {&a};",
                   "  if (err != 0) return err;\n  if (g_grid > 0) grid = g_grid;\n"
                   "  void* args[] = {&a};")
    if stamps:
        src = _sub(src, "\nstruct Args {", STAMP + "\nstruct Args {")
        src = _sub(src, "  const int CC = kOcc ? L : (L > 1 ? L - 1 : 1);\n",
                   "  const int CC = kOcc ? L : (L > 1 ? L - 1 : 1);\n"
                   "  if (b == 0 && tid == 0) g_n = 0;\n  stamp();\n")
        src = _sub(src, "grid.sync();", "grid.sync();\n      stamp();")
        src = _sub(src, "      if (last) break;  // the variant's",
                   "      stamp();\n      if (last) break;  // the variant's")
        src = _sub(src, "    // the outgoing caches' planes",
                   "    stamp();\n    // the outgoing caches' planes")
        src = _sub(src, "  if (b == 0) {  // block 0 wrote",
                   "  stamp();\n  if (b == 0) {  // block 0 wrote")
    return src


def build(sources: dict, out_dir: Path) -> dict:
    """{name: ctypes library} of each source, one nvcc each, all at once."""
    paths = {}
    for name, src in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        paths[name] = (cu, out_dir / f"{name}.so")
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)]
                     for cu, so in paths.values()])
    P, I, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, (_, so) in paths.items():
        lib = ctypes.CDLL(str(so))
        lib.ccve_drain_scratch_bytes.argtypes = [L_, I, I, I, P]
        lib.ccve_drain_scratch_bytes.restype = L_
        lib.ccve_drain_segment_i32.argtypes = [P] * 6 + [L_, I, I, I, I] + [P] * 8
        lib.ccve_drain_segment_i32.restype = I
        lib.ccve_drain_grid.argtypes = [L_, I, I, P]
        lib.ccve_drain_grid.restype = I
        libs[name] = lib
    return libs


def launcher(lib, args, kw):
    """A raw launch of `lib`'s drain on `args` (outputs allocated once),
    and a check of its outputs against the plain version's."""
    mults, counts, thr, cache_m, ccnt = args
    S, L, B = mults.shape
    occ = kw.get("record_occupancy", False)
    fan = (ctypes.c_int * L)(*kw["fanouts"])
    scratch = mults.new_empty(lib.ccve_drain_scratch_bytes(S, L, B, int(occ),
                                                           ctypes.addressof(fan)) // 4)
    total = torch.empty(1, dtype=torch.int64, device=mults.device)
    outs = [torch.empty_like(cache_m), torch.empty_like(ccnt), mults.new_empty(L),
            mults.new_empty(L), mults.new_empty((L, B + 1)) if occ else None]
    stream = _build.stream(mults)

    def launch():
        code = lib.ccve_drain_segment_i32(
            mults.data_ptr(), counts.data_ptr(), thr.data_ptr(), ctypes.addressof(fan),
            cache_m.data_ptr(), ccnt.data_ptr(), S, L, B, int(occ), 1, scratch.data_ptr(),
            total.data_ptr(), *(None if o is None else o.data_ptr() for o in outs), stream)
        _build.check(code, "drain_sweep")

    def exact(want) -> bool:
        launch()
        got = (total[0],) + tuple(o for o in outs[1:] if o is not None)
        return all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, (want[0],) + want[2:]))

    return launch, exact


def timed(launch) -> str:
    ts = sorted(kernel_split._event_ms(launch, CHAIN) * 1e3 for _ in range(5))
    return f"{ts[2]:.2f} ({ts[0]:.2f}-{ts[-1]:.2f})"


def cases(device) -> dict:
    out = kernel_split.drain_cases(device)
    for name in list(out):
        if "FULL" in name and "occ" not in name and ("S=489" in name or "S=977" in name):
            args, kw = out[name]
            for n in (16, 64, 128, 264):
                if n < args[0].shape[0]:
                    cut = (args[0][:n].contiguous(), args[1][:n].contiguous()) + tuple(args[2:])
                    out[name.split(" S=")[0] + f" S={n}"] = (cut, kw)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("drain_sweep: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sources = {"grid": variant(grid_from_host=True), "stamps": variant(stamps=True)}
    sources.update({f"{t}x{p}": variant(t, p) for t, p in SHAPES})
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, Path(tmp))
        grids = sorted({sms // 4, sms // 2, sms, 3 * sms // 2, 2 * sms})
        print(f"#10 raw launches, CUDA events, median (min-max) of 5 chains of {CHAIN}, us a "
              f"call, on [{card}], {sms} SMs:")
        for name, (args, kw) in cases(torch.device("cuda")).items():
            want = drain.drain_segment_plain(*args, **kw)
            S, fanouts = args[0].shape[0], kw["fanouts"]
            occ = int(kw.get("record_occupancy", False))
            own = libs["grid"].ccve_drain_grid(S, len(fanouts), occ, ctypes.addressof(
                (ctypes.c_int * len(fanouts))(*fanouts)))
            row = []
            for g in grids + [0]:
                libs["grid"].set_grid(g)
                launch, exact = launcher(libs["grid"], args, kw)
                if not exact(want):
                    raise AssertionError(f"{name}: grid {g} disagrees with the plain version")
                row.append(f"{g or f'own {own}'}: {timed(launch)}")
            libs["grid"].set_grid(0)
            print(f"GRID {name}: " + "; ".join(row), flush=True)
            row = []
            for t, p in SHAPES:
                launch, exact = launcher(libs[f"{t}x{p}"], args, kw)
                if not exact(want):
                    raise AssertionError(f"{name}: shape {t}x{p} disagrees")
                row.append(f"{t}x{p}: {timed(launch)}")
            print(f"SHAPE {name}: " + "; ".join(row), flush=True)
            launch, exact = launcher(libs["stamps"], args, kw)
            if not exact(want):
                raise AssertionError(f"{name}: the stamped copy disagrees")
            buf = (ctypes.c_ulonglong * 256)()
            reads = []
            for _ in range(5):
                launch()
                torch.cuda.synchronize()
                n = libs["stamps"].read_stamps(buf)
                reads.append([(buf[k + 1] - buf[k]) / 1e3 for k in range(n - 1)])
            mid = np.median(np.array(reads), axis=0)
            print(f"STAMPS {name}: " + " ".join(f"{x:.2f}" for x in mid) +
                  f" = {mid.sum():.2f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
