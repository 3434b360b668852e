"""Build and load the CUDA kernels of `csrc/`.

All `csrc/*.cu` files compile with nvcc for Hopper (`sm_90a`), one nvcc
per file and all at once, and link into one shared library with a plain C
interface, `build/libccve_torch_kernels.so`, loaded with ctypes. The
build happens at first use and again whenever a source is newer than the
library; without nvcc, or when the build fails,
`load` raises with nvcc's message. Every C entry point returns
`cudaGetLastError()` after its launch, and `check` raises on a non-zero
code, so a refused launch cannot pass unnoticed.

The launch goes to the tensor's device and PyTorch's current stream there
(`stream`); the kernels neither allocate nor synchronise.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
LIB_PATH = BUILD_DIR / "libccve_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> argtypes of every C entry point; each returns a cudaError_t as
# int. Every kernel has an _i32 and an _i64 build (the key type) with the
# same arguments, except those of one key type: the compaction, the drain,
# the dense build counts, the key-only merge and the roofline's
# compare-exchange stages (int32), and the hash, the
# chunk ranks and the generic and packed stats scans (int64).
_KEYED_ENTRY_POINTS = {
    # (x, y, n_tiles, tile_log, stream)
    "ccve_sort_tiles": [_P, _P, _L, _I, _P],
    # (x, y, splits, n, run_log, stream): a key-only merge level
    "ccve_merge_level": [_P, _P, _P, _L, _I, _P],
    # (x, y, t, splits, n, tile_log, n_levels, stream): a key-only tile sort
    # and a ladder
    "ccve_sort_runs": [_P, _P, _P, _P, _L, _I, _I, _P],
    # (runs, run_len, n_real, b, m, bc, stream)
    "ccve_merge_counts": [_P, _L, _L, _P, _L, _P, _P],
    # (xk, xv0, xv1, xv2, yk, yv0, yv1, yv2, n_planes, n, tile_log, stream)
    "ccve_sort_tiles_multi": [_P] * 8 + [_I, _L, _I, _P],
    # (xk, xv0, xv1, xv2, yk, yv0, yv1, yv2, splits, n_planes, n, run_log,
    #  stream)
    "ccve_merge_level_multi": [_P] * 9 + [_I, _L, _I, _P],
    # (xk, xv0, xv1, xv2, yk, yv0, yv1, yv2, tk, tv0, tv1, tv2, splits,
    #  n_planes, n, tile_log, n_levels, stream): a tile sort and a ladder
    "ccve_sort_multi": [_P] * 13 + [_I, _L, _I, _I, _P],
    # (ak, av0, av1, av2, na, bk, bv0, bv1, bv2, nb, yk, yv0, yv1, yv2,
    #  splits, n_planes, stream)
    "ccve_merge_two_multi": [_P] * 4 + [_L] + [_P] * 4 + [_L] + [_P] * 5 + [_I, _P],
    # (s, v, L, n, scratch, mult, psum, stream)
    "ccve_merge_stats": [_P, _P, _L, _L, _P, _P, _P, _P],
}
_ENTRY_POINTS = {
    f"{name}_{suffix}": argtypes
    for name, argtypes in _KEYED_ENTRY_POINTS.items()
    for suffix in ("i32", "i64")
}
# (planes, mask, n, n_planes, scratch, out, count, stream)
_ENTRY_POINTS["ccve_compact_i32"] = [_P, _P, _L, _I, _P, _P, _P, _P]
# (x, y, n, stream)
_ENTRY_POINTS["ccve_murmurhash64_i64"] = [_P, _P, _L, _P]
# (mults, counts, thresholds, fanouts (host), cache_in, ccnt_in, S, L,
#  block, occupancy, branchy, scratch, total, cache_out, ccnt_out, work,
#  rows, occ, stream)
_ENTRY_POINTS["ccve_drain_segment_i32"] = [_P] * 6 + [_L, _I, _I, _I, _I] + [_P] * 8
# (S, L, occupancy, fanouts (host)): the blocks of such a drain call on the
# current device, or minus a CUDA error
_ENTRY_POINTS["ccve_drain_grid"] = [_L, _I, _I, _P]
# (table, m, stride_log, keys, valid, n, out, stream)
_ENTRY_POINTS["ccve_chunk_rank_i64"] = [_P, _L, _I, _P, _P, _L, _P, _P]
# (sk, st, L, scratch, mult, psum, stream)
_ENTRY_POINTS["ccve_merge_scan_stats_i64"] = [_P, _P, _L, _P, _P, _P, _P]
# (s, L, pay_bits, scratch, mult, psum, stream)
_ENTRY_POINTS["ccve_merge_scan_stats_packed_i64"] = [_P, _L, _I, _P, _P, _P, _P]
# (s, L, m, grid, scratch, bc, stream)
_ENTRY_POINTS["ccve_merge_build_counts_i32"] = [_P, _L, _L, _I, _P, _P, _P]
# (a, na, b, nb, y, splits, stream)
_ENTRY_POINTS["ccve_merge_two_i32"] = [_P, _L, _P, _L, _P, _P, _P]
# (x, y, n_tiles, n_stages, stream)
_ENTRY_POINTS["ccve_ce_stages_i32"] = [_P, _P, _L, _I, _P]
# name -> argtypes of the C functions that size a kernel's scratch; each
# returns a byte count
_SIZE_FUNCTIONS = {
    # (L, n): a stream of L elements, n output rows (0: per element)
    "ccve_merge_stats_scratch_bytes": [_L, _L],
    "ccve_compact_scratch_bytes": [_L],
    # (n, run_log): the merge-path splits of a merge of n outputs
    "ccve_merge_splits_bytes": [_L, _I],
    # (S, L, block, occupancy, fanouts (host)); -1 where they do not fit
    "ccve_drain_scratch_bytes": [_L, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of ccve_tpu_torch build only where the CUDA toolkit is"
    )


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in _sources())


def _run_all(commands: list[list[str]]) -> None:
    """Run the commands at the same time; raise with the first failure's
    message once all have ended."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cmd in commands
    ]
    failures = []
    for cmd, proc in zip(commands, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n{err}")
    if failures:
        raise RuntimeError("nvcc failed: " + "\n".join(failures))


def build() -> Path:
    """Compile every `csrc/*.cu` into LIB_PATH (written atomically): one
    nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    units = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objects = [str(Path(objdir) / f"{u.stem}.o") for u in units]
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(u)]
            for u, obj in zip(units, objects)
        ])
        tmp = str(Path(objdir) / LIB_PATH.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objects]])
        os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load() -> ctypes.CDLL:
    """The kernel library, built first if missing or older than a source."""
    global _lib
    if _lib is not None:  # loaded: no lock on the launch path
        return _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I
            for name, argtypes in _SIZE_FUNCTIONS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _L
            lib.ccve_cuda_error_string.argtypes = [_I]
            lib.ccve_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device (the raw cudaStream_t, as
    PyTorch's own generated kernel launchers read it: one C call, where
    `torch.cuda.current_stream(device).cuda_stream` builds a Stream object
    a launch), after checking that the device is the current one (the
    library launches on the current device)."""
    index = t.get_device()
    if index != torch.cuda.current_device():
        raise ValueError(
            f"tensor on {t.device}, but the current CUDA device is "
            f"{torch.cuda.current_device()}"
        )
    return torch._C._cuda_getCurrentRawStream(index)


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load().ccve_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


SUFFIX = {torch.int32: "i32", torch.int64: "i64"}


def empty_with_scratch(like: torch.Tensor, n: int, scratch_bytes: int):
    """(out, scratch pointer): an uninitialised tensor of `n` elements of
    `like`'s type and device, and the address of at least `scratch_bytes`
    of scratch after it in the same allocation, so that a kernel's scratch
    costs no allocation (nor view) of its own on a host-bound path."""
    buf = like.new_empty(n + -(-scratch_bytes // like.element_size()))
    return buf[:n], buf.data_ptr() + n * like.element_size()


def check_int(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """The checks every wrapper makes on an operand of `dtype`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected a 1-D tensor, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if not (t.is_cuda or t.is_cpu):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.numel() >= 2**31:
        raise ValueError(f"{name}: {t.numel()} elements, the kernels take < 2^31")


def check_i32(t: torch.Tensor, name: str) -> None:
    """The checks every wrapper makes on an int32 operand."""
    check_int(t, name, torch.int32)


def key_dtype(t: torch.Tensor, name: str) -> torch.dtype:
    """The key type of an operand that may be int32 or int64 keys."""
    dtype = getattr(t, "dtype", None)
    if dtype not in SUFFIX:
        raise TypeError(f"{name}: expected int32 or int64 keys, got {dtype}")
    return dtype
