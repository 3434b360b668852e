"""Sorted runs of an int32 or int64 stream: a tile sort plus merge levels.

Counterpart of `ccve_tpu.kernels.bigsort._sort_padded_buf(...,
n_levels_cap=cap)` for int32 keys and of
`ccve_tpu.kernels.pairsort.pallas_sort_i64_limbs(..., n_levels_cap=cap)`
for int64 keys: the padded stream is sorted tile by tile (`sort_tiles_i32`,
`sort_tiles_i64`, kernel csrc/sort_tiles.cu: 16 keys a thread sorted in
registers, then merge-path rounds in shared memory, the multi-plane tile
sort's template with no cargo), then merge levels double the
run length (`merge_level_i32`, `merge_level_i64`, kernel
csrc/merge_multi.cu with no planes: a merge-path partition and the merge,
two launches a level) until runs reach 2^run_log or cover the stream.
`sort_runs` drives the two for either key type: on CUDA tensors in one
host call (`ccve_sort_runs`: every launch enqueued from C, one output, one
scratch buffer, one split scratch), on the CPU through the plain versions
level by level. `sort_runs_narrowed` (int32 keys) and `sort_runs_narrowed_i64`
(int64 keys, a wide table's) are the count side's ladders read straight
from its int64 or int32 probe column: their tile sort narrows each key as
it loads it (`ccve_sort_runs_narrow_i32`, `_i64`), so no narrowed or
padded copy of the column is written. They are the only count-side
ladders on a main path: `sort_runs` and the key-only tile sorts
`sort_tiles_i32` and `sort_tiles_i64` of a packed stream remain for the
tests and the measuring tools, for `ops.sort_merge._count_side_bc`, and
as the narrowing ladders' CPU route. `merge_sorted_i32` (kernel
csrc/merge_multi.cu, the key-only merge) is the counterpart of
`ccve_tpu.kernels.bigsort.merge_sorted_i32`: two ascending int32 streams
into one.

The port's tile is 2^TILE_LOG = 8192 keys, one block's shared memory on
the card (the TPU's 2^17 tile was sized for VMEM), for both key types. Every
run is stored ascending at every level, so the TPU's alternating orientation
and `force_asc` are gone; the runs returned are those of the JAX ladder
(ascending, 2^run_log keys each, the last one possibly shorter). The int64
key is native: the TPU's (hi, lo) limb planes have no job.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable

import torch

from ccve_tpu_torch.kernels import _build

TILE_LOG = 13
MAX_TILE_LOG = 13  # 2^13 keys: 34 KB (int32) or 68 KB (int64) of shared memory, skewed
I32_MAX = 2**31 - 1
I64_MAX = 2**63 - 1
# the sort padding of each key type: its maximum, which sorts last
PAD = {torch.int32: I32_MAX, torch.int64: I64_MAX}


def sort_tiles_plain(x: torch.Tensor, tile_log: int) -> torch.Tensor:
    """`sort_tiles_i32` / `sort_tiles_i64` as a per-tile torch.sort, on any
    device."""
    return x.view(-1, 1 << tile_log).sort(dim=1).values.reshape(-1)


def merge_level_plain(x: torch.Tensor, run_log: int) -> torch.Tensor:
    """`merge_level_i32` / `merge_level_i64` as a torch.sort of each run
    pair, on any device."""
    n = x.numel()
    pair = 2 << run_log
    full = n - n % pair
    head = x[:full].view(-1, pair).sort(dim=1).values.reshape(-1)
    return torch.cat([head, x[full:].sort().values])


def _check_tiles(x, tile_log: int, dtype) -> None:
    _build.check_int(x, "x", dtype)
    if not 1 <= tile_log <= MAX_TILE_LOG:
        raise ValueError(f"tile_log {tile_log} outside [1, {MAX_TILE_LOG}]")
    if x.numel() % (1 << tile_log):
        raise ValueError(f"length {x.numel()} is not a multiple of 2^{tile_log}")


def _sort_tiles(wrapper, x, tile_log: int, dtype) -> torch.Tensor:
    _check_tiles(x, tile_log, dtype)
    n = x.numel()
    if x.device.type == "cpu":
        return sort_tiles_plain(x, tile_log)
    y = torch.empty_like(x)
    if n:
        entry = getattr(_build.load(), f"ccve_sort_tiles_{_build.SUFFIX[dtype]}")
        code = entry(x.data_ptr(), y.data_ptr(), n >> tile_log, tile_log, _build.stream(x))
        _build.check(code, wrapper.__name__)
        wrapper.launches += 1
    return y


def sort_tiles_i32(x: torch.Tensor, tile_log: int = TILE_LOG) -> torch.Tensor:
    """Each 2^tile_log-value tile of int32[n] sorted ascending
    (n a multiple of the tile)."""
    return _sort_tiles(sort_tiles_i32, x, tile_log, torch.int32)


def sort_tiles_i64(x: torch.Tensor, tile_log: int = TILE_LOG) -> torch.Tensor:
    """Each 2^tile_log-value tile of int64[n] sorted ascending
    (n a multiple of the tile)."""
    return _sort_tiles(sort_tiles_i64, x, tile_log, torch.int64)


sort_tiles_i32.launches = 0
sort_tiles_i64.launches = 0


# The merge-path partition kernel of csrc/merge_multi.cu: it runs before
# every merge level (key-only or with planes) and every merge of two with
# planes, so its launches count apart.
merge_partition = SimpleNamespace(launches=0)


def _merge_level(wrapper, x, run_log: int, dtype) -> torch.Tensor:
    _build.check_int(x, "x", dtype)
    if not 0 <= run_log <= 30:
        raise ValueError(f"run_log {run_log} outside [0, 30]")
    if x.device.type == "cpu":
        return merge_level_plain(x, run_log)
    n = x.numel()
    if not n:
        return torch.empty_like(x)
    lib = _build.load()
    y, splits = _build.empty_with_scratch(x, n, lib.ccve_merge_splits_bytes(n, run_log))
    entry = getattr(lib, f"ccve_merge_level_{_build.SUFFIX[dtype]}")
    code = entry(x.data_ptr(), y.data_ptr(), splits, n, run_log, _build.stream(x))
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1
    merge_partition.launches += 1
    return y


def merge_level_i32(x: torch.Tensor, run_log: int) -> torch.Tensor:
    """One merge level over int32[n] made of ascending runs of 2^run_log
    (the last one may be short): each pair of neighbouring runs becomes one
    ascending run of 2^(run_log+1)."""
    return _merge_level(merge_level_i32, x, run_log, torch.int32)


def merge_level_i64(x: torch.Tensor, run_log: int) -> torch.Tensor:
    """`merge_level_i32` over int64[n]."""
    return _merge_level(merge_level_i64, x, run_log, torch.int64)


merge_level_i32.launches = 0
merge_level_i64.launches = 0

KERNELS = {
    torch.int32: (sort_tiles_i32, merge_level_i32),
    torch.int64: (sort_tiles_i64, merge_level_i64),
}


def _n_levels(n: int, run_log: int, tile_log: int) -> int:
    """The merge levels of a ladder over n keys: ceil(log2(n_tiles)) for
    one run, capped at run_log - tile_log."""
    if run_log < tile_log:
        raise ValueError(f"run_log {run_log} below tile_log {tile_log}")
    return min(max((n >> tile_log) - 1, 0).bit_length(), run_log - tile_log)


def _ladder(x, run_log, tile_log, sort_tiles: Callable, merge_level: Callable):
    n_levels = _n_levels(x.numel(), run_log, tile_log)
    y = sort_tiles(x, tile_log)
    for level in range(n_levels):
        y = merge_level(y, tile_log + level)
    return y


def sort_runs(x: torch.Tensor, run_log: int, tile_log: int = TILE_LOG) -> torch.Tensor:
    """int32[n_pad] or int64[n_pad] (n_pad a multiple of 2^tile_log) as
    independently sorted ascending runs of 2^run_log values: a tile sort,
    then run_log - tile_log merge levels at most (fewer when one run
    already covers the stream), on the kernels of the key type. On CUDA
    tensors one host call enqueues the tile sort and every level; each
    launch counts on its wrapper (and each level's partition on
    `merge_partition`)."""
    dtype = _build.key_dtype(x, "x")
    sort_tiles, merge_level = KERNELS[dtype]
    if x.device.type == "cpu":
        return _ladder(x, run_log, tile_log, sort_tiles, merge_level)
    _check_tiles(x, tile_log, dtype)
    n = x.numel()
    n_levels = _n_levels(n, run_log, tile_log)
    if not n:
        return torch.empty_like(x)
    lib = _build.load()
    y, splits = _build.empty_with_scratch(x, n, lib.ccve_merge_splits_bytes(n, tile_log))
    t = torch.empty_like(y) if n_levels else y
    entry = getattr(lib, f"ccve_sort_runs_{_build.SUFFIX[dtype]}")
    code = entry(x.data_ptr(), y.data_ptr(), t.data_ptr(), splits, n, tile_log, n_levels,
                 _build.stream(x))
    _build.check(code, f"sort_runs_{_build.SUFFIX[dtype]}")
    sort_tiles.launches += 1
    merge_level.launches += n_levels
    merge_partition.launches += n_levels
    return y


def narrow_plain(col: torch.Tensor, lo: int, hi: int, kmin: int,
                 dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """The count side's probe keys of type `dtype` from an int64 or int32
    column: dtype(((clamp(x, lo, hi) - kmin) + 1) << 1) in int64
    arithmetic, as `ops.sort_merge._probe_key32` (int32) and
    `_probe_key64` (int64) narrow them (lo <= hi: their clamp bounds,
    saturated at the int64 range)."""
    return ((col.to(torch.int64).clamp(lo, hi) - kmin + 1) << 1).to(dtype)


def _narrowed_padded(col: torch.Tensor, lo: int, hi: int, kmin: int, n_pad: int, dtype):
    p = narrow_plain(col, lo, hi, kmin, dtype)
    return torch.cat([p, p.new_full((n_pad - p.numel(),), PAD[dtype])])


def sort_runs_narrowed_plain(col: torch.Tensor, lo: int, hi: int, kmin: int, n_pad: int,
                             run_log: int, tile_log: int = TILE_LOG,
                             dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """`sort_runs_narrowed` (`sort_runs_narrowed_i64` with dtype int64)
    composed of torch passes and the plain ladder, on any device: the
    column narrowed (`narrow_plain`), padded with PAD[dtype] to n_pad keys,
    then `sort_runs_plain`."""
    return sort_runs_plain(_narrowed_padded(col, lo, hi, kmin, n_pad, dtype), run_log, tile_log)


def _sort_runs_narrowed(wrapper, dtype, col, lo: int, hi: int, kmin: int, n_pad: int,
                        run_log: int, tile_log: int) -> torch.Tensor:
    _build.check_int(col, "col", _build.key_dtype(col, "col"), contiguous=False)
    n = col.numel()
    if n_pad < n or n_pad >= 2**31 or n_pad % (1 << tile_log):
        raise ValueError(f"n_pad {n_pad} is not a multiple of 2^{tile_log} in [{n}, 2^31)")
    if not lo <= hi:
        raise ValueError(f"clamp bounds {lo} > {hi}")
    if col.device.type == "cpu":
        return sort_runs(_narrowed_padded(col, lo, hi, kmin, n_pad, dtype), run_log, tile_log)
    n_levels = _n_levels(n_pad, run_log, tile_log)
    y = col.new_empty(0, dtype=dtype)
    if not n_pad:
        return y
    lib = _build.load()
    y, splits = _build.empty_with_scratch(y, n_pad, lib.ccve_merge_splits_bytes(n_pad, tile_log))
    t = torch.empty_like(y) if n_levels else y
    entry = getattr(lib, f"ccve_sort_runs_narrow_{_build.SUFFIX[dtype]}")
    code = entry(
        col.data_ptr(), int(col.dtype == torch.int64), n, col.stride(0), lo, hi, kmin,
        y.data_ptr(), t.data_ptr(), splits, n_pad, tile_log, n_levels, _build.stream(col),
    )
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1
    KERNELS[dtype][1].launches += n_levels
    merge_partition.launches += n_levels
    return y


def sort_runs_narrowed(col: torch.Tensor, lo: int, hi: int, kmin: int, n_pad: int,
                       run_log: int, tile_log: int = TILE_LOG) -> torch.Tensor:
    """`sort_runs` of the count side's int32 probe stream, read from the
    raw probe column: int32[n_pad] in runs of 2^run_log, the column's n
    keys narrowed as `narrow_plain` narrows them and padded with PAD[int32]
    to n_pad (a multiple of 2^tile_log, at least n). The column may be a
    strided view (one column of a probe table): it is read in place.

    On CUDA tensors one host call (`ccve_sort_runs_narrow_i32`) enqueues
    the tile sort, which narrows each key in registers as it loads it
    (csrc/sort_tiles.cu), and the same merge levels as `sort_runs`: the
    narrowed and padded stream is never written. It counts one call here,
    and its levels on `merge_level_i32` and `merge_partition` as
    `sort_runs` counts them; its tile sort is its own kernel, not
    `sort_tiles_i32`. On the CPU it is that composition through
    `sort_runs`, whose CPU route runs the plain versions level by level:
    `sort_runs_narrowed_plain`'s result."""
    return _sort_runs_narrowed(sort_runs_narrowed, torch.int32, col, lo, hi, kmin, n_pad,
                               run_log, tile_log)


def sort_runs_narrowed_i64(col: torch.Tensor, lo: int, hi: int, kmin: int, n_pad: int,
                           run_log: int, tile_log: int = TILE_LOG) -> torch.Tensor:
    """`sort_runs_narrowed` into int64 keys: the count side's probe stream
    of a wide table (no `pack32`), int64[n_pad] in runs of 2^run_log, the
    column's keys narrowed as `narrow_plain(..., torch.int64)` (that is,
    `ops.sort_merge._probe_key64`) narrows them and padded with PAD[int64].
    One host call on CUDA tensors (`ccve_sort_runs_narrow_i64`: the tile
    sort's int64 form, 68 KB of shared memory a tile, then the
    `merge_level_i64` levels); it counts one call here, its levels on
    `merge_level_i64` and `merge_partition`, and never on `sort_tiles_i64`.
    On the CPU, `sort_runs_narrowed_plain(..., dtype=torch.int64)`'s
    result through `sort_runs`."""
    return _sort_runs_narrowed(sort_runs_narrowed_i64, torch.int64, col, lo, hi, kmin, n_pad,
                               run_log, tile_log)


sort_runs_narrowed.launches = 0
sort_runs_narrowed_i64.launches = 0


def sort_runs_plain(
    x: torch.Tensor, run_log: int, tile_log: int = TILE_LOG
) -> torch.Tensor:
    """`sort_runs` built from the plain versions, on any device: the
    yardstick a card run holds the kernels against."""
    _build.check_int(x, "x", _build.key_dtype(x, "x"))
    if x.numel() % (1 << tile_log):
        raise ValueError(f"length {x.numel()} is not a multiple of 2^{tile_log}")
    return _ladder(x, run_log, tile_log, sort_tiles_plain, merge_level_plain)


def merge_sorted_i32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`merge_sorted_i32` as torch.cat plus a stable sort, on any device."""
    return torch.cat([a, b]).sort(stable=True).values


def merge_sorted_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ascending merge of two ascending int32 streams (either may be
    empty; values may be any int32): int32[len(a) + len(b)], ties with A's
    elements first. Every length takes the kernel: the JAX entry's
    `lax.sort` below its 2^17 tile was a TPU tile-size workaround."""
    _build.check_i32(a, "a")
    _build.check_i32(b, "b")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.numel() + b.numel() >= 2**31:
        raise ValueError(f"{a.numel()} + {b.numel()} values, the kernel takes < 2^31")
    if a.device.type == "cpu":
        return merge_sorted_i32_plain(a, b)
    n = a.numel() + b.numel()
    if not n:
        return a.new_empty(0)
    lib = _build.load()
    # run_log 30: the splits of a merge of two, whose tiles take whole chunks
    y, splits = _build.empty_with_scratch(a, n, lib.ccve_merge_splits_bytes(n, 30))
    code = lib.ccve_merge_two_i32(
        a.data_ptr(), a.numel(), b.data_ptr(), b.numel(), y.data_ptr(), splits, _build.stream(a),
    )
    _build.check(code, "merge_sorted_i32")
    merge_sorted_i32.launches += 1
    return y


merge_sorted_i32.launches = 0
