"""Multi-plane sort and merge: int32 or int64 keys carrying 1-3 int32
cargo planes.

Counterpart of `ccve_tpu.kernels.pairsort` (`pallas_sort_multi_i32`,
`pallas_sort_multi_i32_runs`, `merge_sorted_multi_i32`, and for int64 keys
`pallas_sort_multi_i64`, `merge_sorted_multi_i64`). Two kernels, each with
an int32 and an int64 build:

 - `sort_tiles_multi_i32` / `_i64` (csrc/sort_tiles.cu, the template of
   the count side's key-only tile sort) sort each 2^tile_log-key tile and
   move the planes with their keys;
 - `merge_level_multi_i32` / `_i64` and `merge_two_multi_i32` / `_i64`
   (csrc/merge_multi.cu) are one ladder level and the unequal merge of two
   sorted streams.

The entry points `sort_multi_i32`, `sort_multi_i64` and
`sort_multi_i32_runs` run the tile sort and the merge ladder: on CUDA
tensors in one host call (`ccve_sort_multi`: every launch enqueued from
C), on the CPU through the plain versions level by level.
`merge_sorted_multi_i32` and `merge_sorted_multi_i64` are the merge of two.
Each merge level and merge of two is two launches, a merge-path partition
(counted by `merge_partition.launches`) and the merge. Every
step is stable (ties keep their input order, A before B in a merge), where
the TPU's sort is not, so a kernel and its plain version (a stable
torch.sort plus a gather) agree exactly, and a sort's cargo order is
determined. Against the JAX package only the key plane is exact; (key,
cargo...) tuples agree as multisets. The int64 key is native: the TPU's
(hi, lo) limb planes have no job.

Every n goes through the kernels: the JAX entry points' `n <= tile`
`lax.sort` branches were a TPU tile-size workaround. Keys may take any
value of their type: padding (the type's maximum as key, zero cargo) is
appended after the real elements and a stable sort keeps it behind them.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Sequence

import torch

from ccve_tpu_torch.kernels import _build
from ccve_tpu_torch.kernels.bigsort import PAD

TILE_LOG = 13
MAX_TILE_LOG = 13  # 2^13 (key, index) words a tile: 68 KB (int32) or 85 KB (int64) skewed
MAX_PLANES = 3


def _check_planes(keys: torch.Tensor, vals: Sequence[torch.Tensor], name: str, dtype=None):
    """The planes as a list, after checking keys (of `dtype`, or int32 or
    int64 when None) and 1..MAX_PLANES int32 planes of the keys' length
    and device."""
    _build.check_int(keys, f"{name} keys", dtype or _build.key_dtype(keys, f"{name} keys"))
    vals = list(vals)
    if not 1 <= len(vals) <= MAX_PLANES:
        raise ValueError(f"{name}: {len(vals)} cargo planes, expected 1..{MAX_PLANES}")
    for i, v in enumerate(vals):
        _build.check_i32(v, f"{name} plane {i}")
        if v.numel() != keys.numel() or v.device != keys.device:
            raise ValueError(
                f"{name} plane {i}: {v.numel()} values on {v.device}, keys "
                f"{keys.numel()} on {keys.device}"
            )
    return vals


def _ptrs(ts: Sequence[torch.Tensor]) -> list:
    """data_ptr()s of `ts`, padded with None to MAX_PLANES."""
    return [t.data_ptr() for t in ts] + [None] * (MAX_PLANES - len(ts))


def sort_tiles_multi_plain(keys, vals, tile_log: int):
    """`sort_tiles_multi_i32` as a stable per-tile torch.sort plus a gather,
    on any device."""
    tile = 1 << tile_log
    sorted_keys, order = keys.view(-1, tile).sort(dim=1, stable=True)
    return sorted_keys.reshape(-1), [
        v.view(-1, tile).gather(1, order).reshape(-1) for v in vals
    ]


def merge_level_multi_plain(keys, vals, run_log: int):
    """`merge_level_multi_i32` as a stable torch.sort of each run pair plus
    a gather, on any device."""
    n = keys.numel()
    pair = 2 << run_log
    full = n - n % pair
    head_keys, head_order = keys[:full].view(-1, pair).sort(dim=1, stable=True)
    tail_keys, tail_order = keys[full:].sort(stable=True)
    return torch.cat([head_keys.reshape(-1), tail_keys]), [
        torch.cat([
            v[:full].view(-1, pair).gather(1, head_order).reshape(-1),
            v[full:][tail_order],
        ])
        for v in vals
    ]


def merge_two_multi_plain(ak, avs, bk, bvs):
    """`merge_two_multi_i32` as a stable torch.sort of A then B plus a
    gather, on any device."""
    keys, order = torch.cat([ak, bk]).sort(stable=True)
    return keys, [torch.cat([a, b])[order] for a, b in zip(avs, bvs)]


def _check_tiles(n: int, tile_log: int) -> None:
    if not 1 <= tile_log <= MAX_TILE_LOG:
        raise ValueError(f"tile_log {tile_log} outside [1, {MAX_TILE_LOG}]")
    if n % (1 << tile_log):
        raise ValueError(f"length {n} is not a multiple of 2^{tile_log}")


def _sort_tiles_multi(wrapper, keys, vals, tile_log: int, dtype):
    vals = _check_planes(keys, vals, wrapper.__name__, dtype)
    n = keys.numel()
    _check_tiles(n, tile_log)
    if keys.device.type == "cpu":
        return sort_tiles_multi_plain(keys, vals, tile_log)
    out_keys = torch.empty_like(keys)
    out_vals = [torch.empty_like(v) for v in vals]
    if n:
        entry = getattr(_build.load(), f"ccve_sort_tiles_multi_{_build.SUFFIX[dtype]}")
        code = entry(
            keys.data_ptr(), *_ptrs(vals), out_keys.data_ptr(), *_ptrs(out_vals),
            len(vals), n, tile_log, _build.stream(keys),
        )
        _build.check(code, wrapper.__name__)
        wrapper.launches += 1
    return out_keys, out_vals


def sort_tiles_multi_i32(keys, vals, tile_log: int = TILE_LOG):
    """Each 2^tile_log-key tile of int32[n] sorted ascending, stably, with
    its cargo planes (n a multiple of the tile). Returns (keys, planes)."""
    return _sort_tiles_multi(sort_tiles_multi_i32, keys, vals, tile_log, torch.int32)


def sort_tiles_multi_i64(keys, vals, tile_log: int = TILE_LOG):
    """`sort_tiles_multi_i32` for int64 keys (the planes stay int32)."""
    return _sort_tiles_multi(sort_tiles_multi_i64, keys, vals, tile_log, torch.int64)


sort_tiles_multi_i32.launches = 0
sort_tiles_multi_i64.launches = 0


# The merge-path partition kernel of csrc/merge_multi.cu: it runs before
# every merge level and every merge of two, so its launches count apart.
merge_partition = SimpleNamespace(launches=0)

# run_log of a merge of two in `ccve_merge_splits_bytes`: tiles of the
# kernel's whole chunk
_TWO_RUN_LOG = 30


def _merge_outputs(keys, vals, n: int, run_log: int):
    """(keys, planes, splits): the outputs of a merge of n elements and the
    address of the split scratch its partition kernel writes, after the
    keys in their allocation."""
    out_keys, splits = _build.empty_with_scratch(
        keys, n, _build.load().ccve_merge_splits_bytes(n, run_log))
    return out_keys, [vals[0].new_empty(n) for _ in vals], splits


def _merge_level_multi(wrapper, keys, vals, run_log: int, dtype):
    vals = _check_planes(keys, vals, wrapper.__name__, dtype)
    if not 0 <= run_log <= 30:
        raise ValueError(f"run_log {run_log} outside [0, 30]")
    if keys.device.type == "cpu":
        return merge_level_multi_plain(keys, vals, run_log)
    n = keys.numel()
    if not n:
        return torch.empty_like(keys), [torch.empty_like(v) for v in vals]
    out_keys, out_vals, splits = _merge_outputs(keys, vals, n, run_log)
    entry = getattr(_build.load(), f"ccve_merge_level_multi_{_build.SUFFIX[dtype]}")
    code = entry(
        keys.data_ptr(), *_ptrs(vals), out_keys.data_ptr(), *_ptrs(out_vals),
        splits, len(vals), n, run_log, _build.stream(keys),
    )
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1
    merge_partition.launches += 1
    return out_keys, out_vals


def merge_level_multi_i32(keys, vals, run_log: int):
    """One stable merge level over int32[n] keys made of ascending runs of
    2^run_log (the last may be short), with their cargo planes: each pair
    of neighbouring runs becomes one run of 2^(run_log+1)."""
    return _merge_level_multi(merge_level_multi_i32, keys, vals, run_log, torch.int32)


def merge_level_multi_i64(keys, vals, run_log: int):
    """`merge_level_multi_i32` for int64 keys."""
    return _merge_level_multi(merge_level_multi_i64, keys, vals, run_log, torch.int64)


merge_level_multi_i32.launches = 0
merge_level_multi_i64.launches = 0
_MULTI_WRAPPERS = {
    torch.int32: (sort_tiles_multi_i32, merge_level_multi_i32),
    torch.int64: (sort_tiles_multi_i64, merge_level_multi_i64),
}


def _merge_two_multi(wrapper, ak, avs, bk, bvs, dtype):
    name = wrapper.__name__
    avs = _check_planes(ak, avs, f"{name} A", dtype)
    bvs = _check_planes(bk, bvs, f"{name} B", dtype)
    if len(avs) != len(bvs) or ak.device != bk.device:
        raise ValueError(
            f"{name}: A has {len(avs)} planes on {ak.device}, B {len(bvs)} on {bk.device}"
        )
    n = ak.numel() + bk.numel()
    if n >= 2**31:
        raise ValueError(f"{name}: {n} elements, the kernels take < 2^31")
    if ak.device.type == "cpu":
        return merge_two_multi_plain(ak, avs, bk, bvs)
    if not n:
        return ak.new_empty(0), [avs[0].new_empty(0) for _ in avs]
    out_keys, out_vals, splits = _merge_outputs(ak, avs, n, _TWO_RUN_LOG)
    entry = getattr(_build.load(), f"ccve_merge_two_multi_{_build.SUFFIX[dtype]}")
    code = entry(
        ak.data_ptr(), *_ptrs(avs), ak.numel(),
        bk.data_ptr(), *_ptrs(bvs), bk.numel(),
        out_keys.data_ptr(), *_ptrs(out_vals), splits, len(avs),
        _build.stream(ak),
    )
    _build.check(code, name)
    wrapper.launches += 1
    merge_partition.launches += 1
    return out_keys, out_vals


def merge_two_multi_i32(ak, avs, bk, bvs):
    """The stable merge of two ascending int32 key streams with their cargo
    planes (ties: A's elements first; either stream may be empty).
    Returns (keys, planes) of length |A| + |B|."""
    return _merge_two_multi(merge_two_multi_i32, ak, avs, bk, bvs, torch.int32)


def merge_two_multi_i64(ak, avs, bk, bvs):
    """`merge_two_multi_i32` for int64 keys."""
    return _merge_two_multi(merge_two_multi_i64, ak, avs, bk, bvs, torch.int64)


merge_two_multi_i32.launches = 0
merge_two_multi_i64.launches = 0


def pad_to_tile(keys, vals, tile_log: int):
    """(keys, planes) padded to a multiple of the 2^tile_log tile: keys with
    their type's maximum, planes with 0 (the tile sort's input)."""
    pad = (-keys.numel()) % (1 << tile_log)
    if not pad:
        return keys, list(vals)
    return (
        torch.cat([keys, keys.new_full((pad,), PAD[keys.dtype])]),
        [torch.cat([v, v.new_zeros(pad)]) for v in vals],
    )


def _ladder_plain(keys, vals, tile_log: int, n_levels: int):
    """Padding to whole tiles, the tile sort, then n_levels merge levels, by
    the plain versions level by level, on any device."""
    keys, vals = sort_tiles_multi_plain(*pad_to_tile(keys, vals, tile_log), tile_log)
    for level in range(n_levels):
        keys, vals = merge_level_multi_plain(keys, vals, tile_log + level)
    return keys, vals


def _ladder_kernels(keys, vals, tile_log: int, n_levels: int):
    """`_ladder_plain` on CUDA tensors in one host call (`ccve_sort_multi`:
    the tile sort pads in the kernel, and the levels run back to back on the
    stream between the output and one scratch buffer); on the CPU the plain
    versions."""
    if keys.device.type == "cpu":
        return _ladder_plain(keys, vals, tile_log, n_levels)
    n = keys.numel() + (-keys.numel()) % (1 << tile_log)
    _check_tiles(n, tile_log)
    dtype = keys.dtype
    sort_tiles, merge_level = _MULTI_WRAPPERS[dtype]
    out_keys, out_vals, splits = _merge_outputs(keys, vals, n, tile_log)
    if n:
        tmp_keys = torch.empty_like(out_keys)
        tmp_vals = [torch.empty_like(v) for v in out_vals]
        entry = getattr(_build.load(), f"ccve_sort_multi_{_build.SUFFIX[dtype]}")
        code = entry(
            keys.data_ptr(), *_ptrs(vals), out_keys.data_ptr(), *_ptrs(out_vals),
            tmp_keys.data_ptr(), *_ptrs(tmp_vals), splits, len(vals),
            keys.numel(), tile_log, n_levels, _build.stream(keys),
        )
        _build.check(code, f"sort_multi_{_build.SUFFIX[dtype]}")
        sort_tiles.launches += 1
        merge_level.launches += n_levels
        merge_partition.launches += n_levels
    return out_keys, out_vals


def _sort_runs(keys, vals, run_log, tile_log, ladder, dtype=None):
    vals = _check_planes(keys, vals, "sort", dtype)
    if run_log < tile_log:
        raise ValueError(f"run_log {run_log} below tile_log {tile_log}")
    n_tiles = -(-keys.numel() >> tile_log)
    n_levels = min(max(n_tiles - 1, 0).bit_length(), run_log - tile_log)
    return ladder(keys, vals, tile_log, n_levels)


def _sort(keys, vals, tile_log, ladder, dtype=None):
    n = keys.numel()
    n_tiles = -(-n >> tile_log)
    run_log = tile_log + max(n_tiles - 1, 0).bit_length()
    keys, vals = _sort_runs(keys, vals, run_log, tile_log, ladder, dtype)
    return keys[:n], [v[:n] for v in vals]


def sort_multi_i32_runs(keys, vals, run_log: int, tile_log: int = TILE_LOG):
    """(keys, planes) padded to a multiple of the tile (INT32_MAX keys, zero
    cargo) and sorted stably into ascending runs of 2^run_log (the last may
    be shorter): a tile sort, then at most run_log - tile_log merge
    levels."""
    return _sort_runs(keys, vals, run_log, tile_log, _ladder_kernels, torch.int32)


def sort_multi_i32(keys, vals, tile_log: int = TILE_LOG):
    """Stable ascending sort of int32 keys carrying 1-3 int32 planes.
    Returns (sorted keys, [sorted planes])."""
    return _sort(keys, vals, tile_log, _ladder_kernels, torch.int32)


def sort_multi_i64(keys, vals, tile_log: int = TILE_LOG):
    """`sort_multi_i32` for int64 keys."""
    return _sort(keys, vals, tile_log, _ladder_kernels, torch.int64)


# The JAX package's names for the unequal merge: one host call, no
# padding, whatever the lengths.
merge_sorted_multi_i32 = merge_two_multi_i32
merge_sorted_multi_i64 = merge_two_multi_i64


def sort_multi_runs_plain(keys, vals, run_log: int, tile_log: int = TILE_LOG):
    """`sort_multi_i32_runs` built from the plain versions, on any device."""
    return _sort_runs(keys, vals, run_log, tile_log, _ladder_plain)


def sort_multi_plain(keys, vals, tile_log: int = TILE_LOG):
    """`sort_multi_i32` / `sort_multi_i64` built from the plain versions,
    on any device: the
    yardstick a card run holds the kernels against."""
    return _sort(keys, vals, tile_log, _ladder_plain)


merge_sorted_multi_plain = merge_two_multi_plain
