"""Multi-plane sort and merge: int32 keys carrying 1-3 int32 cargo planes.

Counterpart of `ccve_tpu.kernels.pairsort` (`pallas_sort_multi_i32`,
`pallas_sort_multi_i32_runs`, `merge_sorted_multi_i32`). Two kernels:

 - `sort_tiles_multi_i32` (csrc/sort_tiles_multi.cu) sorts each
   2^tile_log-key tile and moves the planes with their keys;
 - `merge_level_multi_i32` and `merge_two_multi_i32` (csrc/merge_multi.cu)
   are one ladder level and the unequal merge of two sorted streams.

The entry points `sort_multi_i32`, `sort_multi_i32_runs` and
`merge_sorted_multi_i32` compose them. Every step is stable (ties keep
their input order, A before B in a merge), where the TPU's sort is not, so
a kernel and its plain version (a stable torch.sort plus a gather) agree
exactly, and a sort's cargo order is determined. Against the JAX package
only the key plane is exact; (key, cargo...) tuples agree as multisets.

Every n goes through the kernels: the JAX entry points' `n <= tile`
`lax.sort` branches were a TPU tile-size workaround. Keys may take any
int32 value: padding (INT32_MAX keys, zero cargo) is appended after the
real elements and a stable sort keeps it behind them.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ccve_tpu_torch.kernels import _build

TILE_LOG = 13
MAX_TILE_LOG = 13  # 2^13 (key, index) words = 64 KB of shared memory
MAX_PLANES = 3
I32_MAX = 2**31 - 1


def _check_planes(keys: torch.Tensor, vals: Sequence[torch.Tensor], name: str):
    _build.check_i32(keys, f"{name} keys")
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


def sort_tiles_multi_i32(keys, vals, tile_log: int = TILE_LOG):
    """Each 2^tile_log-key tile of int32[n] sorted ascending, stably, with
    its cargo planes (n a multiple of the tile). Returns (keys, planes)."""
    vals = _check_planes(keys, vals, "sort_tiles_multi_i32")
    if not 1 <= tile_log <= MAX_TILE_LOG:
        raise ValueError(f"tile_log {tile_log} outside [1, {MAX_TILE_LOG}]")
    n = keys.numel()
    if n % (1 << tile_log):
        raise ValueError(f"length {n} is not a multiple of 2^{tile_log}")
    if keys.device.type == "cpu":
        return sort_tiles_multi_plain(keys, vals, tile_log)
    out_keys = torch.empty_like(keys)
    out_vals = [torch.empty_like(v) for v in vals]
    if n:
        code = _build.load().ccve_sort_tiles_multi_i32(
            keys.data_ptr(), *_ptrs(vals), out_keys.data_ptr(), *_ptrs(out_vals),
            len(vals), n >> tile_log, tile_log, _build.stream(keys),
        )
        _build.check(code, "sort_tiles_multi_i32")
        sort_tiles_multi_i32.launches += 1
    return out_keys, out_vals


sort_tiles_multi_i32.launches = 0


def merge_level_multi_i32(keys, vals, run_log: int):
    """One stable merge level over int32[n] keys made of ascending runs of
    2^run_log (the last may be short), with their cargo planes: each pair
    of neighbouring runs becomes one run of 2^(run_log+1)."""
    vals = _check_planes(keys, vals, "merge_level_multi_i32")
    if not 0 <= run_log <= 30:
        raise ValueError(f"run_log {run_log} outside [0, 30]")
    if keys.device.type == "cpu":
        return merge_level_multi_plain(keys, vals, run_log)
    out_keys = torch.empty_like(keys)
    out_vals = [torch.empty_like(v) for v in vals]
    if keys.numel():
        code = _build.load().ccve_merge_level_multi_i32(
            keys.data_ptr(), *_ptrs(vals), out_keys.data_ptr(), *_ptrs(out_vals),
            len(vals), keys.numel(), run_log, _build.stream(keys),
        )
        _build.check(code, "merge_level_multi_i32")
        merge_level_multi_i32.launches += 1
    return out_keys, out_vals


merge_level_multi_i32.launches = 0


def merge_two_multi_i32(ak, avs, bk, bvs):
    """The stable merge of two ascending int32 key streams with their cargo
    planes (ties: A's elements first; either stream may be empty).
    Returns (keys, planes) of length |A| + |B|."""
    avs = _check_planes(ak, avs, "merge_two_multi_i32 A")
    bvs = _check_planes(bk, bvs, "merge_two_multi_i32 B")
    if len(avs) != len(bvs) or ak.device != bk.device:
        raise ValueError(
            f"merge_two_multi_i32: A has {len(avs)} planes on {ak.device}, "
            f"B {len(bvs)} on {bk.device}"
        )
    n = ak.numel() + bk.numel()
    if n >= 2**31:
        raise ValueError(f"merge_two_multi_i32: {n} elements, the kernels take < 2^31")
    if ak.device.type == "cpu":
        return merge_two_multi_plain(ak, avs, bk, bvs)
    out_keys = ak.new_empty(n)
    out_vals = [ak.new_empty(n) for _ in avs]
    if n:
        code = _build.load().ccve_merge_two_multi_i32(
            ak.data_ptr(), *_ptrs(avs), ak.numel(),
            bk.data_ptr(), *_ptrs(bvs), bk.numel(),
            out_keys.data_ptr(), *_ptrs(out_vals), len(avs), _build.stream(ak),
        )
        _build.check(code, "merge_two_multi_i32")
        merge_two_multi_i32.launches += 1
    return out_keys, out_vals


merge_two_multi_i32.launches = 0


def pad_to_tile(keys, vals, tile_log: int):
    """(keys, planes) padded to a multiple of the 2^tile_log tile: keys with
    INT32_MAX, planes with 0 (the tile sort's input)."""
    pad = (-keys.numel()) % (1 << tile_log)
    if not pad:
        return keys, list(vals)
    return (
        torch.cat([keys, keys.new_full((pad,), I32_MAX)]),
        [torch.cat([v, v.new_zeros(pad)]) for v in vals],
    )


def _ladder(keys, vals, run_log, tile_log, sort_tiles: Callable, merge_level: Callable):
    if run_log < tile_log:
        raise ValueError(f"run_log {run_log} below tile_log {tile_log}")
    n_tiles = keys.numel() >> tile_log
    n_levels = min(max(n_tiles - 1, 0).bit_length(), run_log - tile_log)
    keys, vals = sort_tiles(keys, vals, tile_log)
    for level in range(n_levels):
        keys, vals = merge_level(keys, vals, tile_log + level)
    return keys, vals


def _sort_runs(keys, vals, run_log, tile_log, sort_tiles, merge_level):
    keys, vals = pad_to_tile(keys, _check_planes(keys, vals, "sort"), tile_log)
    return _ladder(keys, vals, run_log, tile_log, sort_tiles, merge_level)


def _sort(keys, vals, tile_log, sort_tiles, merge_level):
    n = keys.numel()
    n_tiles = -(-n >> tile_log)
    run_log = tile_log + max(n_tiles - 1, 0).bit_length()
    keys, vals = _sort_runs(keys, vals, run_log, tile_log, sort_tiles, merge_level)
    return keys[:n], [v[:n] for v in vals]


def sort_multi_i32_runs(keys, vals, run_log: int, tile_log: int = TILE_LOG):
    """(keys, planes) padded to a multiple of the tile (INT32_MAX keys, zero
    cargo) and sorted stably into ascending runs of 2^run_log (the last may
    be shorter): a tile sort, then at most run_log - tile_log merge
    levels."""
    return _sort_runs(
        keys, vals, run_log, tile_log, sort_tiles_multi_i32, merge_level_multi_i32
    )


def sort_multi_i32(keys, vals, tile_log: int = TILE_LOG):
    """Stable ascending sort of int32 keys carrying 1-3 int32 planes.
    Returns (sorted keys, [sorted planes])."""
    return _sort(keys, vals, tile_log, sort_tiles_multi_i32, merge_level_multi_i32)


# The JAX package's name for the unequal merge: one kernel launch, no
# padding, whatever the lengths.
merge_sorted_multi_i32 = merge_two_multi_i32


def sort_multi_runs_plain(keys, vals, run_log: int, tile_log: int = TILE_LOG):
    """`sort_multi_i32_runs` built from the plain versions, on any device."""
    return _sort_runs(
        keys, vals, run_log, tile_log, sort_tiles_multi_plain, merge_level_multi_plain
    )


def sort_multi_plain(keys, vals, tile_log: int = TILE_LOG):
    """`sort_multi_i32` built from the plain versions, on any device: the
    yardstick a card run holds the kernels against."""
    return _sort(keys, vals, tile_log, sort_tiles_multi_plain, merge_level_multi_plain)


merge_sorted_multi_plain = merge_two_multi_plain
