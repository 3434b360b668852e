"""Sorted runs of an int32 stream: a tile sort plus merge levels.

Counterpart of `ccve_tpu.kernels.bigsort._sort_padded_buf(...,
n_levels_cap=cap)`: the padded stream is sorted tile by tile
(`sort_tiles_i32`, kernel csrc/sort_tiles.cu), then merge levels double the
run length (`merge_level_i32`, kernel csrc/merge_level.cu) until runs reach
2^run_log or cover the stream. `sort_runs_i32` drives the two.

The port's tile is 2^TILE_LOG = 8192 values, one block's shared memory on
the card (the TPU's 2^17 tile was sized for VMEM). Every run is stored
ascending at every level, so the TPU's alternating orientation and
`force_asc` are gone; the runs returned are those of the JAX ladder
(ascending, 2^run_log values each, the last one possibly shorter).
"""

from __future__ import annotations

from typing import Callable

import torch

from ccve_tpu_torch.kernels import _build

TILE_LOG = 13
MAX_TILE_LOG = 13  # 2^13 int32 = 32 KB of shared memory per block
I32_MAX = 2**31 - 1


def sort_tiles_plain(x: torch.Tensor, tile_log: int) -> torch.Tensor:
    """`sort_tiles_i32` as a per-tile torch.sort, on any device."""
    return x.view(-1, 1 << tile_log).sort(dim=1).values.reshape(-1)


def merge_level_plain(x: torch.Tensor, run_log: int) -> torch.Tensor:
    """`merge_level_i32` as a torch.sort of each run pair, on any device."""
    n = x.numel()
    pair = 2 << run_log
    full = n - n % pair
    head = x[:full].view(-1, pair).sort(dim=1).values.reshape(-1)
    return torch.cat([head, x[full:].sort().values])


def sort_tiles_i32(x: torch.Tensor, tile_log: int = TILE_LOG) -> torch.Tensor:
    """Each 2^tile_log-value tile of int32[n] sorted ascending
    (n a multiple of the tile)."""
    _build.check_i32(x, "x")
    if not 1 <= tile_log <= MAX_TILE_LOG:
        raise ValueError(f"tile_log {tile_log} outside [1, {MAX_TILE_LOG}]")
    n = x.numel()
    if n % (1 << tile_log):
        raise ValueError(f"length {n} is not a multiple of 2^{tile_log}")
    if x.device.type == "cpu":
        return sort_tiles_plain(x, tile_log)
    y = torch.empty_like(x)
    if n:
        code = _build.load().ccve_sort_tiles_i32(
            x.data_ptr(), y.data_ptr(), n >> tile_log, tile_log,
            _build.stream(x),
        )
        _build.check(code, "sort_tiles_i32")
        sort_tiles_i32.launches += 1
    return y


sort_tiles_i32.launches = 0


def merge_level_i32(x: torch.Tensor, run_log: int) -> torch.Tensor:
    """One merge level over int32[n] made of ascending runs of 2^run_log
    (the last one may be short): each pair of neighbouring runs becomes one
    ascending run of 2^(run_log+1)."""
    _build.check_i32(x, "x")
    if not 0 <= run_log <= 30:
        raise ValueError(f"run_log {run_log} outside [0, 30]")
    if x.device.type == "cpu":
        return merge_level_plain(x, run_log)
    y = torch.empty_like(x)
    if x.numel():
        code = _build.load().ccve_merge_level_i32(
            x.data_ptr(), y.data_ptr(), x.numel(), run_log, _build.stream(x)
        )
        _build.check(code, "merge_level_i32")
        merge_level_i32.launches += 1
    return y


merge_level_i32.launches = 0


def _ladder(x, run_log, tile_log, sort_tiles: Callable, merge_level: Callable):
    if run_log < tile_log:
        raise ValueError(f"run_log {run_log} below tile_log {tile_log}")
    n_tiles = x.numel() >> tile_log
    # merge levels needed for one run: ceil(log2(n_tiles)), capped
    n_levels = min(max(n_tiles - 1, 0).bit_length(), run_log - tile_log)
    y = sort_tiles(x, tile_log)
    for level in range(n_levels):
        y = merge_level(y, tile_log + level)
    return y


def sort_runs_i32(
    x: torch.Tensor, run_log: int, tile_log: int = TILE_LOG
) -> torch.Tensor:
    """int32[n_pad] (n_pad a multiple of 2^tile_log) as independently
    sorted ascending runs of 2^run_log values: a tile sort, then
    run_log - tile_log merge levels at most (fewer when one run already
    covers the stream)."""
    return _ladder(x, run_log, tile_log, sort_tiles_i32, merge_level_i32)


def sort_runs_plain(
    x: torch.Tensor, run_log: int, tile_log: int = TILE_LOG
) -> torch.Tensor:
    """`sort_runs_i32` built from the plain versions, on any device: the
    yardstick a card run holds the kernels against."""
    _build.check_i32(x, "x")
    if x.numel() % (1 << tile_log):
        raise ValueError(f"length {x.numel()} is not a multiple of 2^{tile_log}")
    return _ladder(x, run_log, tile_log, sort_tiles_plain, merge_level_plain)
