"""Filter operator: a selection-vector producer.

Port of `ccve_tpu.ops.filter`. A filter evaluates a predicate over a
chunk's live rows and composes the selection vector down to the passing
rows, moving no data (the reference's Slice, base.cpp:37-47). Its
under-filled output is what the compactor exists to fix. The predicates
are functions of one int64 tensor; `SortedPipeline`'s `prefilter` takes
them.
"""

from __future__ import annotations

from typing import Callable

import torch

from ccve_tpu_torch.core.chunk import Chunk, compress_indices, slice_compose


def filter_chunk(chunk: Chunk, predicate: Callable[[torch.Tensor], torch.Tensor],
                 col: int) -> Chunk:
    """Keep the live rows where `predicate(cols[col][row])` holds; returns
    a chunk sharing the storage with a composed selection vector."""
    gathered = chunk.cols[col][chunk.sel.to(torch.int64)]  # live rows in sel order
    live = torch.arange(chunk.block_size, device=chunk.cols.device) < chunk.count
    result_vector, count = compress_indices(live & predicate(gathered))
    return slice_compose(chunk, result_vector, count)


def filter_mask(values: torch.Tensor,
                predicate: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Bulk-executor form: a boolean mask over a whole column."""
    return predicate(values)


# Common predicates (int64 columns)
def lt(c):
    return lambda x: x < c


def le(c):
    return lambda x: x <= c


def gt(c):
    return lambda x: x > c


def ge(c):
    return lambda x: x >= c


def eq(c):
    return lambda x: x == c


def between(lo, hi):
    """lo <= x < hi"""
    return lambda x: (x >= lo) & (x < hi)


def mod_eq(m, r):
    """x % m == r (Python's sign rule, as jnp's): deterministic
    selectivity for benchmarks."""
    return lambda x: x % m == r
