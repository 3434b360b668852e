"""Chunk compaction: merging under-filled chunks into full ones.

Port of `ccve_tpu.ops.compactor` (the reference's `NaiveCompactor`,
compactor.h:14-29, compactor.cpp:5-41, with the threshold axis of
setting.h:17-29):

    emitted, new_state = compact(state, chunk, threshold)

 - count >= threshold, or a full chunk: pass through unchanged (FULL uses
   threshold == block, BINARY block // 2, NONE 0);
 - else append into the cache; if it fits, emit an empty chunk; when the
   cache fills, emit it and keep the overflow as the new cache;
 - flush(state) hands back the partial cache at the end of the stream.

Functional, as the JAX module is: no tensor of `state` or `chunk` is
written. On pass-through the emitted chunk is the input chunk itself, and
on a swallowed chunk the old cache's storage; an emitted cache is a new
tensor, so a later `compact` cannot overwrite a chunk already emitted.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ccve_tpu_torch.core.chunk import Chunk, append_into, make_dense
from ccve_tpu_torch.device import require_device


class CompactorState(NamedTuple):
    """The cached chunk (always dense: identity sel) and its row count."""

    cache_cols: torch.Tensor  # int64[n_cols, block]
    cache_count: int

    @property
    def block_size(self) -> int:
        return self.cache_cols.shape[1]


def init_state(n_cols: int, block_size: int, device="cuda") -> CompactorState:
    device = require_device(device)
    return CompactorState(
        cache_cols=torch.zeros((n_cols, block_size), dtype=torch.int64, device=device),
        cache_count=0,
    )


def compact(
    state: CompactorState, chunk: Chunk, threshold, chunk_dense: bool = False,
) -> tuple[Chunk, CompactorState]:
    """One Compact step. Chunks with count >= threshold pass through;
    smaller ones are absorbed into the cache, which is emitted whenever it
    fills. `chunk_dense` says the input's sel is the identity (the sorted
    executor's form), so the absorb reads its columns as they lie.

    Returns (emitted_chunk, new_state): the input chunk on pass-through, a
    dense full cache when the cache fills (exactly or with overflow), or an
    empty chunk when the input was swallowed."""
    block = chunk.block_size
    # full chunks always pass (compactor.cpp:6), whatever the threshold
    if chunk.count >= int(threshold) or chunk.count >= block:
        return chunk, state
    new_cache, new_count, overflow, over_count = append_into(
        state.cache_cols, state.cache_count, chunk, src_dense=chunk_dense
    )
    if new_count >= block:
        # the cache filled (exactly or split): emit it at once (the same
        # multiset as the reference, which pushes it out on the next call)
        return make_dense(new_cache, block), CompactorState(overflow, over_count)
    return make_dense(state.cache_cols, 0), CompactorState(new_cache, new_count)


def flush(state: CompactorState) -> tuple[Chunk, CompactorState]:
    """End of stream: emit the partial cache (compactor.h:23) and reset."""
    emitted = make_dense(state.cache_cols, state.cache_count)
    return emitted, CompactorState(torch.zeros_like(state.cache_cols), 0)
