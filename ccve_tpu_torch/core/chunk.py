"""Columnar chunk with a selection vector: the engine's data model.

Port of `ccve_tpu.core.chunk` (the reference's `Vector`/`DataChunk`,
base.h:59-100). A chunk is

    cols : int64[n_cols, block]   column storage
    sel  : int32[block]           selection vector: sel[i] is the storage row
                                  of the i-th live tuple (identity on reset)
    count: int                    number of live tuples

The count is a host int: the executors that use chunks (the torch drain of
`exec.sorted_pipeline`) branch on it in Python, where JAX branches on a
traced scalar. The JAX module moves rows with one-hot MXU matmuls
(`ops/mxu_move.py`); here torch indexing does it. A JAX scatter with
`mode="drop"` to row `block` becomes a scatter into one sink column past
the end, cut off afterwards; where both offsets are host ints the move is a
slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ccve_tpu_torch.device import require_device

SEL_DTYPE = torch.int32
COL_DTYPE = torch.int64


class Chunk(NamedTuple):
    cols: torch.Tensor  # int64[n_cols, block]
    sel: torch.Tensor  # int32[block]
    count: int

    @property
    def n_cols(self) -> int:
        return self.cols.shape[0]

    @property
    def block_size(self) -> int:
        return self.cols.shape[1]


def iota_sel(block_size: int, device="cuda") -> torch.Tensor:
    """The identity selection vector on `device` (default the GPU; raises
    without one)."""
    return _iota(block_size, require_device(device))


def _iota(block_size: int, device: torch.device) -> torch.Tensor:
    # the chunk functions' own identity: the device is a tensor's, so
    # nothing is checked per chunk
    return torch.arange(block_size, dtype=SEL_DTYPE, device=device)


def make_dense(cols: torch.Tensor, count=None) -> Chunk:
    """Chunk whose selection vector is the identity (a freshly Reset chunk,
    base.h:96-99)."""
    block = cols.shape[1]
    return Chunk(
        cols=cols.to(COL_DTYPE),
        sel=_iota(block, cols.device),
        count=block if count is None else int(count),
    )


def empty(n_cols: int, block_size: int, device="cuda") -> Chunk:
    device = require_device(device)
    return Chunk(
        cols=torch.zeros((n_cols, block_size), dtype=COL_DTYPE, device=device),
        sel=_iota(block_size, device),
        count=0,
    )


def reset(chunk: Chunk) -> Chunk:
    """DataChunk::Reset (base.h:96-99): identity sel, zero count. Storage is
    left as it is, as in the reference."""
    return Chunk(chunk.cols, _iota(chunk.block_size, chunk.cols.device), 0)


def valid_mask(chunk: Chunk) -> torch.Tensor:
    """bool[block]: True for live positions i < count."""
    return _iota(chunk.block_size, chunk.cols.device) < chunk.count


def slice_compose(parent: Chunk, result_vector: torch.Tensor, result_count) -> Chunk:
    """DataChunk::Slice (base.cpp:37-47): share the parent's column storage,
    compose selection vectors: sel'[i] = parent.sel[result_vector[i]].
    Positions >= result_count are garbage, as in the reference, and read
    position 0."""
    live = _iota(parent.block_size, parent.cols.device) < int(result_count)
    idx = torch.where(live, result_vector.to(torch.int64), 0)
    return Chunk(parent.cols, parent.sel[idx], int(result_count))


def gather_rows(chunk: Chunk) -> torch.Tensor:
    """Live rows densely: out[:, i] = cols[:, sel[i]] for i < count, zero
    above. Returns int64[n_cols, block]."""
    live = valid_mask(chunk)
    dense = chunk.cols[:, torch.where(live, chunk.sel.to(torch.int64), 0)]
    return torch.where(live[None, :], dense, 0)


def _ranks(mask: torch.Tensor):
    """(scatter positions, count): the rank of each set lane, and n (the
    sink) for the others."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    return torch.where(mask, pos, n), int(mask.sum())


def compact_rows(cols: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Stream compaction to a dense layout: out[:, rank(j)] = cols[:, j]
    for mask[j]. Returns (dense_cols, count); storage beyond count is
    zero."""
    n = mask.shape[0]
    at, count = _ranks(mask)
    out = cols.new_zeros((cols.shape[0], n + 1))
    out[:, at] = cols
    return out[:, :n], count


def append_into(
    dst_cols: torch.Tensor, dst_count: int, src: Chunk, limit=None,
    src_dense: bool = False,
):
    """DataChunk::Append with the compactor's overflow split (base.cpp:15-27,
    compactor.cpp:22-24): the first min(src.count, limit) live rows of
    `src` (read through its selection vector, or as they lie when
    `src_dense`) go into `dst_cols` from row dst_count on; rows past the
    block wrap into a fresh zeroed overflow buffer from row 0.

    Returns (new_dst_cols, new_dst_count, overflow_cols, overflow_count),
    new_dst_count capped at block. New tensors: neither `dst_cols` nor
    `src` is written. Storage of `new_dst_cols` past its count is
    `dst_cols`' own."""
    block = src.block_size
    dst_count = int(dst_count)
    n = src.count if limit is None else min(src.count, int(limit))
    dense = src.cols if src_dense else gather_rows(src)
    take = max(min(n, block - dst_count), 0)
    new_dst = dst_cols.clone()
    new_dst[:, dst_count : dst_count + take] = dense[:, :take]
    overflow = torch.zeros_like(dst_cols)
    overflow[:, : n - take] = dense[:, take:n]
    total = dst_count + n
    return new_dst, min(total, block), overflow, max(total - block, 0)


def compress_indices(mask: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Stream compaction of a boolean mask (the reference's
    `_mm256_mask_compressstoreu_epi32`, chaining_ht.cpp:248): result[j] is
    the j-th set index of `mask` for j < count, 0 above."""
    n = mask.shape[0]
    at, count = _ranks(mask)
    result = torch.zeros(n + 1, dtype=SEL_DTYPE, device=mask.device)
    result[at] = torch.arange(n, dtype=SEL_DTYPE, device=mask.device)
    return result[:n], count


# ---------------------------------------------------------------------------
# Host-side helpers (tests / result collection)
# ---------------------------------------------------------------------------


def to_rows(chunk: Chunk) -> np.ndarray:
    """Live tuples as an int64[count, n_cols] NumPy array, read through the
    selection vector: the observable content of a chunk."""
    cols = chunk.cols.cpu().numpy()
    sel = chunk.sel.cpu().numpy()
    return cols[:, sel[: chunk.count]].T.copy()


def from_rows(rows: np.ndarray, block_size: int, device="cuda") -> Chunk:
    """A dense chunk from int64[count, n_cols] host rows (count <=
    block_size); storage above count is zero."""
    rows = np.asarray(rows, dtype=np.int64)
    count, n_cols = rows.shape
    if count > block_size:
        raise ValueError(f"{count} rows > block_size {block_size}")
    cols = np.zeros((n_cols, block_size), dtype=np.int64)
    cols[:, :count] = rows.T
    return make_dense(torch.from_numpy(cols).to(require_device(device)), count)
