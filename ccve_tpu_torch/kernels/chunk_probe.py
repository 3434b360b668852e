"""Per-chunk ranks of the sorted-chunk executor's chunk rank mode.

Counterpart of `ccve_tpu.kernels.chunk_probe`: `chunk_rank` (kernel
csrc/chunk_rank.cu, #11) gives, for each probe lane of one chunk, its
match count against a sorted table and its first matching row:

    table_keys int64[m]  ascending      keys  int64[block]
    valid      bool[block]              ->    (mult int32[block], start int32[block])

mult = upper bound - lower bound where `valid`, else 0; start = the lower
bound, an index into the sorted table (the executor reads it only where
mult > 0). `chunk_rank_plain` is the same in two `torch.searchsorted` calls
(the JAX package's `chunk_rank_xla`).

The JAX kernel takes int32 packed operands (key' << 1 | 1, clamped, with
I32_MAX sentinels on invalid lanes) and a VMEM-staged table, so its
executor gates each level on key bits and table size and falls back per
level. The CUDA kernel takes the int64 keys and the table as they are, of
any size: no packing, no gate. Each of its blocks stages a sampled index of
the table in shared memory (every 2^`index_stride_log(m)`-th key, at most
INDEX_MAX keys) and searches only one leaf of the table in device memory.
"""

from __future__ import annotations

import torch

from ccve_tpu_torch.kernels import _build

INDEX_MAX = 4096  # index keys a block of csrc/chunk_rank.cu stages (32 KB)
MIN_STRIDE_LOG = 6  # the index samples at least every 64th row


def index_stride_log(m: int) -> int:
    """log2 of the kernel's index stride for a table of m rows: the
    smallest value >= MIN_STRIDE_LOG at which ceil(m / 2^value) index keys
    fit in INDEX_MAX, so that the index covers the table."""
    return max(MIN_STRIDE_LOG, (-(-m // INDEX_MAX) - 1).bit_length())


def _check(table_keys, keys, valid):
    _build.check_int(table_keys, "table_keys", torch.int64)
    _build.check_int(keys, "keys", torch.int64)
    if not isinstance(valid, torch.Tensor) or valid.dtype != torch.bool:
        raise TypeError(f"valid: expected a bool tensor, got {getattr(valid, 'dtype', type(valid))}")
    if valid.shape != keys.shape or not valid.is_contiguous():
        raise ValueError(f"valid: expected a contiguous {tuple(keys.shape)}, "
                         f"got {tuple(valid.shape)}")
    index = table_keys.get_device()
    if keys.get_device() != index or valid.get_device() != index:
        raise ValueError(f"table_keys on {table_keys.device}, keys on {keys.device}, "
                         f"valid on {valid.device}")


def chunk_rank_plain(table_keys, keys, valid):
    """`chunk_rank` in two `torch.searchsorted` calls, on any device."""
    _check(table_keys, keys, valid)
    start = torch.searchsorted(table_keys, keys, side="left")
    end = torch.searchsorted(table_keys, keys, side="right")
    mult = torch.where(valid, end - start, 0).to(torch.int32)
    return mult, start.to(torch.int32)


def chunk_rank(table_keys, keys, valid):
    """(mult, start) of each lane (see the module docstring): kernel
    csrc/chunk_rank.cu on a CUDA device, `chunk_rank_plain` on the CPU. On
    the card both are rows of one int32[2, n] allocation."""
    _check(table_keys, keys, valid)
    if keys.is_cpu:
        return chunk_rank_plain(table_keys, keys, valid)
    n, m = keys.numel(), table_keys.numel()
    out = keys.new_empty((2, n), dtype=torch.int32)
    code = _build.load().ccve_chunk_rank_i64(
        table_keys.data_ptr(), m, index_stride_log(m), keys.data_ptr(), valid.data_ptr(), n,
        out.data_ptr(), _build.stream(keys),
    )
    _build.check(code, "chunk_rank")
    chunk_rank.launches += 1
    return out.unbind(0)


chunk_rank.launches = 0
