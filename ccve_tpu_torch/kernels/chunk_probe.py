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
any size: no packing, no gate.
"""

from __future__ import annotations

import torch

from ccve_tpu_torch.kernels import _build


def _check(table_keys, keys, valid):
    _build.check_int(table_keys, "table_keys", torch.int64)
    _build.check_int(keys, "keys", torch.int64)
    if not isinstance(valid, torch.Tensor) or valid.dtype != torch.bool:
        raise TypeError(f"valid: expected a bool tensor, got {getattr(valid, 'dtype', type(valid))}")
    if valid.shape != keys.shape or not valid.is_contiguous():
        raise ValueError(f"valid: expected a contiguous {tuple(keys.shape)}, "
                         f"got {tuple(valid.shape)}")
    for name, t in (("keys", keys), ("valid", valid)):
        if t.device != table_keys.device:
            raise ValueError(f"{name} on {t.device}, table_keys on {table_keys.device}")


def chunk_rank_plain(table_keys, keys, valid):
    """`chunk_rank` in two `torch.searchsorted` calls, on any device."""
    _check(table_keys, keys, valid)
    start = torch.searchsorted(table_keys, keys, side="left")
    end = torch.searchsorted(table_keys, keys, side="right")
    mult = torch.where(valid, end - start, 0).to(torch.int32)
    return mult, start.to(torch.int32)


def chunk_rank(table_keys, keys, valid):
    """(mult, start) of each lane (see the module docstring): kernel
    csrc/chunk_rank.cu on a CUDA device, `chunk_rank_plain` on the CPU."""
    _check(table_keys, keys, valid)
    if keys.device.type == "cpu":
        return chunk_rank_plain(table_keys, keys, valid)
    n = keys.numel()
    mult = torch.empty(n, dtype=torch.int32, device=keys.device)
    start = torch.empty(n, dtype=torch.int32, device=keys.device)
    code = _build.load().ccve_chunk_rank_i64(
        table_keys.data_ptr(), table_keys.numel(), keys.data_ptr(), valid.data_ptr(), n,
        mult.data_ptr(), start.data_ptr(), _build.stream(keys),
    )
    _build.check(code, "chunk_rank")
    chunk_rank.launches += 1
    return mult, start


chunk_rank.launches = 0
