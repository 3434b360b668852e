"""Bulk operator-at-a-time executor: the single-device throughput path.

Port of `ccve_tpu.exec.bulk.bulk_count` for one join level over a
`SortedTable`: the whole probe column goes through the count-side engine
(`ops.sort_merge.sorted_match_totals`) at once, or in `tile_rows`-row
slices to bound memory. Not ported yet: N-level joins, which factorize
over per-probe stats (ROADMAP Queue 1, slice 2), and the hash tables
(LP, CSR; slice 5).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ccve_tpu_torch.ops.sort_merge import SortedTable, sorted_match_totals


@dataclasses.dataclass(frozen=True)
class BulkResult:
    count: torch.Tensor  # int64 scalar: output rows of the join
    payload_checksums: torch.Tensor  # int64[n_levels]: Σ of each level's
    #                                  matched-payload column over output rows


def bulk_count(
    tables: Sequence[SortedTable],
    probe_rows: np.ndarray | torch.Tensor,
    tile_rows: int | None = None,
) -> BulkResult:
    """Count (and payload-checksum) the join of `probe_rows` (int[n,
    n_joins], int32 or int64, numpy or torch) against `tables`, without
    materializing output. The probe column moves to the table's device; an
    int32 column stays int32 and skips the int64 pack."""
    tables = tuple(tables)
    if len(tables) != 1:
        raise NotImplementedError(
            f"bulk_count over {len(tables)} join levels: N-level joins are "
            "ROADMAP Queue 1, slice 2, not ported yet"
        )
    (table,) = tables
    if not isinstance(table, SortedTable):
        raise NotImplementedError(
            f"bulk_count over a {type(table).__name__}: hash tables (LP, CSR) "
            "are ROADMAP Queue 1, slices 2 and 5, not ported yet"
        )
    probe = torch.as_tensor(probe_rows)
    if probe.dim() != 2 or probe.shape[1] != 1:
        raise ValueError(f"probe_rows must be [n, 1], got {tuple(probe.shape)}")
    if probe.dtype != torch.int32:
        probe = probe.to(torch.int64)
    col = probe[:, 0].to(table.device).contiguous()
    n = col.numel()
    if tile_rows is None or tile_rows >= n:
        count, checksum = sorted_match_totals(table, col)
    else:
        if tile_rows < 1:
            raise ValueError(f"tile_rows {tile_rows} < 1")
        count = checksum = 0
        for start in range(0, n, tile_rows):
            c, s = sorted_match_totals(table, col[start : start + tile_rows])
            count = count + c
            checksum = checksum + s
    return BulkResult(count=count, payload_checksums=checksum.reshape(1))
