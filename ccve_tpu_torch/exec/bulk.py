"""Bulk operator-at-a-time executor: the single-device throughput path.

Port of `ccve_tpu.exec.bulk` for `SortedTable`s. The N-way join
factorizes: level l probes original probe column l, so a probe row that
matches m_l build rows at level l emits Π_l m_l output rows, and

    total rows  = Σ_i Π_l mult(i, l)
    Σ payload_l = Σ_i psum(i, l) · Π_{k≠l} mult(i, k)

with one `match_stats` sweep per level and no fan-out materialized. A
single level takes the count-side engine (`sorted_match_totals`), whose
totals need no per-probe order. `bulk_materialize` expands level by level
through `sorted_expand`. Tables of int64 keys (a key span above 2^30)
take the int64 builds of the same kernels on both sides.

Not ported yet: the hash tables (LP, CSR) and their match stats (ROADMAP
Queue 1, slice 5), and a single-level count over a table whose key span
reaches 2^62 (slice 3b); they raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.ops.sort_merge import (
    MatchStats,
    SortedTable,
    sorted_expand,
    sorted_match_stats,
    sorted_match_totals,
)

@dataclasses.dataclass(frozen=True)
class BulkResult:
    count: torch.Tensor  # int64 scalar: output rows of the join
    payload_checksums: torch.Tensor  # int64[n_levels]: Σ of each level's
    #                                  matched-payload column over output rows


def _require_sorted(table, what: str) -> None:
    if not isinstance(table, SortedTable):
        raise NotImplementedError(
            f"{what} over a {type(table).__name__}: hash tables (LP, CSR) "
            "are ROADMAP Queue 1, slice 5, not ported yet"
        )


def match_stats(table, keys) -> MatchStats:
    """Per-probe (mult, psum) of one level; a narrow probe column stays
    narrow (the stats pack takes int32 without widening)."""
    _require_sorted(table, "match_stats")
    return sorted_match_stats(table, keys)


def combine_levels(stats: Sequence[MatchStats]) -> BulkResult:
    """The factorized count and per-level checksums from each level's
    per-probe stats (all in int64)."""
    mults = [s.mult.to(torch.int64) for s in stats]
    prod = mults[0]
    for m in mults[1:]:
        prod = prod * m
    checksums = [
        # Π_{k≠l} mult: rows with mult_l == 0 emit nothing, so the guarded
        # division is exact
        (s.psum * torch.where(m > 0, prod // m.clamp(min=1), 0)).sum()
        for s, m in zip(stats, mults)
    ]
    return BulkResult(count=prod.sum(), payload_checksums=torch.stack(checksums))


def _bulk_count(tables: tuple, cols: list) -> BulkResult:
    if len(tables) == 1:
        count, checksum = sorted_match_totals(tables[0], cols[0])
        return BulkResult(count=count, payload_checksums=checksum.reshape(1))
    return combine_levels([match_stats(t, c) for t, c in zip(tables, cols)])


def bulk_count(
    tables: Sequence[SortedTable],
    probe_rows: np.ndarray | torch.Tensor,
    tile_rows: int | None = None,
) -> BulkResult:
    """Count (and payload-checksum) the N-way join of `probe_rows` (int[n,
    n_joins], int32 or int64, numpy or torch) against `tables`, without
    materializing output; optionally in `tile_rows`-row slices to bound
    memory. The probe columns move to the first table's device; an int32
    table stays int32."""
    tables = tuple(tables)
    if not tables:
        raise ValueError("bulk_count needs at least one table")
    for table in tables:
        _require_sorted(table, "bulk_count")
    probe = torch.as_tensor(probe_rows)
    if probe.dim() != 2 or probe.shape[1] != len(tables):
        raise ValueError(
            f"probe_rows must be [n, {len(tables)}], got {tuple(probe.shape)}"
        )
    if probe.dtype != torch.int32:
        probe = probe.to(torch.int64)
    probe = probe.to(tables[0].device)
    cols = [probe[:, level].contiguous() for level in range(len(tables))]
    n = probe.shape[0]
    if tile_rows is None or tile_rows >= n:
        return _bulk_count(tables, cols)
    if tile_rows < 1:
        raise ValueError(f"tile_rows {tile_rows} < 1")
    count, checksums = 0, 0
    for start in range(0, n, tile_rows):
        r = _bulk_count(tables, [c[start : start + tile_rows] for c in cols])
        count = count + r.count
        checksums = checksums + r.payload_checksums
    return BulkResult(count=count, payload_checksums=checksums)


def _expand_sorted(table: SortedTable, keys: torch.Tensor):
    """(rows, keys, payloads, n_keep) of every match of `keys` at one
    level. Capacity is the worst case n * max_mult, so nothing is cut."""
    cap = keys.numel() * max(int(table.max_mult), 1)
    rows, ck, cp, total = sorted_expand(table, keys, cap)
    return rows, ck, cp, int(total)


def bulk_materialize(
    tables: Sequence[SortedTable],
    probe_rows: np.ndarray | torch.Tensor,
    payload_mode,
) -> torch.Tensor:
    """The full N-way join output, int64[rows, 3 * n_joins] on the first
    table's device: the probe row, then two columns per level, (0, key) in
    REFERENCE mode or (key, payload) in FULL mode, as
    exec/oracle.oracle_pipeline has them; row order is not part of the
    contract. `payload_mode` is a PayloadMode or its value."""
    mode = PayloadMode(getattr(payload_mode, "value", payload_mode))
    tables = tuple(tables)
    for table in tables:
        _require_sorted(table, "bulk_materialize")
    probe = torch.as_tensor(probe_rows).to(torch.int64).to(tables[0].device)
    n, n_joins = probe.shape
    if n_joins != len(tables):
        raise ValueError(f"probe_rows has {n_joins} columns for {len(tables)} tables")
    src = torch.arange(n, device=probe.device)
    appended = torch.zeros((0, n), dtype=torch.int64, device=probe.device)
    for level, table in enumerate(tables):
        rows, ck, cp, n_keep = _expand_sorted(table, probe[src, level])
        row_of = rows[:n_keep].to(torch.int64)
        ck, cp = ck[:n_keep], cp[:n_keep]
        src = src[row_of]
        appended = appended[:, row_of]
        if mode is PayloadMode.REFERENCE:
            new_cols = torch.stack([torch.zeros_like(ck), ck])
        else:
            new_cols = torch.stack([ck, cp])
        appended = torch.cat([appended, new_cols])
    return torch.cat([probe[src], appended.T], dim=1)
