"""Bulk operator-at-a-time executor: the single-device throughput path.

Port of `ccve_tpu.exec.bulk` for sorted tables and for the LP and CSR hash
tables, mixed across levels as the JAX package allows. The N-way join
factorizes: level l probes original probe column l, so a probe row that
matches m_l build rows at level l emits Π_l m_l output rows, and

    total rows  = Σ_i Π_l mult(i, l)
    Σ payload_l = Σ_i psum(i, l) · Π_{k≠l} mult(i, k)

with one `match_stats` sweep per level and no fan-out materialized. A
single level over a sorted table takes the count-side engine
(`sorted_match_totals`), whose totals need no per-probe order; a hash
table takes `match_stats` at one level too. `bulk_materialize` expands
level by level through `sorted_expand` or a hash table's candidate grid.
Tables of int64 keys (a key span above 2^30) take the int64 builds of the
sort-merge kernels on both sides.

The hash drains loop to bounds known at build time (an LP chain meets an
empty slot within `max_run` slots, a CSR bucket holds at most `max_len`
entries), so no step reads a flag back to the host; the LP ladder reads
one overflow flag a call, which keeps its answer exact.

Not ported yet: a single-level count over a sorted table whose key span
reaches 2^62 (ROADMAP Queue 1, slice 3b); it raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.kernels.compact import compact_i32, compact_plain
from ccve_tpu_torch.kernels.murmur import murmurhash64_i64, murmurhash64_plain
from ccve_tpu_torch.ops.hash_table import (
    EMPTY,
    CSRTable,
    LPTable,
    csr_expand_grid,
    lp_expand_grid,
)
from ccve_tpu_torch.ops.sort_merge import (
    MatchStats,
    SortedTable,
    sorted_expand,
    sorted_match_stats,
    sorted_match_totals,
)

TABLE_TYPES = (SortedTable, LPTable, CSRTable)


@dataclasses.dataclass(frozen=True)
class BulkResult:
    count: torch.Tensor  # int64 scalar: output rows of the join
    payload_checksums: torch.Tensor  # int64[n_levels]: Σ of each level's
    #                                  matched-payload column over output rows


class HashRoute(NamedTuple):
    """The hash drains' kernel steps (`HASH_KERNELS`), or their plain
    versions (`HASH_PLAIN`), which a card run times as the yardstick."""

    hash: Callable  # int64[n] -> int64[n] (kernel #12)
    compact: Callable  # (planes, mask) -> (planes, count) (kernel #9)


HASH_KERNELS = HashRoute(murmurhash64_i64, compact_i32)
HASH_PLAIN = HashRoute(murmurhash64_plain, compact_plain)


def _lp_step(table: LPTable, keys, cursor, live):
    """One probe step of every lane: (hit, its payload or 0, still live,
    next slot). A lane stays live while its slots are occupied."""
    cand = table.slot_keys[cursor]
    occupied = live & (cand != EMPTY)
    hit = occupied & (cand == keys)
    pay = torch.where(hit, table.slot_payloads[cursor], 0)
    return hit, pay, occupied, (cursor + 1) & (table.n_slots - 1)


def _lp_drain(table: LPTable, keys, cursor, live, steps: int):
    """(mult int32, psum int64) of `steps` probe steps from `cursor`."""
    mult = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    psum = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    for _ in range(steps):
        hit, pay, live, cursor = _lp_step(table, keys, cursor, live)
        mult += hit.to(torch.int32)
        psum += pay
    return mult, psum


def lp_match_stats(
    table: LPTable,
    keys: torch.Tensor,
    compact_lanes: bool | None = None,
    *,
    route: HashRoute = HASH_KERNELS,
) -> MatchStats:
    """Drain the LP chain of every key (int64[n]): advance until the first
    empty slot per lane (linear_probing_ht.cpp:60-115).

    A chain holds at most `max_run` occupied slots, so `max_run` steps find
    every match; the step after them could only find the empty slot.

    With `compact_lanes` (default for n >= 2^16), step 0 runs at full
    width; then each stage compacts the surviving lanes' (cursor, probe
    row) pairs with `compact_i32` into half the previous width (down to
    max(n // 16, 16384)), gathers their keys, runs one step and adds its
    hits to the rows with one scatter; the tail drains at the last width
    and is added once. A stage whose survivors overflow its width makes
    the call recompute at full width: one flag read back a call. Every
    probe whose key is in the table survives step 0 (its home slot is
    occupied), so the first stage overflows whenever more than half the
    probes hit, as at config 1 (the JAX package's schedule; ROADMAP
    Queue 3)."""
    keys = keys.contiguous()
    n = keys.numel()
    h = route.hash(keys) & (table.n_slots - 1)
    all_live = torch.ones(n, dtype=torch.bool, device=keys.device)
    if compact_lanes is None:
        compact_lanes = n >= (1 << 16)
    if not compact_lanes:
        return MatchStats(*_lp_drain(table, keys, h, all_live, table.max_run))

    hit, pay, live_c, cursor_c = _lp_step(table, keys, h, all_live)
    cap, floor = n, max(n // 16, 16384)
    # Rows n .. n + widest - 1 are sinks: a lane that adds nothing adds to
    # row n + lane, so no two lanes of one scatter share a row (one shared
    # sink row serialized the scatter's atomics on the card).
    widest = max(n // 2, floor) if n > floor else n
    sinks = torch.zeros(widest, dtype=torch.int32, device=keys.device)
    mult = torch.cat([hit.to(torch.int32), sinks])
    psum = torch.cat([pay, sinks.to(torch.int64)])
    keys_c = keys
    rows_c = torch.arange(n, dtype=torch.int64, device=keys.device)
    overflowed = torch.zeros((), dtype=torch.bool, device=keys.device)
    steps_done = 1
    while cap > floor:
        new_cap = max(cap // 2, floor)
        planes = torch.stack([cursor_c.to(torch.int32), rows_c.to(torch.int32)])
        packed, n_live = route.compact(planes, live_c)
        overflowed |= n_live > new_cap
        cursor_c = packed[0, :new_cap].to(torch.int64)
        rows_c = packed[1, :new_cap].to(torch.int64)
        keys_c = keys[rows_c]
        lane = torch.arange(new_cap, device=keys.device)
        live_c = lane < n_live.clamp(max=new_cap)
        cap = new_cap
        hit, pay, live_c, cursor_c = _lp_step(table, keys_c, cursor_c, live_c)
        at = torch.where(hit, rows_c, n + lane)
        mult.index_add_(0, at, hit.to(torch.int32))
        psum.index_add_(0, at, pay)
        steps_done += 1
    tail = max(table.max_run - steps_done, 0)
    acc_m, acc_p = _lp_drain(table, keys_c, cursor_c, live_c, tail)
    at = torch.where(acc_m > 0, rows_c, n + torch.arange(cap, device=keys.device))
    mult.index_add_(0, at, acc_m)
    psum.index_add_(0, at, acc_p)
    if bool(overflowed):
        return lp_match_stats(table, keys, compact_lanes=False, route=route)
    return MatchStats(mult=mult[:n], psum=psum[:n])


def csr_match_stats(
    table: CSRTable, keys: torch.Tensor, *, route: HashRoute = HASH_KERNELS
) -> MatchStats:
    """Drain each key's (int64[n]) bucket entries (chaining_ht.cpp:82-124)
    in lock-step, `max_len` steps."""
    keys = keys.contiguous()
    b = route.hash(keys) & (table.n_buckets - 1)
    cursor = table.offsets[b].to(torch.int64)
    end = table.offsets[b + 1].to(torch.int64)
    mult = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    psum = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    for _ in range(table.max_len):
        live = cursor < end
        safe = torch.where(live, cursor, 0)
        hit = live & (table.entry_keys[safe] == keys)
        mult += hit.to(torch.int32)
        psum += torch.where(hit, table.entry_payloads[safe], 0)
        cursor = cursor + 1
    return MatchStats(mult=mult, psum=psum)


def match_stats(table, keys) -> MatchStats:
    """Per-probe (mult, psum) of one level. A narrow probe column stays
    narrow for a sorted table (the stats pack takes int32 without
    widening) and widens to int64 for a hash table."""
    if isinstance(table, SortedTable):
        return sorted_match_stats(table, keys)
    if not isinstance(table, (LPTable, CSRTable)):
        raise TypeError(f"unknown table type {type(table)}")
    keys = torch.as_tensor(keys).to(device=table.device, dtype=torch.int64)
    drain = lp_match_stats if isinstance(table, LPTable) else csr_match_stats
    return drain(table, keys)


def _check_tables(tables) -> tuple:
    tables = tuple(tables)
    if not tables:
        raise ValueError("at least one table is needed")
    for table in tables:
        if not isinstance(table, TABLE_TYPES):
            raise TypeError(f"unknown table type {type(table)}")
    return tables


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
    if len(tables) == 1 and isinstance(tables[0], SortedTable):
        count, checksum = sorted_match_totals(tables[0], cols[0])
        return BulkResult(count=count, payload_checksums=checksum.reshape(1))
    return combine_levels([match_stats(t, c) for t, c in zip(tables, cols)])


def bulk_count(
    tables: Sequence,
    probe_rows: np.ndarray | torch.Tensor,
    tile_rows: int | None = None,
) -> BulkResult:
    """Count (and payload-checksum) the N-way join of `probe_rows` (int[n,
    n_joins], int32 or int64, numpy or torch) against `tables` (sorted, LP
    or CSR, one a level), without materializing output; optionally in
    `tile_rows`-row slices to bound memory. The probe columns move to the
    first table's device; an int32 column stays int32 for a sorted
    table."""
    tables = _check_tables(tables)
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
    """(rows, keys, payloads) of every match of `keys` at one level.
    Capacity is the worst case n * max_mult, so nothing is cut."""
    cap = keys.numel() * max(int(table.max_mult), 1)
    rows, ck, cp, total = sorted_expand(table, keys, cap)
    n_keep = int(total)
    return rows[:n_keep].to(torch.int64), ck[:n_keep], cp[:n_keep]


def _expand_grid(table, keys: torch.Tensor):
    """(rows, keys, payloads) of every match of `keys` at one level of a
    hash table: its candidate grid's matches, compacted in row-major order
    (`compact_i32` on the flat candidate index), as the JAX package's
    stable argsort orders them."""
    expand = lp_expand_grid if isinstance(table, LPTable) else csr_expand_grid
    grid = expand(table, keys)
    n, width = grid.match.shape
    flat = torch.arange(n * width, dtype=torch.int32, device=keys.device)
    packed, n_keep = compact_i32(flat[None], grid.match.reshape(-1))
    keep = packed[0, : int(n_keep)].to(torch.int64)
    return keep // width, grid.keys.reshape(-1)[keep], grid.payloads.reshape(-1)[keep]


def bulk_materialize(
    tables: Sequence,
    probe_rows: np.ndarray | torch.Tensor,
    payload_mode,
) -> torch.Tensor:
    """The full N-way join output, int64[rows, 3 * n_joins] on the first
    table's device: the probe row, then two columns per level, (0, key) in
    REFERENCE mode or (key, payload) in FULL mode, as
    exec/oracle.oracle_pipeline has them; row order is not part of the
    contract. `payload_mode` is a PayloadMode or its value. A hash level's
    memory grows with n * its chain bound."""
    mode = PayloadMode(getattr(payload_mode, "value", payload_mode))
    tables = _check_tables(tables)
    probe = torch.as_tensor(probe_rows).to(torch.int64).to(tables[0].device)
    n, n_joins = probe.shape
    if n_joins != len(tables):
        raise ValueError(f"probe_rows has {n_joins} columns for {len(tables)} tables")
    src = torch.arange(n, device=probe.device)
    appended = torch.zeros((0, n), dtype=torch.int64, device=probe.device)
    for level, table in enumerate(tables):
        expand = _expand_sorted if isinstance(table, SortedTable) else _expand_grid
        row_of, ck, cp = expand(table, probe[src, level])
        src = src[row_of]
        appended = appended[:, row_of]
        if mode is PayloadMode.REFERENCE:
            new_cols = torch.stack([torch.zeros_like(ck), ck])
        else:
            new_cols = torch.stack([ck, cp])
        appended = torch.cat([appended, new_cols])
    return torch.cat([probe[src], appended.T], dim=1)
