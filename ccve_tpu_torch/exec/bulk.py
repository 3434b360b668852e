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
level by level (a sorted table's int32 kernel route through
`expand_compacted` and the emission kernel, other sorted levels through
`sorted_expand`, a hash table through its candidate grid).
Tables of int64 keys (a key span above 2^30) take the int64 builds of the
sort-merge kernels on both sides. A single-level count answers every key
span: one of 2^62 or more (64-bit fingerprints, hashed ids) takes the
generic totals of `sorted_match_totals`.

The hash drains loop to bounds known at build time (an LP chain meets an
empty slot within `max_run` slots, a CSR bucket holds at most `max_len`
entries), so no step reads a flag back to the host; the LP ladder reads
one overflow flag a call, which keeps its answer exact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.kernels.compact import compact_i32, compact_plain
from ccve_tpu_torch.kernels.emit import emit_rows_i32
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
    expand_compacted,
    sorted_expand,
    sorted_match_stats,
    sorted_match_totals,
    stats_key_type,
)
from ccve_tpu_torch.utils import profiler

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
    the call recompute at full width: one flag read back a call. A lane
    survives step 0 when its home slot is occupied: every hit, and the
    misses whose home slot holds another key, about a quarter of them at
    a load of at most 25 %. So the first stage overflows once more than
    about a third of the probes hit, as at config 1 (the JAX package's
    schedule; ROADMAP Queue 3).

    The ladder's steps are spans of the open query (`utils.profiler`):
    `lp.first` (the hash, step 0, the accumulators), `lp.ladder` (the
    stages; each counts its width, `stage_width`, and its live lanes,
    `stage_live`), `lp.tail` (the tail drain and its scatter) and, when
    the flag is set, `lp.fallback` (the recompute); the query's root
    counts the flag as `fallbacks`."""
    keys = keys.contiguous()
    n = keys.numel()
    if compact_lanes is None:
        compact_lanes = n >= (1 << 16)
    if not compact_lanes:
        h = route.hash(keys) & (table.n_slots - 1)
        all_live = torch.ones(n, dtype=torch.bool, device=keys.device)
        return MatchStats(*_lp_drain(table, keys, h, all_live, table.max_run))

    with profiler.span("lp.first"):
        h = route.hash(keys) & (table.n_slots - 1)
        all_live = torch.ones(n, dtype=torch.bool, device=keys.device)
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
    with profiler.span("lp.ladder", follows=True):
        while cap > floor:
            new_cap = max(cap // 2, floor)
            planes = torch.stack([cursor_c.to(torch.int32), rows_c.to(torch.int32)])
            packed, n_live = route.compact(planes, live_c)
            overflowed |= n_live > new_cap
            cursor_c = packed[0, :new_cap].to(torch.int64)
            rows_c = packed[1, :new_cap].to(torch.int64)
            keys_c = keys[rows_c]
            lane = torch.arange(new_cap, device=keys.device)
            stage_live = n_live.clamp(max=new_cap)
            live_c = lane < stage_live
            profiler.count("stage_width", new_cap)
            profiler.count("stage_live", stage_live)
            cap = new_cap
            hit, pay, live_c, cursor_c = _lp_step(table, keys_c, cursor_c, live_c)
            at = torch.where(hit, rows_c, n + lane)
            mult.index_add_(0, at, hit.to(torch.int32))
            psum.index_add_(0, at, pay)
            steps_done += 1
    with profiler.span("lp.tail", follows=True):
        tail = max(table.max_run - steps_done, 0)
        acc_m, acc_p = _lp_drain(table, keys_c, cursor_c, live_c, tail)
        at = torch.where(acc_m > 0, rows_c, n + torch.arange(cap, device=keys.device))
        mult.index_add_(0, at, acc_m)
        psum.index_add_(0, at, acc_p)
    fallback = bool(overflowed)
    profiler.count("fallbacks", int(fallback))
    if fallback:
        with profiler.span("lp.fallback", follows=True):
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
    table. The call is the root span `bulk.count` of a query
    (`utils.profiler.span`); a single level over a sorted table records
    the count side's steps as its children, an LP level on the ladder
    `lp_match_stats`'s."""
    tables = _check_tables(tables)
    probe = torch.as_tensor(probe_rows)
    if probe.dim() != 2 or probe.shape[1] != len(tables):
        raise ValueError(
            f"probe_rows must be [n, {len(tables)}], got {tuple(probe.shape)}"
        )
    n = probe.shape[0]
    with profiler.span("bulk.count", device=tables[0].device):
        if probe.dtype != torch.int32:
            probe = probe.to(torch.int64)
        probe = probe.to(tables[0].device)
        cols = [probe[:, level].contiguous() for level in range(len(tables))]
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
    """(rows, keys, payloads, total) of every match of `keys` at one level
    off the kernel route (int64 keys, the generic route): the first
    `total` slots hold them. Capacity is the worst case n * max_mult, so
    nothing is cut."""
    return sorted_expand(table, keys, keys.numel() * max(int(table.max_mult), 1))


def _expand_grid(table, keys: torch.Tensor):
    """(rows, keys, payloads, total) of every match of `keys` at one level
    of a hash table: its candidate grid's matches, compacted in row-major
    order (`compact_i32` on the flat candidate index), as the JAX package's
    stable argsort orders them; `total` is their number, a Python int."""
    expand = lp_expand_grid if isinstance(table, LPTable) else csr_expand_grid
    grid = expand(table, keys.contiguous())
    n, width = grid.match.shape
    flat = torch.arange(n * width, dtype=torch.int32, device=keys.device)
    packed, n_keep = compact_i32(flat[None], grid.match.reshape(-1))
    n_keep = int(n_keep)
    keep = packed[0, :n_keep].to(torch.int64)
    return keep // width, grid.keys.reshape(-1)[keep], grid.payloads.reshape(-1)[keep], n_keep


def _emit_torch(state, rows, keys, pays, total, full: bool) -> torch.Tensor:
    """A level's output rows off the emission kernel: the first `total`
    triples' state rows gathered, then (key, payload), or (0, key) without
    `full`, in one concatenation."""
    n_keep = int(total)
    keys, pays = keys[:n_keep, None], pays[:n_keep, None]
    new = (keys, pays) if full else (torch.zeros_like(keys), keys)
    return torch.cat([state[rows[:n_keep].to(torch.int64)], *new], dim=1)


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
    memory grows with n * its chain bound.

    The partial output rows are carried level to level: they start as the
    probe rows, and a level turns them into its matches' rows, each with
    the level's two columns appended. A level over a sorted table on the
    stats side's int32 kernel route takes `expand_compacted`'s planes and
    writes its rows in one launch (`emit_rows_i32`); other levels gather
    the rows and concatenate the new columns.

    The call is the root span `bulk.materialize` of a query
    (`utils.profiler.span`). A level on the int32 kernel route records
    `expand_compacted`'s steps as its children, then the emission
    (`expand.emit`: the host's read of the match count, the output's
    allocation and the emission kernel); other levels record none."""
    mode = PayloadMode(getattr(payload_mode, "value", payload_mode))
    full = mode is PayloadMode.FULL
    tables = _check_tables(tables)
    with profiler.span("bulk.materialize", device=tables[0].device):
        state = torch.as_tensor(probe_rows).to(torch.int64).to(tables[0].device).contiguous()
        if state.dim() != 2 or state.shape[1] != len(tables):
            raise ValueError(f"probe_rows has shape {tuple(state.shape)} for {len(tables)} tables")
        for level, table in enumerate(tables):
            keys = state[:, level]
            if isinstance(table, SortedTable) and stats_key_type(table) == torch.int32:
                planes, total = expand_compacted(table, keys)
                with profiler.span("expand.emit", follows=True):
                    state = emit_rows_i32(planes, int(total), table.pack32[0], state, level, full)
            else:
                expand = _expand_sorted if isinstance(table, SortedTable) else _expand_grid
                state = _emit_torch(state, *expand(table, keys), full)
        return state
