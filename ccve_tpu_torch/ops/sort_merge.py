"""Sort-merge equi-join: count side, per-probe stats, ranks and expansion.

Port of `ccve_tpu.ops.sort_merge`. A `SortedTable` holds the build rows
sorted by key. Every key packs into one word, `key' << 1 | tag` with
`key' = key - (kmin - 1)`: an int32 when the key span fits 30 bits
(`pack32`), else an int64 when it is below 2^62 (`span62`, the wide
tables: hashed ids, timestamps, composite keys). The int64 bounds come off
the sorted table's ends as device scalars, so packing reads nothing back
to the host. Every kernel on these paths has an int32 and an int64 build.

 - Count side (`sorted_match_totals`, `sorted_build_counts`): probes even,
   builds odd. The probe stream is sorted into runs (`count_side_plan`)
   and each build row j gets `bc[j]`, the probes equal to it; then
   count = Σ bc and checksum = Σ bc · payloads.
 - Stats side (`sorted_match_stats`, `sorted_match_ranks`,
   `sorted_expand`): builds even, so they precede the probes of their key.
   The probes are sorted with their row ids (kernels.pairsort), merged
   with the build stream and its payloads, and scanned: per probe row its
   match count `mult` and matched-payload sum `psum` (kernels.merge_scan),
   or every matched (row, key, payload) triple, compacted
   (kernels.compact).

A table whose key span reaches 2^62 (64-bit fingerprints, hashed ids) has
no packed form: its totals sort build ∪ probe keys with the tagged payloads
(one stable int64 torch.sort) and scan them per element
(kernels.merge_scan.merge_scan_stats), and its build counts take torch
scans, as the JAX package's generic branches do. A probe stream of at most
2^SMALL_PROBE_LOG int32 keys skips the tile sort's plan: it is sorted
whole, merged with the build stream (kernels.bigsort.merge_sorted_i32) and
counted in one scan (kernels.merge_scan.merge_scan_build_counts).

The stats side's kernel route needs `pay32` (payloads ride an int32
plane) and runs on int32 keys when key_bits <= 29 (the packed probe stays
under the INT32_MAX padding), else on int64 keys when `span62`; other
tables take the generic route, one stable int64 torch.sort of build ∪
probe plus scans. Every route is exact for payloads of any sign, except
that the full-range totals tag payloads as pay * 2 + 1 in an int64, which
holds payloads in [-2^62, 2^62), as the JAX package's generic branch does;
they raise ValueError for a table with a payload outside (`pay62`).
`sorted_expand`'s kernel route is int32 only, as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from ccve_tpu_torch.device import require_device
from ccve_tpu_torch.kernels import bigsort, compact, merge_scan, pairsort

# The static fields of a SortedTable, as `ccve_tpu.ops.sort_merge` has them.
META_FIELDS = (
    "pack", "pack32", "pay32", "max_mult", "span62", "wide_ok", "span_bits",
)


@dataclasses.dataclass(frozen=True)
class SortedTable:
    """A build table for the sort-merge path: rows sorted by key.

    `pack32` is (kmin, key_bits) when `key' << 1 | 1` fits a non-negative
    int32 (key span up to 2^30), else None. The other static fields are
    those of the JAX table, computed the same way on the host: `pack`
    gates the packed-int64 branch, `pay32` and `wide_ok` the wide-key
    branches, `max_mult` is the largest key multiplicity, `span62` says the
    key span is below 2^62, and `span_bits` is the bit width of the tagged
    packed key. `pay62`, the port's own, says every payload lies in
    [-2^62, 2^62), where the full-range totals' tag `pay * 2 + 1` holds it.
    `key_range`, also the port's own, is (smallest, largest key) as host
    ints, None for an empty table."""

    keys: torch.Tensor  # int64[m], ascending
    payloads: torch.Tensor  # int64[m], aligned with keys
    pack: tuple | None = None
    pack32: tuple | None = None
    pay32: bool = False
    max_mult: int = 1
    span62: bool = False
    wide_ok: bool = False
    span_bits: int | None = None
    pay62: bool = True
    key_range: tuple | None = None

    @property
    def device(self) -> torch.device:
        return self.keys.device


def _pack_meta(keys: np.ndarray, payloads: np.ndarray):
    if keys.size == 0 or payloads.min(initial=0) < 0:
        return None
    kmin, kmax = int(keys.min()), int(keys.max())
    # probe keys clamp into [kmin - 1, kmax + 1], so the field holds range + 2
    key_bits = max((kmax - kmin + 2).bit_length(), 1)
    pay_bits = max((2 * int(payloads.max(initial=0)) + 1).bit_length(), 2)
    if key_bits + pay_bits > 62:
        return None
    return (kmin, key_bits, pay_bits)


def _pack32_meta(keys: np.ndarray):
    """(kmin, key_bits) when `key' << 1 | tag` fits a non-negative int32."""
    if keys.size == 0:
        return None
    kmin, kmax = int(keys.min()), int(keys.max())
    key_bits = max((kmax - kmin + 2).bit_length(), 1)
    if key_bits > 30:
        return None
    return (kmin, key_bits)


def build_sorted(keys, payloads=None, device="cuda") -> SortedTable:
    """A SortedTable on `device` (default the GPU; raises without one) from
    host key (and payload) columns; payloads default to row + 10^7, as the
    reference's tables have."""
    device = require_device(device)
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if payloads is None:
        payloads = np.arange(keys.shape[0], dtype=np.int64) + 10_000_000
    else:
        payloads = np.ascontiguousarray(payloads, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    if keys.size:
        span = int(keys.max()) - int(keys.min()) + 2
        max_mult = int(np.unique(keys, return_counts=True)[1].max())
    else:
        span = None
        max_mult = 1
    span62 = span is not None and span < 2**62
    return SortedTable(
        keys=torch.from_numpy(keys[order]).to(device),
        payloads=torch.from_numpy(payloads[order]).to(device),
        pack=_pack_meta(keys, payloads),
        pack32=_pack32_meta(keys),
        pay32=bool(
            payloads.size == 0
            or (payloads.min() >= -(2**31) and payloads.max() < 2**31)
        ),
        max_mult=max_mult,
        span62=span62,
        wide_ok=bool(
            span62
            and payloads.min(initial=0) >= 0
            and payloads.max(initial=0) < 2**31
        ),
        span_bits=span.bit_length() + 1 if span is not None else None,
        pay62=_pay62(payloads),
        key_range=_key_range(keys),
    )


def _key_range(keys: np.ndarray) -> tuple | None:
    return (int(keys.min()), int(keys.max())) if keys.size else None


def _pay62(payloads: np.ndarray) -> bool:
    return bool(payloads.min(initial=0) >= -(2**62) and payloads.max(initial=0) < 2**62)


def table_from_arrays(arrays: dict, meta: dict, device) -> SortedTable:
    """A SortedTable on `device` from another package's table: `arrays`
    holds its `keys` and `payloads` (already sorted by key) and `meta` its
    static fields (META_FIELDS). This is how a `ccve_tpu` table crosses
    over: `{"keys": np.asarray(t.keys), "payloads": np.asarray(t.payloads)}`
    and `{f: getattr(t, f) for f in META_FIELDS}`. `pay62` is computed
    from the payloads and `key_range` from the keys."""
    if set(arrays) != {"keys", "payloads"}:
        raise ValueError(f"arrays needs keys and payloads, got {sorted(arrays)}")
    if set(meta) != set(META_FIELDS):
        raise ValueError(f"meta needs {META_FIELDS}, got {sorted(meta)}")
    cols = {
        name: torch.tensor(np.asarray(arr, dtype=np.int64), device=device)
        for name, arr in arrays.items()
    }
    return SortedTable(**cols, **meta,
                       pay62=_pay62(np.asarray(arrays["payloads"], dtype=np.int64)),
                       key_range=_key_range(np.asarray(arrays["keys"], dtype=np.int64)))


I64_MIN = -(2**63)
I64_MAX = 2**63 - 1

# Tuning hook: force the count-side ladder's skipped-level count (the
# 0.8 * n_pad / m rule otherwise).
SKIP_LEVELS_OVERRIDE: int | None = None
# int32 probe streams of at most 2^SMALL_PROBE_LOG keys take the
# small-probe route of `_count_side_bc` (the JAX package's CHUNK_LOG)
SMALL_PROBE_LOG = 13


def count_side_plan(n: int, m: int, tile_log: int):
    """(n_pad, run_log) for n probes against m builds: the probe stream is
    padded to a multiple of the 2^tile_log tile and sorted into runs of
    2^run_log.

    The early-stop rule is the JAX package's, computed with the port's
    tile: one merge level costs a pass over n_pad, one extra run a re-scan
    of the build stream, and the optimum sits near 0.8 * n_pad / m runs.
    That balance was fitted to the TPU's costs; the H100's is still to be
    measured (ROADMAP)."""
    tile = 1 << tile_log
    n_pad = n + (-n) % tile
    n_tiles = n_pad // tile
    n_levels_full = max(n_tiles - 1, 0).bit_length()
    target_runs = max(1.0, 0.8 * n_pad / max(m, 1))
    skip = min(n_levels_full, max(0, int(np.log2(target_runs))))
    if SKIP_LEVELS_OVERRIDE is not None:
        skip = min(n_levels_full, max(0, SKIP_LEVELS_OVERRIDE))
    return n_pad, tile_log + n_levels_full - skip


def _count_side_bc(p: torch.Tensor, b: torch.Tensor, m: int) -> torch.Tensor:
    """Dense per-build-row probe counts bc int32[m] from packed streams of
    one key type, int32 or int64 (p = key' << 1 probes, b = key' << 1 | 1
    builds, b ascending).

    An int32 probe stream of at most 2^SMALL_PROBE_LOG keys (a point or
    IN-list lookup) is sorted whole, merged with the build stream and
    counted in one scan over the merged stream, as the JAX package's
    small-n branch does. Every other stream, of either key type, is padded
    to a tile multiple with the key type's maximum, tile sorted, merged
    for the levels the plan keeps, then counted over all runs, restricted
    to the n real probes (so padding is never counted). The JAX package's
    int64 routes' limb planes, per-run limb merges, split-plane ladders
    and tie fixup have no job: they exist because the TPU has no 64-bit
    lanes."""
    n = p.numel()
    if p.dtype == torch.int32 and n <= 1 << SMALL_PROBE_LOG:
        s = bigsort.merge_sorted_i32(p.sort().values, b)
        return merge_scan.merge_scan_build_counts(s, m)
    tile_log = bigsort.TILE_LOG  # read per call, so a test can shrink it
    n_pad, run_log = count_side_plan(n, m, tile_log)
    padded = torch.cat([p, p.new_full((n_pad - n,), bigsort.PAD[p.dtype])])
    runs = bigsort.sort_runs(padded, run_log, tile_log)
    return merge_scan.MERGE_COUNTS[p.dtype](runs, 1 << run_log, n, b, m)


def _shifted_keys(table: SortedTable, probe_keys: torch.Tensor):
    """(b, p): build keys as `key' << 1` and probe keys clamped into
    [kmin - 1, kmin - 1 + span) and shifted the same way, both int32 and
    untagged. An int32 probe column is clamped and shifted in int32 when
    both clamp bounds fit, else in int64."""
    kmin, key_bits = table.pack32
    key_lo = kmin - 1
    key_span = 1 << key_bits
    # key' = key - kmin + 1: kmin - 1 is no int64 when kmin is INT64_MIN
    b = ((table.keys - kmin + 1) << 1).to(torch.int32)
    if (
        probe_keys.dtype == torch.int32
        and -(2**31) <= key_lo
        and key_lo + key_span - 1 < 2**31
    ):
        clamped = probe_keys.clamp(key_lo, key_lo + key_span - 1)
        p = (clamped - key_lo) << 1
    else:
        # clamp first, to bounds saturated at the int64 range, so the
        # subtract cannot wrap
        lo, hi = max(key_lo, I64_MIN), min(key_lo + key_span - 1, I64_MAX)
        clamped = probe_keys.to(torch.int64).clamp(lo, hi)
        p = ((clamped - kmin + 1) << 1).to(torch.int32)
    return b, p


def pack32_streams(table: SortedTable, probe_keys: torch.Tensor):
    """(p32, b32) of the count side: probes packed even, builds odd."""
    b, p = _shifted_keys(table, probe_keys)
    return p.contiguous(), (b | 1).contiguous()


def stats_pack32_streams(table: SortedTable, probe_keys: torch.Tensor):
    """(b32, p32) of the stats side: builds packed even, probes odd, so a
    key's builds sort before its probes. Clamped probes match nothing: the
    low clamp sits below every build key', the high one above. With
    key_bits <= 29 the largest probe stays under INT32_MAX, the padding."""
    b, p = _shifted_keys(table, probe_keys)
    return b.contiguous(), (p | 1).contiguous()


def _shifted_keys64(table: SortedTable, probe_keys: torch.Tensor):
    """(b, p) int64 of a wide table: build keys as `key' << 1` and probe
    keys clamped into [kmin - 1, kmax + 1] and shifted the same way,
    untagged. The bounds are 0-d tensors off the sorted table's ends (no
    host read), saturated at the int64 range; the clamp comes before the
    subtract, and key' is taken as key - kmin + 1, so nothing wraps. With
    a span below 2^62 every packed key is below 2^63."""
    kmin, kmax = table.keys[0], table.keys[-1]
    lo = kmin.clamp(min=I64_MIN + 1) - 1
    hi = kmax.clamp(max=I64_MAX - 1) + 1
    b = (table.keys - kmin + 1) << 1
    p = (probe_keys.to(torch.int64).clamp(lo, hi) - kmin + 1) << 1
    return b, p


def pack64_streams(table: SortedTable, probe_keys: torch.Tensor):
    """(p64, b64) of the count side of a wide table: probes packed even,
    builds odd."""
    b, p = _shifted_keys64(table, probe_keys)
    return p.contiguous(), (b | 1).contiguous()


def stats_pack64_streams(table: SortedTable, probe_keys: torch.Tensor):
    """(b64, p64) of the stats side of a wide table: builds packed even,
    probes odd. Clamped probes match nothing."""
    b, p = _shifted_keys64(table, probe_keys)
    return b.contiguous(), (p | 1).contiguous()


def _count_streams(table: SortedTable, probe_keys: torch.Tensor):
    """(p, b) of the count side: int32 streams when the table has
    `pack32`, else int64 streams (the table's key span is below 2^62)."""
    if table.pack32 is not None:
        return pack32_streams(table, probe_keys)
    return pack64_streams(table, probe_keys)


def _full_range_build_counts(table: SortedTable, probe: torch.Tensor) -> torch.Tensor:
    """`sorted_build_counts` of a table whose key span reaches 2^62: one
    stable sort of probe ∪ build keys (probes first at equal keys), then
    each build's run's probes by torch scans; the j-th build of the sorted
    stream is table row j. The JAX package's general path, with no kernel,
    as there."""
    m, n = table.keys.numel(), probe.numel()
    keys = torch.cat([probe.to(torch.int64), table.keys])
    is_build = torch.arange(n + m, device=table.device) >= n
    sk, order = keys.sort(stable=True)
    return merge_scan.dense_build_counts(sk, is_build[order], m)


def _full_range_totals(table: SortedTable, probe: torch.Tensor):
    """`sorted_match_totals` of a table whose key span reaches 2^62: one
    stable sort of build ∪ probe keys carrying the tagged payloads
    (pay * 2 + 1 builds, 0 probes; builds first at equal keys), then
    #15's generic scan per element and the two sums. Raises ValueError
    when a payload lies outside [-2^62, 2^62), where its tag would wrap."""
    if not table.pay62:
        raise ValueError(
            "the full-range totals tag payloads as pay * 2 + 1 in an int64: "
            "this table has a payload outside [-2^62, 2^62)"
        )
    n = probe.numel()
    keys = torch.cat([table.keys, probe.to(torch.int64)])
    tagged = torch.cat([
        table.payloads * 2 + 1, torch.zeros(n, dtype=torch.int64, device=table.device)
    ])
    sk, order = keys.sort(stable=True)
    mult, psum = merge_scan.merge_scan_stats(sk, tagged[order])
    return mult.to(torch.int64).sum(), psum.sum()


def _probe_on(table: SortedTable, probe_keys) -> torch.Tensor:
    probe = torch.as_tensor(probe_keys)
    if probe.dim() != 1:
        raise ValueError(f"probe keys must be 1-D, got {tuple(probe.shape)}")
    if probe.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"probe keys must be int32 or int64, got {probe.dtype}")
    return probe.to(table.device)


def sorted_build_counts(table: SortedTable, probe_keys) -> torch.Tensor:
    """bc int32[m]: bc[j] = the number of probe keys equal to
    table.keys[j] (table order, which is sorted order)."""
    probe = _probe_on(table, probe_keys)
    if not table.keys.numel():
        return torch.zeros(0, dtype=torch.int32, device=table.device)
    if table.pack32 is None and not table.span62:
        return _full_range_build_counts(table, probe)
    p, b = _count_streams(table, probe)
    return _count_side_bc(p, b, table.keys.numel())


def sorted_match_totals(table: SortedTable, probe_keys):
    """(match count, matched-payload sum) of a single-level join, both
    int64 scalars on the table's device: the count side on int32 streams
    (`pack32`) or int64 streams (key span below 2^62), exact for negative
    payloads (they never enter the sort, and the dot carries the sign);
    for a key span of 2^62 or more, the generic totals, exact for payloads
    in [-2^62, 2^62) (ValueError outside). An empty table gives (0, 0)."""
    probe = _probe_on(table, probe_keys)
    if not table.keys.numel():
        zero = torch.zeros((), dtype=torch.int64, device=table.device)
        return zero, zero.clone()
    if table.pack32 is None and not table.span62:
        return _full_range_totals(table, probe)
    p, b = _count_streams(table, probe)
    bc = _count_side_bc(p, b, table.keys.numel()).to(torch.int64)
    return bc.sum(), (bc * table.payloads).sum()


# ---------------------------------------------------------------------------
# Stats side: per-probe stats, ranks and expansion
# ---------------------------------------------------------------------------


class MatchStats(NamedTuple):
    mult: torch.Tensor  # int32[n]: matches per probe key
    psum: torch.Tensor  # int64[n]: sum of matched payloads per probe key


class Route(NamedTuple):
    """The steps of the stats side's kernel route, on int32 keys and on
    int64 keys (the `64` steps): the kernels (`KERNELS`), or their plain
    versions (`PLAIN`), which a card run times as the yardstick."""

    sort_multi: Callable  # (keys, planes, tile_log) -> (keys, planes)
    merge_two: Callable  # (ak, avs, bk, bvs) -> (keys, planes)
    merge_stats: Callable  # (s, v, n) -> (mult, psum)
    compact: Callable  # (planes, mask) -> (planes, count)
    sort_multi64: Callable
    merge_two64: Callable
    merge_stats64: Callable


KERNELS = Route(
    pairsort.sort_multi_i32, pairsort.merge_sorted_multi_i32,
    merge_scan.merge_stats_i32, compact.compact_i32,
    pairsort.sort_multi_i64, pairsort.merge_sorted_multi_i64,
    merge_scan.merge_stats_i64,
)
PLAIN = Route(
    pairsort.sort_multi_plain, pairsort.merge_sorted_multi_plain,
    merge_scan.merge_stats_plain, compact.compact_plain,
    pairsort.sort_multi_plain, pairsort.merge_sorted_multi_plain,
    merge_scan.merge_stats_plain,
)


def stats_key_type(table: SortedTable) -> torch.dtype | None:
    """The key type of the stats side's kernel route on `table`: int32
    when the tagged key fits under INT32_MAX (key_bits <= 29), int64 when
    the key span is below 2^62, None (the generic route) otherwise, for an
    empty table, or when payloads do not fit the int32 cargo plane."""
    if not table.pay32 or not table.keys.numel():
        return None
    if table.pack32 is not None and table.pack32[1] <= 29:
        return torch.int32
    return torch.int64 if table.span62 else None


def merged_stream(table: SortedTable, probe_keys, tile_log=None, route: Route = KERNELS):
    """The kernel route's merged stream (s int32 or int64[n + m], v
    int32[n + m]): the packed probes sorted with their row ids, merged with
    the build stream and its int32 payloads (builds first at equal keys),
    on the key type `stats_key_type` picks."""
    key_type = stats_key_type(table)
    if key_type is None:
        raise ValueError("merged_stream: the table has no kernel route (stats_key_type)")
    probe = _probe_on(table, probe_keys)
    if key_type == torch.int32:
        b, p = stats_pack32_streams(table, probe)
        sort_multi, merge_two = route.sort_multi, route.merge_two
    else:
        b, p = stats_pack64_streams(table, probe)
        sort_multi, merge_two = route.sort_multi64, route.merge_two64
    rows = torch.arange(probe.numel(), dtype=torch.int32, device=probe.device)
    tl = pairsort.TILE_LOG if tile_log is None else tile_log
    sk, (sv,) = sort_multi(p, [rows], tl)
    s, (v,) = merge_two(sk, [sv], b, [table.payloads.to(torch.int32)])
    return s, v


def _merged_stats(table: SortedTable, probe: torch.Tensor):
    """The generic route: one stable sort of build ∪ probe, then prefix
    scans. Returns (mult, psum, row, is_build, key, payload) in merged
    order, mult and psum zero at build positions, row -1 there (builds
    precede probes at equal keys: they come first in the concatenation
    and the sort is stable)."""
    m, n = table.keys.numel(), probe.numel()
    dev = table.device
    keys = torch.cat([table.keys, probe.to(torch.int64)])
    pay = torch.cat([table.payloads, torch.zeros(n, dtype=torch.int64, device=dev)])
    row = torch.cat([
        torch.full((m,), -1, dtype=torch.int32, device=dev),
        torch.arange(n, dtype=torch.int32, device=dev),
    ])
    sk, order = keys.sort(stable=True)
    spay, srow = pay[order], row[order]
    is_build = srow < 0
    mult, psum = merge_scan.per_element_stats(sk, is_build, spay)
    return mult, psum, srow, is_build, sk, spay


def sorted_match_stats(
    table: SortedTable,
    probe_keys,
    allow_negative: bool = False,
    use_kernel: bool | None = None,
    tile_log: int | None = None,
    *,
    route: Route = KERNELS,
) -> MatchStats:
    """Per-probe-key (match count, matched-payload sum), in probe-row
    order.

    The kernel route (tables with int32 payloads and a key span below
    2^62, on int32 keys when key_bits <= 29 and on int64 keys otherwise;
    not with `use_kernel=False`) sorts the probes with their row ids,
    merges in the build stream and scans it, writing each probe's stats to
    its row: no unsort sort. Other tables take the generic route. Both are
    exact for payloads of any sign, so `allow_negative` (the JAX package's
    switch to a segmented scan) changes nothing here. `tile_log` sets the
    probe sort's tile."""
    del allow_negative  # every route is exact for negative payloads
    probe = _probe_on(table, probe_keys)
    n = probe.numel()
    key_type = None if use_kernel is False else stats_key_type(table)
    if key_type is not None:
        s, v = merged_stream(table, probe, tile_log, route)
        merge_stats = route.merge_stats if key_type == torch.int32 else route.merge_stats64
        mult, psum = merge_stats(s, v, n)
        return MatchStats(mult=mult, psum=psum)
    mult_sorted, psum_sorted, srow, is_build, _, _ = _merged_stats(table, probe)
    mult = torch.zeros(n, dtype=torch.int32, device=table.device)
    psum = torch.zeros(n, dtype=torch.int64, device=table.device)
    probes = ~is_build
    rows = srow[probes].to(torch.int64)
    mult[rows] = mult_sorted[probes].to(torch.int32)
    psum[rows] = psum_sorted[probes]
    return MatchStats(mult=mult, psum=psum)


def rank_table(table: SortedTable) -> SortedTable:
    """Twin of `table` whose payload is the sorted row index at each key
    run's first row and 0 elsewhere: the input of `sorted_match_ranks`. A
    probe key matches exactly one whole key run, so the twin's
    matched-payload sum is the run's start row. Shares the key column;
    the static fields are recomputed for the index payloads."""
    m = table.keys.numel()
    idx = torch.arange(m, dtype=torch.int64, device=table.device)
    payloads = torch.where(merge_scan.run_starts(table.keys), idx, 0)
    pack = None
    if table.pack32 is not None and m > 0:
        kmin, key_bits = table.pack32
        pay_bits = max((2 * (m - 1) + 1).bit_length(), 2)
        if key_bits + pay_bits <= 62:
            pack = (kmin, key_bits, pay_bits)
    return SortedTable(
        keys=table.keys,
        payloads=payloads,
        pack=pack,
        pack32=table.pack32,
        pay32=m < 2**31,
        max_mult=table.max_mult,
        span62=table.span62,
        wide_ok=table.span62 and m < 2**31,
        span_bits=table.span_bits,
        key_range=table.key_range,
    )


def sorted_match_ranks(
    rtable: SortedTable,
    probe_keys,
    use_kernel: bool | None = None,
    tile_log: int | None = None,
):
    """(mult int32[n], start int32[n]) per probe key, in probe order: the
    match count and the first matching row of the sorted table (0 where
    mult == 0). `rtable` is a `rank_table` twin."""
    st = sorted_match_stats(rtable, probe_keys, use_kernel=use_kernel, tile_log=tile_log)
    return st.mult, st.psum.to(torch.int32)


def _fit(rows, keys, pays, total, capacity: int):
    """The first `capacity` slots of the compacted triples; slots past
    `total` hold row -1, key 0 and payload 0."""
    dev = rows.device
    take = min(capacity, rows.numel())
    live = torch.arange(take, device=dev) < total
    out_rows = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
    out_keys = torch.zeros(capacity, dtype=torch.int64, device=dev)
    out_pays = torch.zeros(capacity, dtype=torch.int64, device=dev)
    out_rows[:take] = torch.where(live, rows[:take].to(torch.int32), -1)
    out_keys[:take] = torch.where(live, keys[:take], 0)
    out_pays[:take] = torch.where(live, pays[:take], 0)
    return out_rows, out_keys, out_pays, total


def _candidates(is_build, starts, cargo, fan_out: int):
    """Per merged position: (total matches, [payload of the run's f-th
    build], [valid candidate mask]) for f = 1..fan_out. A probe with at
    least f builds in its run emits one triple with the f-th's payload,
    which a copy-last scan from the f-th build carries forward."""
    ib = is_build.to(torch.int64)
    count = ib.cumsum(0)
    ordinal = count - merge_scan.segment_base(starts, count - ib)  # build: its 1-based
    #                                  place in the run; probe: the run's builds
    total = torch.where(is_build, 0, ordinal).sum()
    pays, valid = [], []
    for f in range(1, fan_out + 1):
        pays.append(merge_scan.segment_base(is_build & (ordinal == f), cargo))
        valid.append(~is_build & (ordinal >= f))
    return total, pays, valid


def expand_candidates(
    table: SortedTable, probe_keys, tile_log: int | None = None, route: Route = KERNELS
):
    """The kernel route's expansion before its compaction: (planes
    int32[3, F·L], valid bool[F·L], total int64 scalar) over the merged
    stream of L = n + m elements, F = max_mult. The planes hold (probe
    row, key', payload) per candidate; `valid` marks the matched
    triples."""
    s, v = merged_stream(table, probe_keys, tile_log, route)
    is_build = (s & 1) == 0
    key = s >> 1
    fan_out = max(int(table.max_mult), 1)
    total, pays, valid = _candidates(is_build, merge_scan.run_starts(key), v, fan_out)
    planes = torch.stack([v.repeat(fan_out), key.repeat(fan_out), torch.cat(pays)])
    return planes, torch.cat(valid), total


def sorted_expand(
    table: SortedTable,
    probe_keys,
    capacity: int,
    use_kernel: bool | None = None,
    tile_log: int | None = None,
    *,
    route: Route = KERNELS,
):
    """Every matched (probe row, build key, build payload) triple of one
    join level. Returns (rows int32[capacity], keys int64[capacity],
    payloads int64[capacity], total int64 scalar): the first
    min(total, capacity) slots hold triples, the rest row -1, key 0 and
    payload 0; `total` counts all matches, so it may exceed `capacity`.

    The probe stream and the build stream merge as in `sorted_match_stats`;
    for f = 1..max_mult the f-th build's payload of each key run reaches
    its probes by a copy-last scan, and a probe with at least f builds
    makes one candidate. The candidates are compacted in merged order
    (`compact_i32` on the kernel route), so triples come out grouped by
    key; their multiset is the contract."""
    if capacity < 0:
        raise ValueError(f"capacity {capacity} < 0")
    probe = _probe_on(table, probe_keys)
    if use_kernel is not False and stats_key_type(table) == torch.int32:
        planes, valid, total = expand_candidates(table, probe, tile_log, route)
        packed, _ = route.compact(planes, valid)
        kmin = table.pack32[0]  # key = key' - 1 + kmin; kmin - 1 may be no int64
        return _fit(
            packed[0], (packed[1].to(torch.int64) - 1) + kmin, packed[2].to(torch.int64),
            total, capacity,
        )
    fan_out = max(int(table.max_mult), 1)
    _, _, srow, is_build, sk, spay = _merged_stats(table, probe)
    total, pays, valid = _candidates(is_build, merge_scan.run_starts(sk), spay, fan_out)
    mask = torch.cat(valid)
    return _fit(
        srow.repeat(fan_out)[mask], sk.repeat(fan_out)[mask], torch.cat(pays)[mask],
        total, capacity,
    )


# Device bytes an expand tile takes per merged-stream element and per
# candidate slot (max_mult per element), with margin: the sizing rule of
# `expand_tile_rows`.
EXPAND_BYTES_PER_ELEMENT = 160
EXPAND_BYTES_PER_CANDIDATE = 64


def _free_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def expand_tile_rows(table: SortedTable) -> int:
    """Probe rows per `sorted_expand_tiled` tile: as many as half the
    table device's free memory holds (each tile's merged stream also holds
    the m build rows)."""
    per_element = EXPAND_BYTES_PER_ELEMENT + EXPAND_BYTES_PER_CANDIDATE * max(
        int(table.max_mult), 1
    )
    rows = _free_bytes(table.device) // 2 // per_element - table.keys.numel()
    return max(int(rows), 1 << 16)


def sorted_expand_tiled(
    table: SortedTable,
    probe_keys,
    tile_rows: int | None = None,
    use_kernel: bool | None = None,
    tile_log: int | None = None,
    *,
    route: Route = KERNELS,
):
    """`sorted_expand` over the probe stream in tiles of `tile_rows` rows
    (default: `expand_tile_rows`, which sizes them by free memory).
    Expansion is independent per probe row, so tiling is exact. Returns
    (tiles, total): one (rows int64[cap], keys int64[cap], payloads
    int64[cap], total int64 scalar) per tile, cap = tile length ×
    max_mult, with rows in global probe coordinates (-1 past the tile's
    total), and the grand total as a Python int (reading it is the only
    synchronization)."""
    probe = torch.as_tensor(probe_keys).reshape(-1)
    n = probe.numel()
    tile = int(tile_rows) if tile_rows else expand_tile_rows(table)
    if tile < 1:
        raise ValueError(f"tile_rows {tile} < 1")
    fan_out = max(int(table.max_mult), 1)
    tiles = []
    for start in range(0, max(n, 1), tile):
        part = probe[start : start + tile]
        rows, keys, pays, total = sorted_expand(
            table, part, part.numel() * fan_out, use_kernel, tile_log, route=route
        )
        rows = torch.where(rows >= 0, rows.to(torch.int64) + start, -1)
        tiles.append((rows, keys, pays, total))
    grand = int(torch.stack([t[3] for t in tiles]).sum())
    return tiles, grand
