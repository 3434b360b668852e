"""Sort-merge equi-join totals: the count-side engine.

Port of the count-side part of `ccve_tpu.ops.sort_merge`. A `SortedTable`
holds the build rows sorted by key. When the key span fits 30 bits
(`pack32`), the join packs every key into one int32, `key' << 1 | tag`
(build rows odd, probes even, `key' = key - (kmin - 1)`), sorts the probe
stream into runs and counts, for each build row j, the probes equal to
it: `bc[j]`. Then

    count = Σ bc,    checksum = Σ bc · payloads.

Counts add up over any partition of the probe stream, so the probe sort
stops early and leaves sorted runs (`count_side_plan`).

Not ported yet: the wide-key, packed-int64 and generic branches of
`sorted_match_totals` (ROADMAP Queue 1, slice 3) and the per-probe stats,
ranks and expansion (slice 2). They raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ccve_tpu_torch.kernels import bigsort
from ccve_tpu_torch.kernels.merge_scan import merge_counts_i32

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
    packed key."""

    keys: torch.Tensor  # int64[m], ascending
    payloads: torch.Tensor  # int64[m], aligned with keys
    pack: tuple | None = None
    pack32: tuple | None = None
    pay32: bool = False
    max_mult: int = 1
    span62: bool = False
    wide_ok: bool = False
    span_bits: int | None = None

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


def build_sorted(keys, payloads=None, device="cpu") -> SortedTable:
    """A SortedTable on `device` from host key (and payload) columns;
    payloads default to row + 10^7, as the reference's tables have."""
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
    )


def table_from_arrays(arrays: dict, meta: dict, device) -> SortedTable:
    """A SortedTable on `device` from another package's table: `arrays`
    holds its `keys` and `payloads` (already sorted by key) and `meta` its
    static fields (META_FIELDS). This is how a `ccve_tpu` table crosses
    over: `{"keys": np.asarray(t.keys), "payloads": np.asarray(t.payloads)}`
    and `{f: getattr(t, f) for f in META_FIELDS}`."""
    if set(arrays) != {"keys", "payloads"}:
        raise ValueError(f"arrays needs keys and payloads, got {sorted(arrays)}")
    if set(meta) != set(META_FIELDS):
        raise ValueError(f"meta needs {META_FIELDS}, got {sorted(meta)}")
    cols = {
        name: torch.tensor(np.asarray(arr, dtype=np.int64), device=device)
        for name, arr in arrays.items()
    }
    return SortedTable(**cols, **meta)


# Tuning hook: force the count-side ladder's skipped-level count (the
# 0.8 * n_pad / m rule otherwise).
SKIP_LEVELS_OVERRIDE: int | None = None


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


def _count_side_bc(p32: torch.Tensor, b32: torch.Tensor, m: int) -> torch.Tensor:
    """Dense per-build-row probe counts bc int32[m] from packed streams
    (p32 = key' << 1 probes, b32 = key' << 1 | 1 builds, b32 ascending).

    Every n takes the same route: pad to a tile multiple with INT32_MAX,
    tile sort, the merge levels the plan keeps, then the counts over all
    runs. The JAX package's small-n branch (n <= 2^13) has no job with the
    port's tile."""
    tile_log = bigsort.TILE_LOG  # read per call, so a test can shrink it
    n = p32.numel()
    n_pad, run_log = count_side_plan(n, m, tile_log)
    padded = torch.cat([p32, p32.new_full((n_pad - n,), bigsort.I32_MAX)])
    runs = bigsort.sort_runs_i32(padded, run_log, tile_log)
    return merge_counts_i32(runs, 1 << run_log, n, b32, m)


def pack32_streams(table: SortedTable, probe_keys: torch.Tensor):
    """(p32, b32): probe keys clamped into [kmin - 1, kmin - 1 + span) and
    packed even, build keys packed odd. An int32 probe column is clamped
    and shifted in int32 when both clamp bounds fit, else in int64."""
    kmin, key_bits = table.pack32
    key_lo = kmin - 1
    key_span = 1 << key_bits
    b32 = (((table.keys - key_lo) << 1) | 1).to(torch.int32)
    if (
        probe_keys.dtype == torch.int32
        and -(2**31) <= key_lo
        and key_lo + key_span - 1 < 2**31
    ):
        clamped = probe_keys.clamp(key_lo, key_lo + key_span - 1)
        p32 = (clamped - key_lo) << 1
    else:
        shifted = probe_keys.to(torch.int64) - key_lo
        p32 = (shifted.clamp(0, key_span - 1) << 1).to(torch.int32)
    return p32.contiguous(), b32.contiguous()


def _require_pack32(table: SortedTable, what: str) -> None:
    if table.pack32 is None:
        raise NotImplementedError(
            f"{what}: the table's key span does not fit 30 bits (or it is "
            "empty); the wide-key, packed-int64 and generic branches are "
            "ROADMAP Queue 1, slice 3, not ported yet"
        )


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
    _require_pack32(table, "sorted_build_counts")
    p32, b32 = pack32_streams(table, _probe_on(table, probe_keys))
    return _count_side_bc(p32, b32, table.keys.numel())


def sorted_match_totals(table: SortedTable, probe_keys):
    """(match count, matched-payload sum) of a single-level join, both
    int64 scalars on the table's device. Exact for negative payloads: they
    never enter the sort, and the dot carries the sign."""
    _require_pack32(table, "sorted_match_totals")
    p32, b32 = pack32_streams(table, _probe_on(table, probe_keys))
    bc = _count_side_bc(p32, b32, table.keys.numel()).to(torch.int64)
    return bc.sum(), (bc * table.payloads).sum()
