"""Hash tables for the equi-join: linear probing (LP) and chaining (CSR).

Port of `ccve_tpu.ops.hash_table`'s tables, host builds and candidate
grids:

 - `LPTable`: open addressing in a flat power-of-two slot array, slots =
   next_pow2(4 * n_build) (load factor <= 25 %), empty = -1, with a payload
   array beside the keys. `max_run`, the longest circular run of occupied
   slots, bounds every probe chain.
 - `CSRTable`: the reference's per-bucket chains as a CSR index:
   `offsets[b] .. offsets[b + 1]` delimit bucket b's entries in the flat
   `entry_keys` / `entry_payloads` arrays, in insertion order. Buckets =
   next_pow2(2 * n_build). `max_len` is the longest bucket.

Builds are sequential in insertion order and run on the host in numpy, as
the JAX package's fallback does; the slot and entry layouts equal the JAX
package's array for array. Tables default to the GPU and raise without
one, as `build_sorted` does. A key's slot or bucket is `murmurhash64(key)
& (size - 1)`, kernel #12 on the card.

Probing comes in two forms. The bulk executor drains every key at once
through a bounded candidate grid (`lp_expand_grid`, `csr_expand_grid`).
The chunk-at-a-time cursor executor (`exec.pipeline.JoinPipeline`) steps a
`ScanState` through the reference's phases (chaining_ht.cpp:38-173,
linear_probing_ht.cpp:39-153): `lp_probe` / `csr_probe` hash the selected
keys and drop rows whose slot or bucket is empty; `scan_next` is one Next,
match + gather + advance fused as `InOneNext`; `scan_match`,
`scan_gather` and `scan_advance` are those phases alone, for the
micro-benchmark's attribution (`bench.micro`). The per-row `std::list`
iterator is an int64 cursor, the compressstoreu a mask compaction
(cumsum and a scatter). Torch indexing and scatters take the place of the
JAX module's one-hot matmuls (`mxu_move.take1`, `put1`, `take_cols`,
`put_cols`).

Counts follow the caller: a scan given a host int count returns host int
counts, reading the card once a call (both counts of a `scan_next` in one
read), which the host-driven executor needs to steer its loop; a scan
given a count tensor (a batch of chunks, [..., block]) returns count
tensors and reads nothing.

`build_csr_device` builds a CSR table from key and payload tensors on
their device (hash, stable sort by bucket, bucket sizes, offsets), equal to
`build_csr` entry for entry, for build rows that are on the card already
(the distributed tier's partitions come from host rows, through
`build_csr` with the partitions' common `n_buckets`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ccve_tpu_torch.device import require_device
from ccve_tpu_torch.ops.hashing import murmurhash64, murmurhash64_np

EMPTY = -1  # empty-slot sentinel (linear_probing_ht.cpp:7)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class LPTable:
    """Open-addressing table. `max_run` bounds probe-chain length: the
    longest circular run of occupied slots, measured at build time."""

    slot_keys: torch.Tensor  # int64[n_slots]
    slot_payloads: torch.Tensor  # int64[n_slots]
    max_run: int

    @property
    def n_slots(self) -> int:
        return self.slot_keys.shape[0]

    @property
    def device(self) -> torch.device:
        return self.slot_keys.device


@dataclasses.dataclass(frozen=True)
class CSRTable:
    """Chaining table in CSR layout. `max_len` is the longest bucket,
    bounding the match drain."""

    offsets: torch.Tensor  # int32[n_buckets + 1]
    entry_keys: torch.Tensor  # int64[n_entries]
    entry_payloads: torch.Tensor  # int64[n_entries]
    max_len: int

    @property
    def n_buckets(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.offsets.device


def _default_payloads(keys: np.ndarray) -> np.ndarray:
    # payload = insertion index + 10_000_000 (chaining_ht.cpp:21)
    return np.arange(keys.shape[0], dtype=np.int64) + 10_000_000


def _columns(keys, payloads):
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    payloads = (
        _default_payloads(keys)
        if payloads is None
        else np.ascontiguousarray(payloads, dtype=np.int64)
    )
    return keys, payloads


def _table_size(size, default: int, n_rows: int, what: str) -> int:
    """`size`, or `default` when None; a power of two above `n_rows`."""
    size = default if size is None else int(size)
    if size < 1 or size & (size - 1) or size <= n_rows:
        raise ValueError(f"{what} must be a power of two above {n_rows} rows, got {size}")
    return size


def build_lp(keys, payloads=None, device="cuda", n_slots: int | None = None) -> LPTable:
    """Sequential first-empty-slot insertion (linear_probing_ht.cpp:27-36)
    on the host, then the table to `device` (default the GPU; raises
    without one). `n_slots` (a power of two above the row count) sizes the
    table, default next_pow2(4 * rows); the distributed tier sizes every
    partition by the largest one, as the JAX package's `_rebuild_lp`
    does."""
    device = require_device(device)
    keys, payloads = _columns(keys, payloads)
    # load factor <= 25 %
    n_slots = _table_size(n_slots, next_pow2(4 * keys.shape[0]), keys.shape[0], "n_slots")
    mask = n_slots - 1
    # Each key's slot in insertion order, over Python ints and a bytearray
    # (numpy scalar indexing is several times slower per probe).
    occupied = bytearray(n_slots)
    slot_of = []
    for s in (murmurhash64_np(keys) & np.uint64(mask)).tolist():
        while occupied[s]:
            s = (s + 1) & mask
        occupied[s] = 1
        slot_of.append(s)
    slot_keys = np.full(n_slots, EMPTY, dtype=np.int64)
    slot_payloads = np.full(n_slots, EMPTY, dtype=np.int64)
    slot_of = np.asarray(slot_of, dtype=np.int64)
    slot_keys[slot_of] = keys
    slot_payloads[slot_of] = payloads
    return LPTable(
        slot_keys=torch.from_numpy(slot_keys).to(device),
        slot_payloads=torch.from_numpy(slot_payloads).to(device),
        max_run=_longest_circular_run(slot_keys != EMPTY),
    )


def _longest_circular_run(occ: np.ndarray) -> int:
    if occ.all():
        return occ.shape[0]
    # rotate so position 0 is empty, then the longest run is a plain max
    first_empty = int(np.argmin(occ))
    r = np.roll(occ, -first_empty).astype(np.int64)
    padded = np.concatenate([[0], r, [0]])
    d = np.diff(padded)
    starts = np.nonzero(d == 1)[0]
    ends = np.nonzero(d == -1)[0]
    return int((ends - starts).max(initial=0))


def build_csr(keys, payloads=None, device="cuda", n_buckets: int | None = None) -> CSRTable:
    """Chaining build (chaining_ht.cpp:4-36) in CSR layout on the host,
    insertion order kept within each bucket (std::list push_back), then
    the table to `device` (default the GPU; raises without one).
    `n_buckets` (a power of two) sizes the index, default next_pow2(2 *
    rows), as chaining_ht.cpp:5-6 does; the distributed tier sizes every
    partition by the largest one."""
    device = require_device(device)
    keys, payloads = _columns(keys, payloads)
    n_buckets = _table_size(n_buckets, next_pow2(2 * keys.shape[0]), 0, "n_buckets")
    bucket = (murmurhash64_np(keys) & np.uint64(n_buckets - 1)).astype(np.int64)
    counts = np.bincount(bucket, minlength=n_buckets)
    offsets = np.zeros(n_buckets + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    order = np.argsort(bucket, kind="stable")
    return CSRTable(
        offsets=torch.from_numpy(offsets.astype(np.int32)).to(device),
        entry_keys=torch.from_numpy(keys[order]).to(device),
        entry_payloads=torch.from_numpy(payloads[order]).to(device),
        max_len=int(counts.max(initial=0)),
    )


def build_csr_device(keys: torch.Tensor, payloads: torch.Tensor, n_buckets: int,
                     max_len: int) -> CSRTable:
    """A CSR table built on the keys' device: murmur64 (kernel #12 on the
    card) masked to `n_buckets` (a power of two), a stable sort by bucket,
    the bucket sizes (an `index_add_`) and their cumsum as offsets.
    Insertion order holds within a bucket, as in `build_csr`. `max_len` is
    the caller's bound on the longest bucket (nothing is read back to find
    it)."""
    if n_buckets & (n_buckets - 1) or n_buckets < 1:
        raise ValueError(f"n_buckets must be a power of two, got {n_buckets}")
    if keys.dim() != 1 or payloads.shape != keys.shape:
        raise ValueError(f"keys and payloads must be 1-D of one length, got "
                         f"{tuple(keys.shape)} and {tuple(payloads.shape)}")
    keys = keys.to(torch.int64)
    bucket = murmurhash64(keys) & (n_buckets - 1)
    order = torch.sort(bucket, stable=True).indices
    counts = bucket.new_zeros(n_buckets).index_add_(0, bucket, torch.ones_like(bucket))
    offsets = torch.zeros(n_buckets + 1, dtype=torch.int32, device=keys.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return CSRTable(
        offsets=offsets,
        entry_keys=keys[order],
        entry_payloads=payloads.to(torch.int64)[order],
        max_len=int(max_len),
    )


class MatchGrid(NamedTuple):
    """Bounded match expansion of a batch of probe keys: candidate j of row
    i (j < width, the table's chain bound). `match[i, j]` marks the real
    matches; `keys` / `payloads` are the candidate build entries (garbage
    where not `match`)."""

    match: torch.Tensor  # bool[n, width]
    keys: torch.Tensor  # int64[n, width]
    payloads: torch.Tensor  # int64[n, width]


def lp_expand_grid(table: LPTable, probe_keys: torch.Tensor) -> MatchGrid:
    """All LP matches per key: slots h, h+1, ... up to the first empty one
    (LPScanStructure::Next's drain, linear_probing_ht.cpp:60-115), bounded
    by max_run."""
    probe_keys = probe_keys.to(torch.int64)
    width = max(table.max_run, 1)
    h = murmurhash64(probe_keys) & (table.n_slots - 1)
    steps = torch.arange(width, dtype=torch.int64, device=h.device)
    slots = (h[:, None] + steps[None, :]) & (table.n_slots - 1)
    cand = table.slot_keys[slots]  # [n, width]
    live = torch.cumprod((cand != EMPTY).to(torch.int32), dim=1).to(torch.bool)
    return MatchGrid(
        match=live & (cand == probe_keys[:, None]),
        keys=cand,
        payloads=table.slot_payloads[slots],
    )


def csr_expand_grid(table: CSRTable, probe_keys: torch.Tensor) -> MatchGrid:
    """All chaining matches per key: the bucket's entries start .. start +
    len (ScanInnerJoin's drain, chaining_ht.cpp:82-107), bounded by
    max_len."""
    probe_keys = probe_keys.to(torch.int64)
    width = max(table.max_len, 1)
    b = murmurhash64(probe_keys) & (table.n_buckets - 1)
    start = table.offsets[b].to(torch.int64)
    length = table.offsets[b + 1].to(torch.int64) - start
    steps = torch.arange(width, dtype=torch.int64, device=b.device)
    live = steps[None, :] < length[:, None]
    safe = torch.where(live, start[:, None] + steps[None, :], 0)
    if not table.entry_keys.numel():  # nothing to gather; every lane is dead
        empty = torch.zeros(safe.shape, dtype=torch.int64, device=b.device)
        return MatchGrid(match=live, keys=empty, payloads=empty.clone())
    cand = table.entry_keys[safe]
    return MatchGrid(
        match=live & (cand == probe_keys[:, None]),
        keys=cand,
        payloads=table.entry_payloads[safe],
    )


# ---------------------------------------------------------------------------
# Probe: staged scan (chunk-at-a-time cursor executor)
# ---------------------------------------------------------------------------


class ScanState(NamedTuple):
    """Per-row probe cursor: the reference's ScanStructure, a `std::list`
    iterator a row (chaining_ht.h:29-42) or a slot id
    (linear_probing_ht.h:19-31) plus its compacted `bucket_sel_vector_`.
    Cursor and end are dense over the input rows; the live rows are
    (sel, count). Entries of sel past count are stale: they are valid row
    indices, but mark no live row.

    LP: `cursor` is the slot id; `end` is -1 and unused (a chain ends at the
    first empty slot). CSR: `cursor` is the entry index, `end` the bucket's
    end offset."""

    cursor: torch.Tensor  # int64[..., block] current slot / entry index
    end: torch.Tensor  # int64[..., block] CSR end offset (LP: -1)
    sel: torch.Tensor  # int64[..., block] live rows, compacted (JAX: int32)
    count: int | torch.Tensor  # live rows: a host int, or int32[...]


class NextResult(NamedTuple):
    result_vector: torch.Tensor  # int64[..., block] matching input rows, compacted
    result_count: int | torch.Tensor  # as ScanState.count
    matched_keys: torch.Tensor | None  # int64[..., block] build keys, in result order
    matched_payloads: torch.Tensor | None  # int64[..., block] build payloads, likewise
    state: ScanState  # the advanced cursors


@functools.lru_cache(maxsize=32)
def _iota(n: int, device: torch.device, dtype: torch.dtype = torch.int64) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=device)


def _compress(masks: torch.Tensor, like):
    """Stream compaction of bool[..., n] masks (the reference's
    `_mm256_mask_compressstoreu_epi32`, chaining_ht.cpp:248): (sel, count)
    with sel[..., j] the j-th set index for j < count and 0 above, as JAX's
    `compress_indices`, but int64 (torch's index type: no conversion
    before the gathers and scatters that take it). Each set lane scatters
    its index to its inclusive rank; the others to a sink at 0, cut off.
    The counts come in the kind of the caller's count `like`: host ints (a
    list for a stack of masks), one read for all of them; else int32
    tensors."""
    n = masks.shape[-1]
    rank = torch.cumsum(masks, -1)  # int64
    out = torch.zeros(masks.shape[:-1] + (n + 1,), dtype=torch.int64, device=masks.device)
    out.scatter_(-1, rank * masks, _iota(n, masks.device).expand(masks.shape))
    count = rank[..., -1] if n else rank.new_zeros(masks.shape[:-1])
    return out[..., 1:], (count.tolist() if _is_host(like) else count.to(torch.int32))


def _is_host(count) -> bool:
    return isinstance(count, int)


def _lanes_below(count, n: int, device) -> torch.Tensor:
    """bool[..., n]: lane i < count (a host int or a count tensor)."""
    iota = _iota(n, device, torch.int32)
    return iota < (count if _is_host(count) else count.unsqueeze(-1))


def _lookup(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[idx] for a 1-D table and int64 indices of any shape, as one
    `index_select` (far less host time a call than advanced indexing)."""
    return values.index_select(0, idx.reshape(-1)).reshape(idx.shape)


def _hash_bits(keys: torch.Tensor, size: int) -> torch.Tensor:
    """`murmurhash64(key) & (size - 1)` of int64 keys of any shape (kernel
    #12 on a CUDA tensor)."""
    return (murmurhash64(keys.reshape(-1)) & (size - 1)).reshape(keys.shape)


def _selected(keys: torch.Tensor, sel):
    """(the selected keys in sel's order, sel as int64); sel None is the
    identity: every row in order, with no gather."""
    if sel is None:
        return keys, None
    sel64 = sel.long()
    return keys.gather(-1, sel64), sel64


def _to_rows(values: torch.Tensor, sel64) -> torch.Tensor:
    """Values in sel's order scattered back to input rows (0 at the rows
    sel does not name). A stale sel entry repeats a live row's index or
    names a dead row, with the value that row's own key gives."""
    if sel64 is None:
        return values
    return torch.zeros_like(values).scatter_(-1, sel64, values)


def _probe_out(cursor, end, live, sel, sel64, count) -> ScanState:
    pos, new_count = _compress(live, count)
    # positions into sel's order, mapped back to input rows
    return ScanState(cursor=cursor, end=end,
                     sel=pos if sel64 is None else sel64.gather(-1, pos), count=new_count)


def lp_probe(table: LPTable, keys: torch.Tensor, sel, count) -> ScanState:
    """LPHashTable::Probe (linear_probing_ht.cpp:39-66): hash each selected
    key (keys int64[..., block] through sel, or every row when sel is
    None) to its slot and drop the rows whose first slot is empty."""
    picked, sel64 = _selected(keys, sel)
    slots = _hash_bits(picked, table.n_slots)
    cursor = _to_rows(slots, sel64)
    live = (_lanes_below(count, keys.shape[-1], keys.device)
            & (_lookup(table.slot_keys, slots) != EMPTY))
    return _probe_out(cursor, torch.full_like(cursor, -1), live, sel, sel64, count)


def csr_probe(table: CSRTable, keys: torch.Tensor, sel, count) -> ScanState:
    """HashTable::Probe (chaining_ht.cpp:38-58): hash each selected key to
    its bucket, take the bucket's begin and end, and drop the rows whose
    bucket is empty."""
    picked, sel64 = _selected(keys, sel)
    b = _hash_bits(picked, table.n_buckets)
    begin, endv = _lookup(table.offsets, torch.stack((b, b + 1))).long()
    live = _lanes_below(count, keys.shape[-1], keys.device) & (endv > begin)
    return _probe_out(_to_rows(begin, sel64), _to_rows(endv, sel64), live, sel, sel64, count)


def _scan_live_mask(state: ScanState, block: int) -> torch.Tensor:
    """bool[..., block]: True exactly at the live input rows, scattered
    through the first `count` entries of sel; the stale entries past count
    go to a sink column (JAX routes them to the dropped row `block`)."""
    sel = state.sel.long()
    live = torch.zeros(sel.shape[:-1] + (block + 1,), dtype=torch.bool, device=sel.device)
    at = (sel[..., : state.count] if _is_host(state.count) else
          torch.where(_lanes_below(state.count, block, sel.device), sel, block))
    return live.scatter_(-1, at, True)[..., :block]


def _entry(table, cursor: torch.Tensor):
    """(the key at each cursor, whether the cursor holds an entry, the
    index to gather payloads at). CSR cursors are clipped to
    max(n_entries, 1) - 1 before the gather; an empty table gathers
    nothing."""
    if isinstance(table, LPTable):
        cand = _lookup(table.slot_keys, cursor)
        return cand, cand != EMPTY, cursor
    n_entries = table.entry_keys.shape[0]
    if not n_entries:
        return torch.zeros_like(cursor), torch.zeros_like(cursor, dtype=torch.bool), None
    safe = cursor.clamp(0, n_entries - 1)
    return _lookup(table.entry_keys, safe), None, safe


def _payloads(table, at) -> torch.Tensor:
    if at is None:  # an empty CSR table
        return None
    return _lookup(table.slot_payloads if isinstance(table, LPTable) else table.entry_payloads,
                   at)


def _advance(table, state: ScanState, live: torch.Tensor):
    """AdvancePointers (chaining_ht.cpp:109-124,
    linear_probing_ht.cpp:96-112): the next cursor, and the live rows that
    still have an entry there. LP cursors wrap with `& (n_slots - 1)`."""
    if isinstance(table, LPTable):
        nxt = (state.cursor + 1) & (table.n_slots - 1)
        return nxt, live & (_lookup(table.slot_keys, nxt) != EMPTY)
    nxt = state.cursor + 1
    return nxt, live & (nxt < state.end)


def scan_match(table, keys: torch.Tensor, state: ScanState):
    """Match phase alone, ScanInnerJoin (CycleProfiler slot 1,
    chaining_ht.cpp:82-107, linear_probing_ht.cpp:69-82): compare each live
    row's current entry with its key and compress the matching rows.
    Returns (result_vector, result_count). For the micro-benchmark's
    attribution (`bench.micro.run_phased_variant`); the executor uses
    `scan_next`."""
    live = _scan_live_mask(state, keys.shape[-1])
    cand, has_entry, _ = _entry(table, state.cursor)
    if has_entry is None:
        has_entry = state.cursor < state.end
    return _compress(live & has_entry & (cand == keys), state.count)


def scan_gather(table, state: ScanState, result_vector: torch.Tensor):
    """Gather phase alone, GatherResult (CycleProfiler slot 2,
    chaining_ht.cpp:126-136): the build keys and payloads at the matched
    rows' cursors."""
    cur = state.cursor.gather(-1, result_vector.long())
    cand, _, at = _entry(table, cur)
    pay = _payloads(table, at)
    return cand, (torch.zeros_like(cand) if pay is None else pay)


def scan_advance(table, state: ScanState) -> ScanState:
    """Advance phase alone, AdvancePointers (CycleProfiler slot 3,
    chaining_ht.cpp:109-124): step the cursors, drop exhausted rows."""
    live = _scan_live_mask(state, state.sel.shape[-1])
    nxt, still = _advance(table, state, live)
    sel, count = _compress(still, state.count)
    return ScanState(cursor=nxt, end=state.end, sel=sel, count=count)


def scan_next(table, keys: torch.Tensor, state: ScanState,
              want_matches: bool = True) -> NextResult:
    """One Next: match, gather and advance fused, as `InOneNext`
    (chaining_ht.cpp:138-173, linear_probing_ht.cpp:117-153). Each live row
    tests the entry at its cursor, emits at most one match and advances.
    The two compactions (matches, survivors) run as one over a stack of
    both masks, and with a host count read both counts at once.

    As in JAX, there is no inner retry on zero matches (ScanInnerJoin's
    `while (true)`, chaining_ht.cpp:82-107): such a step emits count 0,
    which the executor skips; the emitted multiset is the same.
    `want_matches=False` (count-only executors) skips the gathers of the
    matched keys and payloads, which are then None (JAX returns zeros)."""
    live = _scan_live_mask(state, keys.shape[-1])
    cand, has_entry, at = _entry(table, state.cursor)
    if has_entry is None:
        has_entry = state.cursor < state.end
    match = live & has_entry & (cand == keys)
    nxt, still = _advance(table, state, live)
    sels, counts = _compress(torch.stack((match, still)), state.count)
    result_vector, new_sel = sels[0], sels[1]
    matched_keys = matched_payloads = None
    if want_matches:
        pay = _payloads(table, at)
        matched_keys = cand.gather(-1, result_vector)
        matched_payloads = (torch.zeros_like(cand) if pay is None
                            else pay.gather(-1, result_vector))
    return NextResult(
        result_vector=result_vector,
        result_count=counts[0],
        matched_keys=matched_keys,
        matched_payloads=matched_payloads,
        state=ScanState(cursor=nxt, end=state.end, sel=new_sel, count=counts[1]),
    )
