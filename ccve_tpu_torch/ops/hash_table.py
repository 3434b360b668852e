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

Not ported here: the device CSR build `build_csr_device` (the distributed
tier, ROADMAP slice 9) and the staged scan of the chunk-at-a-time executor
(`ScanState`, `lp_probe`, `csr_probe`, `scan_*`; slice 6).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ccve_tpu_torch.ops.hashing import murmurhash64, murmurhash64_np
from ccve_tpu_torch.ops.sort_merge import require_device

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


def build_lp(keys, payloads=None, device="cuda") -> LPTable:
    """Sequential first-empty-slot insertion (linear_probing_ht.cpp:27-36)
    on the host, then the table to `device` (default the GPU; raises
    without one)."""
    device = require_device(device)
    keys, payloads = _columns(keys, payloads)
    n_slots = next_pow2(4 * keys.shape[0])  # load factor <= 25 %
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


def build_csr(keys, payloads=None, device="cuda") -> CSRTable:
    """Chaining build (chaining_ht.cpp:4-36) in CSR layout on the host,
    insertion order kept within each bucket (std::list push_back), then
    the table to `device` (default the GPU; raises without one)."""
    device = require_device(device)
    keys, payloads = _columns(keys, payloads)
    n_buckets = next_pow2(2 * keys.shape[0])  # chaining_ht.cpp:5-6
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
