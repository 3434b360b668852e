"""Plain reference of query kind `materialize`, in PyTorch, on any device.

The source's join with its result emitted: every probe row that matches
m build rows gives m output rows (probe key, build key, build payload).
For each probe key, its matches are the range of equal keys in the build
keys sorted: `searchsorted` left and right give the range; each probe row
is repeated by its match count (`repeat_interleave`) and its build rows
gathered from the range, so any number of equal build keys is expanded.

The answer is an order-free digest of the output rows (`digest`): their
number, the sum of each column, and the sum over rows of a 64-bit hash of
the row, all in wrapping arithmetic, so that two multisets of rows give
the same digest whatever their order, and blocks of probe rows add up.
`acc` is the type every sum is kept in: int64 holds the answer; the
control keeps them in int32, the nearest type below, where they wrap. It
imports nothing of the program and reads only the benchmark's own columns.
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 22  # probe rows a block, so that the reference fits beside the pool


def _signed(c: int) -> int:
    """A 64-bit constant as the int64 with its bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


# the row's weights (odd, so that each field changes the hash) and the
# finalizer's multipliers (splitmix64's)
WEIGHTS = [_signed(c) for c in (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9)]
MIX = [_signed(c) for c in (0xBF58476D1CE4E5B9, 0x94D049BB133111EB)]


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """x >> s as a logical shift of the 64 bits (torch's `>>` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def row_hash(rows: torch.Tensor) -> torch.Tensor:
    """int64[r]: splitmix64's finalizer of p·C1 + k·C2 + v·C3 for each row
    (p, k, v) of `rows` (int64[r, 3]), in wrapping arithmetic."""
    # the weights filled on the device: a tensor copied from the host would
    # make the query wait for the device
    weights = torch.stack([rows.new_full((), w) for w in WEIGHTS])
    z = (rows * weights).sum(1)
    z = (z ^ _lsr(z, 30)) * MIX[0]
    z = (z ^ _lsr(z, 27)) * MIX[1]
    return z ^ _lsr(z, 31)


def digest(rows: torch.Tensor, acc: torch.dtype = torch.int64) -> dict:
    """{"count", "column_sums", "row_hash"} of `rows` (int64[r, 3]), each a
    sum kept in `acc`: the number of rows, the sum of each column, and the
    sum of `row_hash` over the rows."""
    return {
        "count": rows.new_full((), rows.shape[0]).to(acc),
        "column_sums": rows.sum(0, dtype=acc),
        "row_hash": row_hash(rows).sum(dtype=acc),
    }


def _sorted(build: list) -> tuple:
    """The one build table's keys sorted, and its payloads in that order."""
    if len(build) != 1:
        raise ValueError(f"materialize joins one build table, got {len(build)}")
    (keys, payloads), = build
    keys = keys.to(torch.int64)
    order = torch.argsort(keys, stable=True)
    return keys[order], payloads.to(torch.int64)[order]


def _rows(table: tuple, col: torch.Tensor) -> torch.Tensor:
    """int64[r, 3]: every output row of the probe keys `col` against the
    sorted `table`, grouped by probe row."""
    sorted_keys, sorted_pays = table
    col = col.to(torch.int64).contiguous()
    lo = torch.searchsorted(sorted_keys, col, right=False)
    mult = torch.searchsorted(sorted_keys, col, right=True) - lo
    src = torch.repeat_interleave(torch.arange(col.numel(), device=col.device), mult)
    first = torch.cumsum(mult, 0) - mult  # each probe row's first output row
    at = lo[src] + torch.arange(src.numel(), device=col.device) - first[src]
    return torch.stack([col[src], sorted_keys[at], sorted_pays[at]], dim=1)


def rows(build: list, probe: torch.Tensor) -> torch.Tensor:
    """int64[r, 3]: every output row of `probe` ([n, 1]) against `build`
    ([(keys, payloads)]), grouped by probe row."""
    return _rows(_sorted(build), probe[:, 0])


def output_rows(build: list, probe: torch.Tensor) -> int:
    """The number of output rows of `probe` ([n, 1]) against `build`."""
    sorted_keys, _ = _sorted(build)
    col = probe[:, 0].to(torch.int64).contiguous()
    hi = torch.searchsorted(sorted_keys, col, right=True)
    return int((hi - torch.searchsorted(sorted_keys, col, right=False)).sum())


def answer(build: list, probe: torch.Tensor, acc: torch.dtype = torch.int64) -> dict:
    """`digest` of every output row of `probe` ([n, 1]) against `build`
    ([(keys, payloads)]), computed in blocks of BLOCK_ROWS probe rows."""
    table = _sorted(build)
    out = digest(torch.zeros((0, 3), dtype=torch.int64, device=probe.device), acc)
    for lo_row in range(0, probe.shape[0], BLOCK_ROWS):
        part = digest(_rows(table, probe[lo_row : lo_row + BLOCK_ROWS, 0]), acc)
        out = {k: out[k] + part[k] for k in out}
    return out
