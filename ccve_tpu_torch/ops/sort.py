"""Radix sort: a multi-pass LSD counting sort on int64 keys.

Port of `ccve_tpu.ops.sort`. A least-significant-digit sort over 8-bit
digits, each pass a stable counting sort:

 1. the digit `(key >> shift) & 0xff` of each key, the keys as [n_tiles,
    tile];
 2. each tile's digit histogram and each key's stable rank among its
    tile's keys of the same digit, from a one-hot cumsum taken a segment
    of `seg_tiles` tiles at a time, which bounds the one-hot's memory
    (seg_tiles * tile * 256 int32: 64 MB at the defaults);
 3. digit bases (an exclusive scan of the digit totals) and tile bases (an
    exclusive scan over tiles, digit by digit);
 4. one scatter of the keys and the permutation to their positions.

Keys are biased (the sign bit flipped), so signed order is the order of
the biased bits; `bits` < 64 keeps only the low `bits` of them and skips
the passes above, for keys that share one sign in a bounded domain. The
keys are padded with INT64_MAX to a multiple of tile * seg_tiles, as in
JAX, so the permutation of the first n keys equals JAX's for every input.
On int64 the digit is exact under torch's arithmetic shift: the mask keeps
bits that the shift's sign fill never reaches. The permutation is int64
(torch's index type), where JAX's is int32.

It is on no query path, in JAX or here: config 4's ORDER BY uses
`xla_sort_pairs`, one stable `torch.sort` and a gather (the name is kept
as the JAX package's parity surface). `torch.sort` is itself a radix sort
on CUDA. This LSD sort is a parity-only path, kept because the reference
names one: its output is a stable argsort of the biased, masked keys, and
no query path may take it up.
"""

from __future__ import annotations

import torch

RADIX_BITS = 8
RADIX = 1 << RADIX_BITS
I64_MAX = 2**63 - 1
_SIGN = -(2**63)


def _radix_pass(keys_b, perm, shift: int, tile: int, seg_tiles: int):
    """One stable counting-sort pass on the digit (keys_b >> shift) & 0xff."""
    n = keys_b.numel()
    n_tiles = n // tile
    digits = ((keys_b >> shift) & (RADIX - 1)).view(n_tiles, tile)
    ranks = torch.empty_like(digits)
    hist = digits.new_empty(n_tiles, RADIX)
    bins = torch.arange(RADIX, device=keys_b.device)
    for t0 in range(0, n_tiles, seg_tiles):
        d = digits[t0 : t0 + seg_tiles]
        # the one-hot [seg, tile, RADIX] and its inclusive cumsum over the tile
        within = torch.cumsum(d[..., None] == bins, dim=1, dtype=torch.int32)
        ranks[t0 : t0 + seg_tiles] = within.gather(2, d[..., None]).squeeze(-1) - 1
        hist[t0 : t0 + seg_tiles] = within[:, -1]
    total = hist.sum(0)
    digit_base = torch.cumsum(total, 0) - total  # exclusive over digits
    tile_base = torch.cumsum(hist, 0) - hist  # exclusive over tiles
    pos = (digit_base[digits] + tile_base.gather(1, digits) + ranks).view(n)
    new_keys = torch.empty_like(keys_b).index_copy_(0, pos, keys_b)
    new_perm = torch.empty_like(perm).index_copy_(0, pos, perm)
    return new_keys, new_perm


def radix_argsort(keys: torch.Tensor, tile: int = 2048, bits: int = 64,
                  seg_tiles: int = 32) -> torch.Tensor:
    """int64[n]: the stable ascending order of int64 `keys` by LSD radix.
    `bits` bounds the significant width of the biased keys: 64 for any
    int64; fewer only for keys of one sign in a bounded domain (the bias
    sets bit 63 of every non-negative key), as JAX's callers ensure."""
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D, got {tuple(keys.shape)}")
    if not 1 <= bits <= 64:
        raise ValueError(f"bits must lie in [1, 64], got {bits}")
    n = keys.numel()
    keys = keys.to(torch.int64)
    pad = (-n) % (tile * seg_tiles)
    if pad:
        keys = torch.cat([keys, keys.new_full((pad,), I64_MAX)])
    kb = keys ^ _SIGN
    if bits < 64:
        kb = kb & ((1 << bits) - 1)
    perm = torch.arange(kb.numel(), device=keys.device)
    for p in range(-(-bits // RADIX_BITS)):
        kb, perm = _radix_pass(kb, perm, p * RADIX_BITS, tile, seg_tiles)
    return perm[:n]


def radix_sort(keys: torch.Tensor, tile: int = 2048, bits: int = 64) -> torch.Tensor:
    return keys[radix_argsort(keys, tile, bits)]


def radix_sort_pairs(keys: torch.Tensor, values: torch.Tensor, tile: int = 2048,
                     bits: int = 64):
    perm = radix_argsort(keys, tile, bits)
    return keys[perm], values[perm]


def xla_sort_pairs(keys: torch.Tensor, values: torch.Tensor):
    """(keys, values) in the keys' stable ascending order: one stable
    `torch.sort` and a gather (the JAX package's name for its library
    sort)."""
    sk, order = keys.sort(stable=True)
    return sk, values[order]
