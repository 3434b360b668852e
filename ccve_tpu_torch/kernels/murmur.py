"""The murmur64 hash finalizer of int64 keys.

Counterpart of `ccve_tpu.kernels.murmur.murmurhash64_pallas`:
`murmurhash64_i64` (kernel csrc/murmur.cu) hashes each key with three
rounds of `x ^= x >> 32` and a wrapping multiply by MURMUR_MULTIPLIER
between them, on uint64, bit-exact with the reference's `murmurhash64`.
Keys and hashes travel as int64 holding the uint64 bits: `h & (2^k - 1)`
is the same slot either way.
"""

from __future__ import annotations

import torch

from ccve_tpu_torch.kernels import _build

MURMUR_MULTIPLIER = 0xD6E8FEB86659FD93
# the multiplier as the int64 of the same bits: int64 multiplies wrap, so
# the low 64 bits of the product are those of the uint64 product
_M_SIGNED = MURMUR_MULTIPLIER - 2**64


def _logical_shift32(x: torch.Tensor) -> torch.Tensor:
    """`x >> 32` of the uint64 bits of int64 `x` (torch's uint64 has no
    shifts, and int64's `>>` carries the sign in)."""
    return (x >> 32) & 0xFFFFFFFF


def murmurhash64_plain(x: torch.Tensor) -> torch.Tensor:
    """`murmurhash64_i64` in int64 torch ops, on any device."""
    x = x ^ _logical_shift32(x)
    x = x * _M_SIGNED
    x = x ^ _logical_shift32(x)
    x = x * _M_SIGNED
    return x ^ _logical_shift32(x)


def murmurhash64_i64(x: torch.Tensor) -> torch.Tensor:
    """int64[n]: the murmur64 hash of each key of `x` (int64[n]) as the
    int64 of its uint64 bits."""
    _build.check_int(x, "x", torch.int64)
    if x.device.type == "cpu":
        return murmurhash64_plain(x)
    out = torch.empty_like(x)
    if not x.numel():
        return out
    code = _build.load().ccve_murmurhash64_i64(
        x.data_ptr(), out.data_ptr(), x.numel(), _build.stream(x)
    )
    _build.check(code, "murmurhash64_i64")
    murmurhash64_i64.launches += 1
    return out


murmurhash64_i64.launches = 0
