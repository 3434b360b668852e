"""64-bit murmur-style hash finalizer.

Port of `ccve_tpu.ops.hashing`: the reference's `murmurhash64`
(hash_functions.h:8-16), three rounds of `x ^= x >> 32; x *= M` with
M = 0xd6e8feb86659fd93 on uint64 with a wrapping multiply. Three
implementations, all bit-identical:

 - murmurhash64:    torch; kernel #12 (`kernels.murmur`) on a CUDA tensor,
                    its plain int64 version on a CPU tensor. Returns int64
                    holding the uint64 bits (torch's uint64 has no shifts).
 - murmurhash64_np: NumPy (host-side builds and oracles); returns uint64
 - murmurhash64_py: pure-Python int (ground truth in tests)
"""

from __future__ import annotations

import numpy as np
import torch

from ccve_tpu_torch.kernels.murmur import MURMUR_MULTIPLIER, murmurhash64_i64


def murmurhash64(x: torch.Tensor) -> torch.Tensor:
    """Hash of a 1-D int32 or int64 tensor (int32 widens first, as the JAX
    package's uint64 cast does); int64 holding the uint64 hash bits."""
    if x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"murmurhash64: expected int32 or int64 keys, got {x.dtype}")
    return murmurhash64_i64(x.to(torch.int64).contiguous())


def murmurhash64_np(x: np.ndarray) -> np.ndarray:
    """NumPy hash of an int64/uint64 array; returns uint64."""
    x = np.asarray(x).astype(np.uint64)
    m = np.uint64(MURMUR_MULTIPLIER)
    s = np.uint64(32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> s)
        x = x * m
        x = x ^ (x >> s)
        x = x * m
        x = x ^ (x >> s)
    return x


def murmurhash64_py(x: int) -> int:
    """Pure-Python hash of one value (ground truth)."""
    mask = (1 << 64) - 1
    x &= mask
    x ^= x >> 32
    x = (x * MURMUR_MULTIPLIER) & mask
    x ^= x >> 32
    x = (x * MURMUR_MULTIPLIER) & mask
    x ^= x >> 32
    return x
