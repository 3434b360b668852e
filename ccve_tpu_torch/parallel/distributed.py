"""Hash partitioning of join keys, the first piece of the distributed tier.

Port of `ccve_tpu.parallel.distributed`'s `_owner_np` and `_owner_jnp`: a
key's owner among P parts is the top log2(P) bits of its murmur64 hash
(`ops.hashing`), so a key and every copy of it land on one part. The
aggregate's skew statistic (`ops.aggregate.partition_histogram`) counts
keys by owner. The distributed plans (the flat shuffle, ring, PRPD split,
hierarchical and broadcast joins) and their process groups come with slice
9 (ROADMAP Queue 1) and extend this module.

The JAX package shifts the uint64 hash right by 64 - int(log2(P)). Here the
hash is int64 holding the uint64 bits, where `>>` carries the sign in, so
the shifted value is masked to its int(log2(P)) bits. For a P that is no
power of two only the owners 0 .. 2^int(log2(P)) - 1 occur, as in JAX.
Owners are int64, torch's index type; JAX's `_owner_jnp` returns int32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ccve_tpu_torch.ops.hashing import murmurhash64, murmurhash64_np


def _owner_bits(n_parts: int) -> int:
    if n_parts < 1:
        raise ValueError(f"n_parts must be at least 1, got {n_parts}")
    return int(math.log2(n_parts))


def _owner(keys: torch.Tensor, n_parts: int) -> torch.Tensor:
    """int64[n]: each key's part among `n_parts`, the top
    int(log2(n_parts)) bits of its murmur64 hash (kernel #12 on a CUDA
    tensor); all zeros for one part."""
    bits = _owner_bits(n_parts)
    if bits == 0:
        return torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    return (murmurhash64(keys) >> (64 - bits)) & ((1 << bits) - 1)


def _owner_np(keys: np.ndarray, n_parts: int) -> np.ndarray:
    """`_owner` in numpy on the uint64 hash: int64[n]."""
    bits = _owner_bits(n_parts)
    if bits == 0:
        return np.zeros(keys.shape[0], np.int64)
    return (murmurhash64_np(keys) >> np.uint64(64 - bits)).astype(np.int64)
