"""A model in numpy of the count side's key-only tile sort (csrc/sort_tiles.cu,
`sort_tiles_i32` for #1 and `sort_tiles_i64` for #13's count-side build),
held exactly against the port's plain version and the JAX package's tile
sort in Pallas interpret mode: `bigsort._sort_padded_buf` with no merge
level (int32) and `pairsort.pallas_sort_i64_limbs` with no merge level
(int64), as tests/test_torch_bigsort.py and tests/test_torch_sort64.py
run them. Tolerance 0: keys are integers.

The model: a tile's threads (T / 16, at least one) load 16 keys each,
striped (key t + k * threads), slots past the tile padded with the key
type's maximum; each thread sorts its 16 by the kernel's bitonic network in
registers; then log2(threads) merge-path rounds merge the threads' runs;
the tile is the first T outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels import bigsort as jax_bigsort
from ccve_tpu.kernels.pairsort import pallas_sort_i64_limbs
from ccve_tpu_torch.kernels import bigsort
from test_torch_pairsort_design import ITEMS, serial, sort_items, split
from torch_interpret import interpret


def sort_tile_model(keys, kmax):
    """One tile sorted as the kernel's threads sort it."""
    T = keys.size
    threads = max(T // ITEMS, 1)
    runs = [sort_items([int(keys[t + k * threads]) if t + k * threads < T else kmax
                        for k in range(ITEMS)]) for t in range(threads)]
    width = 1
    while width < threads:
        shared = [x for run in runs for x in run]
        run = width * ITEMS
        nxt = []
        for t in range(threads):
            first = (t & ~(2 * width - 1)) * ITEMS
            diag = (t & (2 * width - 1)) * ITEMS
            le = lambda i, j: shared[first + i] <= shared[first + run + j]  # noqa: E731,B023
            ai = split(run, run, diag, le)
            nxt.append([shared[first + i] if from_a else shared[first + run + i]
                        for from_a, i in serial(ai, run, diag - ai, run, ITEMS, le)])
        runs, width = nxt, 2 * width
    return [x for run in runs for x in run][:T]


def sort_tiles_model(x, tile_log):
    kmax = int(np.iinfo(x.dtype).max)
    T = 1 << tile_log
    return np.concatenate([np.array(sort_tile_model(x[b:b + T], kmax), x.dtype)
                           for b in range(0, x.size, T)])


def _keys(rng, n, dtype, kind):
    info = np.iinfo(dtype)
    if kind == "equal":
        return np.full(n, rng.integers(info.min, info.max), dtype)
    if kind == "ties":
        return rng.integers(0, 3, n).astype(dtype)
    x = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    x[rng.random(n) < 0.1] = info.max  # the padding's value among the keys
    x[rng.random(n) < 0.1] = info.min
    return x


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("tile_log", list(range(1, bigsort.MAX_TILE_LOG + 1)))
@pytest.mark.parametrize("kind", ["extremes", "equal", "ties"])
def test_sort_tiles_model_equals_plain(dtype, tile_log, kind):
    """Tiles below one thread's 16 keys (padded in registers), up to 2^13
    (512 threads, 9 rounds); all-equal tiles, heavy ties, the key type's
    extremes."""
    rng = np.random.default_rng(tile_log * 3 + len(kind))
    x = _keys(rng, (2 if tile_log < 13 else 1) << tile_log, dtype, kind)
    want = bigsort.sort_tiles_plain(torch.from_numpy(x), tile_log)
    np.testing.assert_array_equal(sort_tiles_model(x, tile_log), want.numpy())


@pytest.mark.parametrize("nt", [1, 3])
def test_sort_tiles_model_matches_jax_i32(nt):
    """int32 tiles of 2^11 against the JAX tile sort (no merge level);
    values strictly inside (INT32_MIN, INT32_MAX), the JAX sort's
    sentinels."""
    tile_log = 11
    rng = np.random.default_rng(nt)
    x = rng.integers(-(2**31) + 1, 2**31 - 1, nt << tile_log, dtype=np.int64).astype(np.int32)
    want = np.asarray(interpret(
        lambda a: jax_bigsort._sort_padded_buf(a, tile_log, 0, n_levels_cap=0), jnp.asarray(x)
    )).reshape(-1)[:x.size]
    np.testing.assert_array_equal(sort_tiles_model(x, tile_log), want)


def test_sort_tiles_model_matches_jax_i64():
    """int64 tiles of 2^10 against the JAX limb sort with no merge level;
    keys strictly inside (INT64_MIN, INT64_MAX), half near ±2^62."""
    tile_log = 10
    rng = np.random.default_rng(7)
    x = rng.integers(-(2**63) + 1, 2**63 - 1, 3 << tile_log, dtype=np.int64)
    near = rng.random(x.size) < 0.5
    k = int(near.sum())
    x[near] = rng.integers(2**62 - 40, 2**62 + 40, k) * rng.choice([-1, 1], k)
    hi, lo, run_log = interpret(
        lambda a: pallas_sort_i64_limbs(a, tile_log=tile_log, n_levels_cap=0), jnp.asarray(x))
    assert int(run_log) == tile_log
    want = (np.asarray(hi).astype(np.int64) << 32) | (np.asarray(lo).astype(np.int64) & 0xFFFFFFFF)
    np.testing.assert_array_equal(sort_tiles_model(x, tile_log), want)
