"""A model in numpy of the count side's merge level on merge_multi.cu's
key-only build (#2 `merge_level_i32`, #13's `merge_level_i64`), held
exactly against the port's plain version (`merge_level_plain`) and, as a
ladder, against `sort_runs_plain`.

A level over x[0, n) pairs runs of L = 2^run_log; its output is cut into
tiles of chunk = min(4096, 2L) outputs, so a tile never straddles a run
pair and the ragged last pair (a short B, or none) falls out of the
arithmetic. A partition kernel finds every tile's split (A's elements
before its first output) by a warp's 32-way search; the merge kernel then
merges the A and B slices between a tile's split and the next one's (the
last tile of a pair ends at A's end). The merge inside a tile (merge-path
search and serial merge by 256 threads of 16) is #7's, modelled in
tests/test_torch_pairsort_design.py; here a tile's slices are merged
stably, A first at ties.

The ladder entry (`ccve_sort_runs`) sorts the tiles into the buffer from
which an even number of levels ends in the output, then runs each level
from one buffer into the other.
"""

import numpy as np
import pytest
import torch

from ccve_tpu_torch.kernels import bigsort

CHUNK = 256 * 16  # merge_multi.cu: kThreads * kPerThread
WARP = 32


def level_tiles(n, run_log):
    """Level's tiles: (a0, b0, la, lb, d0, d1, out0), chunk min(CHUNK, 2L)."""
    L = 1 << run_log
    chunk = min(CHUNK, 2 * L)
    for out0 in range(0, n, chunk):
        base = (out0 >> (run_log + 1)) << (run_log + 1)
        la = min(n - base, L)
        lb = max(min(n - base - L, L), 0)
        d0 = out0 - base
        yield base, base + la, la, lb, d0, min(d0 + chunk, la + lb), out0


def binary_split(a, b, d):
    """merge_path::split: A's elements among the first d outputs."""
    lo, hi = max(0, d - b.size), min(d, a.size)
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= b[d - mid - 1]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def warp_split(a, b, d):
    """partition_kernel: each step, lane k tests the last point of the k-th
    of 32 equal parts of [lo, hi); the first part whose last point lies
    past the split holds it."""
    lo, hi = max(0, d - b.size), min(d, a.size)
    steps = 0
    while lo < hi:
        step = -(-(hi - lo) // WARP)
        ends = [lo + (lane + 1) * step - 1 for lane in range(WARP)]
        past = [e >= hi or not a[e] <= b[d - e - 1] for e in ends]
        if not any(past):
            lo = hi
        else:
            f = past.index(True)
            lo, hi = lo + f * step, min(ends[f], hi)
        steps += 1
    return lo, steps


def level_model(x, run_log):
    """One key-only level as the two kernels compute it."""
    tiles = list(level_tiles(x.size, run_log))
    splits = []
    for a0, b0, la, lb, d0, _, _ in tiles:
        a, b = x[a0:a0 + la], x[b0:b0 + lb]
        split, steps = warp_split(a, b, d0)
        assert split == binary_split(a, b, d0)
        span = min(d0, la) - max(0, d0 - lb)  # the diagonal's candidates
        assert 32 ** (steps - 1) <= max(span, 1)  # each step cuts the span 32-fold
        splits.append(split)
    y = np.empty_like(x)
    for t, (a0, b0, la, lb, d0, d1, out0) in enumerate(tiles):
        a_lo = splits[t]
        a_hi = la if d1 == la + lb else splits[t + 1]
        b_lo = d0 - a_lo
        nb = (d1 - d0) - (a_hi - a_lo)
        assert 0 <= a_lo <= a_hi <= la and 0 <= b_lo and b_lo + nb <= lb
        both = np.concatenate([x[a0 + a_lo:a0 + a_hi], x[b0 + b_lo:b0 + b_lo + nb]])
        y[out0:out0 + d1 - d0] = both[np.argsort(both, kind="stable")]
    return y


def ladder_model(x, run_log, tile_log):
    """`ccve_sort_runs`: the tile sort, then the levels between two buffers,
    the first chosen so that the last level ends in the output."""
    n_levels = bigsort._n_levels(x.size, run_log, tile_log)
    bufs = [None, None]  # y, t
    cur = n_levels & 1
    bufs[cur] = np.sort(x.reshape(-1, 1 << tile_log), axis=1).reshape(-1)
    for level in range(n_levels):
        bufs[cur ^ 1] = level_model(bufs[cur], tile_log + level)
        cur ^= 1
    assert cur == 0
    return bufs[0]


def _runs(rng, n, dtype, kind):
    info = np.iinfo(dtype)
    if kind == "ties":
        return rng.integers(0, 3, n).astype(dtype)
    x = rng.integers(info.min, info.max, n, dtype=np.int64, endpoint=True).astype(dtype)
    if kind == "extremes":
        x[rng.random(n) < 0.3] = info.max
        x[rng.random(n) < 0.3] = info.min
    return x


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [1, 5, 4095, 4097, 8193, 3 * 8192 + 5])
@pytest.mark.parametrize("kind", ["ties", "extremes"])
def test_level_model_equals_plain(dtype, n, kind):
    """run_log 0..13: tiles of 2L outputs while 2L is under a tile, the
    ragged last pair, a pair with no B; each level from the plain
    version's output of the level before."""
    rng = np.random.default_rng(n)
    runs = _runs(rng, n, dtype, kind)
    for run_log in range(14):
        got = level_model(runs, run_log)
        runs = bigsort.merge_level_plain(torch.from_numpy(runs), run_log).numpy()
        np.testing.assert_array_equal(got, runs, err_msg=f"run_log {run_log}")


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("tile_log, n_tiles", [(13, 5), (11, 3), (4, 70), (1, 9)])
def test_ladder_model_equals_plain(dtype, tile_log, n_tiles):
    """Every parity of the level count, capped by run_log or by one run
    covering the stream."""
    rng = np.random.default_rng(n_tiles + tile_log)
    x = _runs(rng, n_tiles << tile_log, dtype, "extremes")
    for run_log in range(tile_log, tile_log + 5):
        want = bigsort.sort_runs_plain(torch.from_numpy(x), run_log, tile_log).numpy()
        np.testing.assert_array_equal(ladder_model(x, run_log, tile_log), want)
        np.testing.assert_array_equal(
            bigsort.sort_runs(torch.from_numpy(x), run_log, tile_log).numpy(), want)


def test_splits_fit_the_scratch():
    """`ccve_merge_splits_bytes(n, run_log)` sizes a level's splits, one a
    tile, at the ladder's first level; later levels take no more."""
    for n in (8192, 5 * 8192, 1953 * 8192):
        first = len(list(level_tiles(n, 13)))
        assert first == -(-n // CHUNK)
        assert all(len(list(level_tiles(n, r))) <= first for r in range(13, 22))
