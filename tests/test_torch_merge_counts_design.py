"""A model in numpy of the count side's merge counts (csrc/merge_counts.cu,
#3 `merge_counts_i32` and #14 `merge_counts_i64`), held exactly against
the port's plain version (`merge_counts_plain`).

A block owns a tile of T = threads * rows consecutive build rows [j0, j1);
each thread holds `rows` consecutive rows. In run r (the real probes
[r * run_len, min((r + 1) * run_len, n_real))) the probes that can match
the tile lie in the slice [lower_bound(b[j0] - 1), lower_bound(b[j1 - 1])).
The block searches the slices of up to RUN_BATCH runs at once, each bound
by a group of g lanes that test g points a step. Each thread
binary-searches its first row's lower bound i in the slice. A slice of at
most `stage` keys is staged in shared memory; there, when the WINDOW keys
from i's 16-byte word on reach the thread's last key (or the slice's
end), the thread counts each row by comparing it with every key of that
window. Otherwise, and in a slice too long for the stage, it gallops from
row to row, a repeated key taking the count of the row before it.
"""

import numpy as np
import pytest
import torch

from ccve_tpu_torch.bench.edge_cases import (
    MERGE_COUNTS_KINDS, MERGE_COUNTS_TILE, merge_counts_case, probe_runs)
from ccve_tpu_torch.kernels import merge_scan

THREADS = 256  # merge_counts.cu: kThreads
ROWS = 4  # kRows<K>
TILE = THREADS * ROWS
STAGE = {np.dtype(np.int32): 11 * TILE // 4, np.dtype(np.int64): 11 * TILE // 4}  # kStage<K>
WINDOW = {np.dtype(np.int32): 24, np.dtype(np.int64): 32}  # kWindow<K>
VEC = {np.dtype(np.int32): 4, np.dtype(np.int64): 2}  # keys a 16-byte word
RUN_BATCH = THREADS // 2  # kRunBatch
WARP = 32
assert TILE == MERGE_COUNTS_TILE


def lower_bound(a, lo, hi, v):
    """(first index in [lo, hi) with a[i] >= v, else hi; loads)."""
    loads = 0
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        loads += 1
        if a[mid] < v:
            lo = mid + 1
        else:
            hi = mid
    return lo, loads


def gallop(a, i, n, v):
    """The same bound in a[i, n) when a[i - 1] < v: steps of 1, 2, 4, ...
    from i, then a binary search inside the last step."""
    lo, hi, step, loads = i, i, 1, 0
    while hi < n:
        loads += 1
        if not a[hi] < v:
            break
        lo = hi + 1
        hi = hi + step if step < n - hi else n
        step <<= 1
    bound, more = lower_bound(a, lo, hi, v)
    return bound, loads + more


def group_lower_bound(a, lo, hi, v, g):
    """(lower bound of v in a[lo, hi), steps): each step the group's g
    lanes test the g points that cut [lo, hi) into g + 1 parts; the first
    at or above v bounds the answer."""
    steps = 0
    while lo < hi:
        n = hi - lo
        points = [lo + (k + 1) * n // (g + 1) for k in range(g)]
        past = [not a[p] < v for p in points]
        f = past.index(True) if any(past) else g
        lo, hi = (lo if f == 0 else points[f - 1] + 1), (hi if f == g else points[f])
        steps += 1
    return lo, steps


def group_size(nb, threads=THREADS):
    """Lanes a search for a batch of nb runs: 2 * nb searches share the
    block's threads, at most a warp each."""
    g = WARP
    while g > 1 and 2 * nb * g > threads:
        g >>= 1
    return g


def count_slice(s, keys, cnt):
    """Adds to cnt[q] the entries of s equal to keys[q] - 1 (ascending
    keys, one thread's rows); returns the loads it made."""
    if not keys.size or not s.size:
        return 0
    n = s.size
    i, loads = lower_bound(s, 0, n, keys[0] - 1)
    c = 0
    for q in range(keys.size):
        if q == 0 or keys[q] != keys[q - 1]:
            i, a = gallop(s, i, n, keys[q] - 1)
            e, b = gallop(s, i, n, keys[q])
            c, i, loads = e - i, e, loads + a + b
        cnt[q] += c
    return loads


def count_window(buf, n, keys, cnt, window, vec):
    """count_staged: the window of `window` keys from the 16-byte word of
    the first row's lower bound i, when it reaches the last row's key or
    the slice's end, counted by compares (keys past n masked: the buffer
    holds stale keys there); else the walk. Returns whether the window
    counted."""
    if not keys.size or not n:
        return True
    i, _ = lower_bound(buf, 0, n, keys[0] - 1)
    a = i & ~(vec - 1)
    if a + window < n and buf[a + window - 1] < keys[-1]:
        walk = cnt.copy()
        count_slice(buf[:n], keys, walk)
        cnt[:] = walk
        return False
    win = buf[a:a + window]
    live = np.arange(window) < n - a
    for q in range(keys.size):
        cnt[q] += int(np.sum(live & (win == keys[q] - 1)))
    return True


def counts_model(runs, run_len, n_real, b, threads=THREADS, rows=ROWS, stage=None,
                 run_batch=RUN_BATCH, window=None):
    """(bc int32[m], {"staged", "direct", "search_steps", "windows",
    "walks"}) as the kernel computes it, tile by tile."""
    runs, b = np.asarray(runs), np.asarray(b)
    stage = STAGE[runs.dtype] if stage is None else stage
    vec = VEC[runs.dtype]
    window = WINDOW[runs.dtype] if window is None else window
    tile = threads * rows
    m = b.size
    bc = np.zeros(m, np.int32)
    stats = {"staged": 0, "direct": 0, "search_steps": 0, "windows": 0, "walks": 0}
    n_runs = -(-n_real // run_len)
    for j0 in range(0, m, tile):
        j1 = min(j0 + tile, m)
        lo_key, hi_key = b[j0] - 1, b[j1 - 1]
        cnt = np.zeros(j1 - j0, np.int64)
        for r0 in range(0, n_runs, run_batch):
            nb = min(n_runs - r0, run_batch)
            g = group_size(nb, threads)
            assert 2 * nb * g <= threads
            slices = []
            for r in range(r0, r0 + nb):
                lo, hi = r * run_len, min((r + 1) * run_len, n_real)
                s, st = group_lower_bound(runs, lo, hi, lo_key, g)
                e, et = group_lower_bound(runs, lo, hi, hi_key, g)
                assert s == lo + np.searchsorted(runs[lo:hi], lo_key)
                assert e == lo + np.searchsorted(runs[lo:hi], hi_key)
                stats["search_steps"] = max(stats["search_steps"], st, et)
                slices.append((s, e))
            for s, e in slices:
                staged = e - s <= stage
                if staged:
                    # the staged copy, then stale keys up to the buffer's end
                    stale = np.resize(b[j0:j1] - 1, stage + window - (e - s))  # would match
                    buf = np.concatenate([runs[s:e], stale])
                    stats["staged"] += 1
                else:
                    stats["direct"] += 1
                for t in range(threads):
                    first = t * rows
                    if first >= j1 - j0:
                        break
                    keys = b[j0 + first:min(j0 + first + rows, j1)]
                    view = cnt[first:first + keys.size]
                    if not staged:
                        count_slice(runs[s:e], keys, view)
                    elif count_window(buf, e - s, keys, view, window, vec):
                        stats["windows"] += 1
                    else:
                        stats["walks"] += 1
        bc[j0:j1] = cnt
    return bc, stats


def plain(runs, run_len, n_real, b):
    return merge_scan.merge_counts_plain(torch.from_numpy(runs), run_len, n_real,
                                         torch.from_numpy(b), b.size).numpy()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", MERGE_COUNTS_KINDS)
def test_model_equals_plain(dtype, kind):
    """Every case of `bench.edge_cases.merge_counts_case` at the kernel's
    tile and stage."""
    rng = np.random.default_rng(MERGE_COUNTS_KINDS.index(kind))
    runs, run_len, n_real, b = merge_counts_case(rng, dtype, kind, TILE)
    want = plain(runs, run_len, n_real, b)
    got, stats = counts_model(runs, run_len, n_real, b)
    np.testing.assert_array_equal(got, want)
    if kind in ("a tile of one key", "one key holds most probes"):
        assert stats["direct"] > 0  # a slice past the stage, counted where it lies
    if kind == "key across a tile boundary":
        assert (want[TILE - 50:TILE + 50] == want[TILE]).all() and want[TILE] >= 4000
    if kind == "runs of 2^11":
        assert -(-n_real // run_len) > RUN_BATCH  # more runs than one batch searches
    if kind == "extremes":
        assert b[-1] == np.iinfo(dtype).max and runs[-1] == np.iinfo(dtype).max
        assert want[-1] >= 600


@pytest.mark.parametrize("threads, rows, stage, window",
                         [(8, 4, 64, 8), (32, 1, 40, 4), (64, 2, 300, 16)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_small_tiles_equal_plain(threads, rows, stage, window, dtype):
    """Tiles of 32-128 rows and stages of 40-300 keys: many tiles, keys
    straddling their boundaries, slices past the stage, batches of fewer
    runs than the run count."""
    rng = np.random.default_rng(threads + rows)
    probes = rng.integers(0, 2000, 70_000)
    probes[rng.random(70_000) < 0.1] = 777
    runs = probe_runs(probes * 2, 11, dtype)
    b = (np.sort(rng.integers(0, 2000, 1500)) * 2 + 1).astype(dtype)
    n_real = probes.size - 33
    got, stats = counts_model(runs, 2048, n_real, b, threads, rows, stage, threads // 2, window)
    np.testing.assert_array_equal(got, plain(runs, 2048, n_real, b))
    assert stats["staged"] and stats["direct"]


@pytest.mark.parametrize("n_runs, span, steps", [(8, 1 << 21, 6), (1, 1 << 24, 5),
                                                  (128, 1 << 13, 14), (64, 1 << 13, 9)])
def test_group_search_steps(n_runs, span, steps):
    """A batch of n_runs runs gives each bound g lanes: g = 16 at config 1's
    8 runs, so a bound in a run of 2^21 takes at most 6 steps, not 21; a
    full batch of 128 runs searches with one lane each (a binary search):
    at most ceil(log_{g+1}(span + 1)) steps."""
    g = group_size(n_runs)
    assert g == {8: 16, 1: 32, 128: 1, 64: 2}[n_runs]
    rng = np.random.default_rng(n_runs)
    a = np.sort(rng.integers(0, 4 * span, span))
    worst = 0
    for v in list(rng.integers(-1, 4 * span + 1, 40)) + [a[0], a[-1], a[span // 2]]:
        got, used = group_lower_bound(a, 0, span, v, g)
        assert got == np.searchsorted(a, v)
        worst = max(worst, used)
    assert worst <= steps


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_windows_cover_config_1_density(dtype):
    """At config 1's density (two probes a build row a run, Poisson) the
    window from a thread's first lower bound holds all its rows' probes in
    nearly every thread, so nearly every warp counts by compares alone; its
    counts equal the walk's."""
    rng = np.random.default_rng(4)
    keys = (np.sort(rng.choice(1 << 20, TILE, replace=False)) * 2 + 1).astype(dtype)
    probes = np.sort(np.repeat(keys, rng.poisson(2, TILE)) - 1)
    window = WINDOW[np.dtype(dtype)]
    buf = np.concatenate([probes, np.resize(keys - 1, window)])
    windows = 0
    for t in range(THREADS):
        mine = keys[t * ROWS:(t + 1) * ROWS]
        got, walk = np.zeros(ROWS, np.int64), np.zeros(ROWS, np.int64)
        windows += count_window(buf, probes.size, mine, got, window, VEC[np.dtype(dtype)])
        count_slice(probes, mine, walk)
        np.testing.assert_array_equal(got, walk)
    assert windows >= THREADS - 2
