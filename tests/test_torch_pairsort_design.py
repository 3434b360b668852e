"""Models in numpy of the two CUDA designs of the stats side's probe sort,
held exactly against the port's plain versions (keys and every plane) and,
composed into a sort, against the JAX package's Pallas sort in interpret
mode.

- #7 (csrc/merge_multi.cu): a level or a merge of two is cut into output
  tiles of min(4096, 2L) outputs; a partition finds each tile's
  merge-path split by the kernel's 32-way warp search; each tile merges
  from its staged A and B slices, 256 threads of 16 outputs, each thread
  by a merge-path search and a serial merge.
- #6 (csrc/sort_tiles_multi.cu): a tile's threads (T / 16, at least one)
  load 16 elements each, striped, as (key, tile index) words, sort them by
  the kernel's bitonic network in registers, then merge their runs in
  log2(threads) merge-path rounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.pairsort import pallas_sort_multi_i32 as jax_sort
from ccve_tpu_torch.kernels import pairsort
from torch_interpret import interpret

THREADS, PER_THREAD = 256, 16  # merge_multi.cu: kThreads, kPerThread
CHUNK = THREADS * PER_THREAD
WARP = 32
ITEMS = 16  # sort_tiles_multi.cu: kItems
INFO = {torch.int32: np.iinfo(np.int32), torch.int64: np.iinfo(np.int64)}


def split(na, nb, d, le):
    """merge_path::split: A's elements among the first d outputs."""
    lo, hi = max(0, d - nb), min(d, na)
    while lo < hi:
        mid = (lo + hi) >> 1
        if le(mid, d - mid - 1):
            lo = mid + 1
        else:
            hi = mid
    return lo


def serial(ai, na, bi, nb, count, le):
    """merge_path::serial: (from_a, index) of `count` outputs from (ai, bi)."""
    out = []
    for _ in range(count):
        if ai < na and (bi >= nb or le(ai, bi)):
            out.append((True, ai))
            ai += 1
        else:
            out.append((False, bi))
            bi += 1
    return out


def warp_split(a, b, la, lb, d):
    """merge_multi.cu's partition_kernel: the 32-way search of one tile."""
    lo, hi = max(0, d - lb), min(d, la)
    while lo < hi:
        step = -(-(hi - lo) // WARP)
        ends = [lo + (lane + 1) * step - 1 for lane in range(WARP)]
        past = [e >= hi or not a[e] <= b[d - e - 1] for e in ends]
        if not any(past):
            lo = hi
        else:
            f = past.index(True)
            lo, hi = lo + f * step, min(ends[f], hi)
    return lo


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


def two_tiles(na, nb):
    for d0 in range(0, na + nb, CHUNK):
        yield 0, 0, na, nb, d0, min(d0 + CHUNK, na + nb), d0


def merge_model(xa, vas, xb, vbs, tiles):
    """A merge kernel's outputs: partition, then each tile from its staged
    slices."""
    tiles = list(tiles)
    n = sum(d1 - d0 for *_, d0, d1, _ in tiles)
    splits = [warp_split(xa[a0:], xb[b0:], la, lb, d0) for a0, b0, la, lb, d0, _, _ in tiles]
    for t, (a0, b0, la, lb, d0, _, _) in enumerate(tiles):
        want = split(la, lb, d0, lambda i, j: xa[a0 + i] <= xb[b0 + j])
        assert splits[t] == want, (t, splits[t], want)
    y = np.empty(n, xa.dtype)
    yvs = [np.empty(n, np.int32) for _ in vas]
    for t, (a0, b0, la, lb, d0, d1, out0) in enumerate(tiles):
        cnt = d1 - d0
        a_lo = splits[t]
        a_hi = la if d1 == la + lb else splits[t + 1]
        b_lo = d0 - a_lo
        na, nb = a_hi - a_lo, cnt - (a_hi - a_lo)
        sa, sb = xa[a0 + a_lo:a0 + a_hi], xb[b0 + b_lo:b0 + b_lo + nb]
        pa = [v[a0 + a_lo:a0 + a_hi] for v in vas]
        pb = [v[b0 + b_lo:b0 + b_lo + nb] for v in vbs]
        le = lambda i, j: sa[i] <= sb[j]  # noqa: E731
        for thread in range(THREADS):
            diag = min(thread * PER_THREAD, cnt)
            ai = split(na, nb, diag, le)
            for k, (from_a, i) in enumerate(serial(ai, na, diag - ai, nb,
                                                   min(PER_THREAD, cnt - diag), le)):
                y[out0 + diag + k] = sa[i] if from_a else sb[i]
                for p, yv in enumerate(yvs):
                    yv[out0 + diag + k] = pa[p][i] if from_a else pb[p][i]
    return y, yvs


def merge_level_model(keys, vals, run_log):
    return merge_model(keys, vals, keys, vals, level_tiles(keys.size, run_log))


def merge_two_model(ak, avs, bk, bvs):
    return merge_model(ak, avs, bk, bvs, two_tiles(ak.size, bk.size))


def _word(key, index, dtype):
    """A tile's (key, index) word: int32 keys pack into one int64, int64
    keys pair with a 16-bit index."""
    return (int(key) << 32) | index if dtype == torch.int32 else (int(key), index)


def _pad(dtype):
    return INFO[torch.int64].max if dtype == torch.int32 else (INFO[torch.int64].max, 0xFFFF)


def sort_items(items):
    """sort_tiles_multi.cu's sort_items: the bitonic network over 16."""
    it = list(items)
    k = 2
    while k <= ITEMS:
        j = k >> 1
        while j > 0:
            for i in range(ITEMS):
                l = i ^ j  # noqa: E741
                if l > i:
                    swap = not it[i] <= it[l] if (i & k) == 0 else not it[l] <= it[i]
                    if swap:
                        it[i], it[l] = it[l], it[i]
            j >>= 1
        k <<= 1
    return it


def sort_tile_model(keys, dtype):
    """One tile's sorted (key, index) words, as the kernel's threads find
    them."""
    T = keys.size
    threads = max(T // ITEMS, 1)
    items = [sort_items([_word(keys[t + k * threads], t + k * threads, dtype)
                         if t + k * threads < T else _pad(dtype) for k in range(ITEMS)])
             for t in range(threads)]
    width = 1
    while width < threads:
        shared = [w for run in items for w in run]
        run = width * ITEMS
        nxt = []
        for t in range(threads):
            first = (t & ~(2 * width - 1)) * ITEMS
            diag = (t & (2 * width - 1)) * ITEMS
            le = lambda i, j: shared[first + i] <= shared[first + run + j]  # noqa: E731,B023
            ai = split(run, run, diag, le)
            nxt.append([shared[first + i] if from_a else shared[first + run + i]
                        for from_a, i in serial(ai, run, diag - ai, run, ITEMS, le)])
        items, width = nxt, 2 * width
    return [w for run in items for w in run][:T]


def sort_tiles_model(keys, vals, tile_log, dtype):
    T = 1 << tile_log
    out_k, out_v = np.empty_like(keys), [np.empty_like(v) for v in vals]
    for base in range(0, keys.size, T):
        for e, w in enumerate(sort_tile_model(keys[base:base + T], dtype)):
            key, index = (w >> 32, w & 0xFFFFFFFF) if dtype == torch.int32 else w
            out_k[base + e] = key
            for o, v in zip(out_v, vals):
                o[base + e] = v[base + index]
    return out_k, out_v


def _keys(rng, n, dtype, dom):
    """Keys with heavy ties (dom values) or over the whole type, the
    extremes (the maximum is also the padding) among them."""
    info = INFO[dtype]
    if dom:
        k = rng.integers(0, dom, n)
    else:
        k = rng.integers(info.min, info.max, n, endpoint=True)
        k[rng.random(n) < 0.1] = info.max
        k[rng.random(n) < 0.1] = info.min
    return k.astype(np.int32 if dtype == torch.int32 else np.int64)


def _planes(rng, n, count):
    return [rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32) for _ in range(count)]


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0].numpy())
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w.numpy())


T_ = torch.from_numpy
DTYPES = [torch.int32, torch.int64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n, run_logs", [(1, range(3)), (7, range(4)), (300, range(10)),
                                         (9000, (12, 13, 14)), (20_000, (13, 14, 20))])
@pytest.mark.parametrize("dom", [3, None])
def test_merge_level_model(dtype, n, run_logs, dom):
    """Tiles of min(4096, 2L) at run_log 0..20, the ragged last pair and an
    empty B, against `merge_level_multi_plain`."""
    rng = np.random.default_rng(n + (dom or 0))
    n_planes = 1 + n % 3
    keys, vals = T_(_keys(rng, n, dtype, dom)), [T_(v) for v in _planes(rng, n, n_planes)]
    for run_log in range(max(run_logs) + 1):
        if run_log in run_logs:
            _same(merge_level_model(keys.numpy(), [v.numpy() for v in vals], run_log),
                  pairsort.merge_level_multi_plain(keys, vals, run_log))
        keys, vals = pairsort.merge_level_multi_plain(keys, vals, run_log)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("na, nb", [(0, 0), (0, 9), (9, 0), (4095, 1), (1, 4096),
                                    (3000, 2100), (6000, 5)])
@pytest.mark.parametrize("dom", [2, None])
def test_merge_two_model(dtype, na, nb, dom):
    rng = np.random.default_rng(na * 3 + nb)
    n_planes = 1 + (na + nb) % 3
    ak, bk = np.sort(_keys(rng, na, dtype, dom)), np.sort(_keys(rng, nb, dtype, dom))
    avs, bvs = _planes(rng, na, n_planes), _planes(rng, nb, n_planes)
    _same(merge_two_model(ak, avs, bk, bvs),
          pairsort.merge_two_multi_plain(T_(ak), [T_(v) for v in avs], T_(bk),
                                         [T_(v) for v in bvs]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile_log", [1, 2, 3, 4, 5, 6, 8, 10, 13])
@pytest.mark.parametrize("dom", [2, None])
def test_sort_tiles_model(dtype, tile_log, dom):
    """Tiles below one thread's 16 elements (padded), up to 2^13 (512
    threads, 9 rounds), against `sort_tiles_multi_plain`."""
    rng = np.random.default_rng(tile_log * 5 + (dom or 0))
    n = (2 if tile_log < 13 else 1) << tile_log
    n_planes = 1 + tile_log % 3
    keys, vals = _keys(rng, n, dtype, dom), _planes(rng, n, n_planes)
    _same(sort_tiles_model(keys, vals, tile_log, dtype),
          pairsort.sort_tiles_multi_plain(T_(keys), [T_(v) for v in vals], tile_log))


def test_warp_split_equals_binary_search():
    """The partition's 32-way search gives the binary search's split at
    every diagonal, ties and empty sides included."""
    rng = np.random.default_rng(11)
    for la, lb, dom in ((0, 5, 3), (5, 0, 3), (40, 1000, 4), (3000, 70, 2), (2049, 2047, 9)):
        a, b = np.sort(rng.integers(0, dom, la)), np.sort(rng.integers(0, dom, lb))
        for d in range(0, la + lb + 1, 7):
            assert warp_split(a, b, la, lb, d) == split(la, lb, d, lambda i, j: a[i] <= b[j])


def model_sort(keys, vals, tile_log, dtype):
    """The kernels' composition as `sort_multi` runs it: pad, the tile
    sort, then the ladder of merge levels."""
    n = keys.size
    pk, pv = pairsort.pad_to_tile(T_(keys), [T_(v) for v in vals], tile_log)
    k, v = sort_tiles_model(pk.numpy(), [x.numpy() for x in pv], tile_log, dtype)
    for level in range(max((pk.numel() >> tile_log) - 1, 0).bit_length()):
        k, v = merge_level_model(k, v, tile_log + level)
    return k[:n], [x[:n] for x in v]


@pytest.mark.parametrize("n, dom, n_planes", [(3000, 40, 1), (2049, 2**30, 3)])
def test_model_sort_matches_jax(n, dom, n_planes):
    """The composed models' key plane equals the JAX package's Pallas sort
    (interpret mode, tiles of 2^10), and their (key, cargo...) tuples agree
    as multisets (the JAX sort is unstable); they equal the plain sort."""
    tile_log = 10
    rng = np.random.default_rng(n)
    keys = rng.integers(-dom, dom, n).astype(np.int32)
    vals = _planes(rng, n, n_planes)
    got = model_sort(keys, vals, tile_log, torch.int32)
    want_keys, want_vals = interpret(lambda k, vs: jax_sort(k, vs, tile_log=tile_log),
                                     jnp.asarray(keys), [jnp.asarray(v) for v in vals])
    np.testing.assert_array_equal(got[0], np.asarray(want_keys))

    def tuples(k, vs):
        rows = np.stack([np.asarray(k), *map(np.asarray, vs)], axis=1)
        return rows[np.lexsort(rows.T[::-1])]

    np.testing.assert_array_equal(tuples(*got), tuples(want_keys, want_vals))
    _same(got, pairsort.sort_multi_plain(T_(keys), [T_(v) for v in vals], tile_log))
