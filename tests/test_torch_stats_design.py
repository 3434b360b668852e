"""A model in numpy of #15's design (csrc/merge_stats.cu on
csrc/seg_scan.cuh), held exactly against the port's plain versions and
the JAX package's scans in Pallas interpret mode. Tolerance 0: integers.

- The chunk cut: the stream is cut into tiles of THREADS * ITEMS
  elements, a thread's ITEMS consecutive. A thread reduces its elements to
  a segment (start, build count, payload sum); a warp scans its threads'
  segments by shuffles up; a thread folds the totals of the warps before
  its own.
- The look-back: a tile's exclusive prefix is read from the tiles before
  it, a tile a thread (THREADS at a time) nearest first; each warp reduces
  its 32 by shuffles down, farther lanes on the left, up to its nearest
  inclusive prefix, and the warps' values fold up to the nearest warp that
  met one; aggregates combine until an inclusive prefix. Which tiles have
  published their inclusive prefix when a tile looks back is the card's
  timing; the model takes it as an argument (`published`), and no choice
  may change the result.
- The row form's grouping: rows fall in buckets of 2^BUCKET_LOG. A tile
  counts its probes a bucket (a probe's place is its order of arrival:
  any order), lays out each bucket's run rounded up to even (a filler pads
  an odd one) in bucket order, reserves each run's slots with an add on
  the bucket's cursor (tiles in any order), and writes its runs. Past
  BINS buckets a probe takes its own slot. The scatter gathers each
  bucket's records, fillers skipped, into its rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.merge_scan import merge_scan_stats as jax_scan
from ccve_tpu.kernels.merge_scan import merge_scan_stats_packed as jax_packed
from ccve_tpu_torch.kernels import merge_scan
from torch_interpret import interpret

THREADS, ITEMS = 256, 16  # seg_scan.cuh: kThreads, kItems
BUCKET_LOG, BINS = 14, 1024  # merge_stats.cu: kBucketLog, kBins
WARP = 32
ID = (0, 0, 0)
I64 = np.iinfo(np.int64)


def combine(a, b):
    """Seg::combine: (start, count, sum), restarting at b's run start."""
    return (a[0] | b[0], b[1] if b[0] else a[1] + b[1], b[2] if b[0] else a[2] + b[2])


def wrap(x):
    """An int64 sum's wraparound, as the card's adds."""
    return int(np.int64(np.uint64(x % 2**64)))


def warp_scan_up(segs):
    """The inclusive scan of a warp's segments by shuffles up."""
    incl = list(segs)
    d = 1
    while d < WARP:
        incl = [combine(incl[lane - d], incl[lane]) if lane >= d else incl[lane]
                for lane in range(WARP)]
        d <<= 1
    return incl


def window_value(vals):
    """Lane 0's value after the look-back's shuffles down: a shuffle past
    lane 31 returns the lane's own value."""
    v = list(vals)
    d = 1
    while d < WARP:
        v = [combine(v[lane + d] if lane + d < WARP else v[lane], v[lane]) for lane in range(WARP)]
        d <<= 1
    return v[0]


def look_back(tile, agg, incl, published, threads=THREADS):
    """A window is a tile a thread, nearest first: each warp reduces its
    lanes up to its nearest inclusive prefix, and the warps' values are
    folded up to the nearest warp that met one."""
    prefix = ID
    hi = tile - 1
    while True:
        met, values = [], []
        for w in range(0, threads, WARP):
            states, vals = [], []
            for lane in range(WARP):
                j = hi - w - lane
                p = j < 0 or j == 0 or published(tile, j)
                states.append(p)
                vals.append(ID if j < 0 else incl[j] if p else agg[j])
            stop = states.index(True) if any(states) else WARP - 1
            values.append(window_value([v if lane <= stop else ID for lane, v in enumerate(vals)]))
            met.append(any(states))
        w = met.index(True) if any(met) else len(met) - 1
        window = values[w]
        for u in range(w - 1, -1, -1):
            window = combine(window, values[u])
        prefix = combine(window, prefix)
        if met[w]:
            return prefix
        hi -= threads


def scan_model(segs, published, threads=THREADS, items=ITEMS):
    """Each element's inclusive segment value, tile by tile as the scan
    kernel computes it (tiles taken in stream order, as the counter hands
    them out)."""
    L, chunk = len(segs), threads * items
    tiles = -(-L // chunk)
    agg, incl, out = [None] * tiles, [None] * tiles, [None] * L
    for tile in range(tiles):
        own = []
        for t in range(threads):
            a = ID
            for k in range(items):
                i = tile * chunk + t * items + k
                if i < L:
                    a = combine(a, segs[i])
            own.append(a)
        warp_incl = [x for w in range(0, threads, WARP) for x in warp_scan_up(own[w:w + WARP])]
        warp_total = [warp_incl[w + WARP - 1] for w in range(0, threads, WARP)]
        total = ID
        for x in warp_total:
            total = combine(total, x)
        agg[tile] = total
        prefix = ID if tile == 0 else look_back(tile, agg, incl, published, threads)
        incl[tile] = combine(prefix, total)
        for t in range(threads):
            before = ID
            for x in warp_total[:t // WARP]:
                before = combine(before, x)
            excl = warp_incl[t - 1] if t % WARP else ID
            run = combine(combine(prefix, before), excl)
            for k in range(items):
                i = tile * chunk + t * items + k
                if i < L:
                    run = combine(run, segs[i])
                    out[i] = (run[1], wrap(run[2]))
    return out


def segments(keys, is_build, pay):
    return [(int(i == 0 or keys[i] != keys[i - 1]), int(b), int(p) if b else 0)
            for i, (b, p) in enumerate(zip(is_build, pay))]


def stage_model(probes, n, n_tiles, rng, mult, psum, chunk=THREADS * ITEMS,
                bucket_log=BUCKET_LOG, bins=BINS):
    """The row form's staging and scatter: `probes` [(stream position, row,
    mult, psum)] of the valid probes; writes mult and psum."""
    buckets = -(-n >> bucket_log) if n else 0
    capacity = 1 << bucket_log if buckets > bins else ((1 << bucket_log) + n_tiles + 1) & ~1
    cursor = [0] * buckets
    records = [[None] * capacity for _ in range(buckets)]

    def direct(row, m, s):
        mult[row], psum[row] = m, s

    for tile in rng.permutation(n_tiles):  # the adds on the cursors in any order
        mine = [p for p in probes if p[0] // chunk == tile]
        if buckets > bins:
            for _, row, m, s in (mine[i] for i in rng.permutation(len(mine))):
                b = row >> bucket_log
                slot, cursor[b] = cursor[b], cursor[b] + 1
                if slot < capacity:
                    records[b][slot] = (row, m, s)
                else:
                    direct(row, m, s)
            continue
        count, rank = [0] * bins, {}
        for i in rng.permutation(len(mine)):  # arrival order at the shared adds
            b = mine[i][1] >> bucket_log
            rank[i], count[b] = count[b], count[b] + 1
        even = [(c + 1) & ~1 for c in count]
        at = np.concatenate([[0], np.cumsum(even)[:-1]])
        slot0 = [0] * bins
        listed = [None] * int(sum(even))
        for b in range(bins):
            if even[b]:
                slot0[b], cursor[b] = cursor[b], cursor[b] + even[b]
            if count[b] & 1:
                listed[at[b] + count[b]] = (~b, 0, 0)
        for i, (_, row, m, s) in enumerate(mine):
            listed[at[row >> bucket_log] + rank[i]] = (row, m, s)
        for i, x in enumerate(listed):
            b = x[0] >> bucket_log if x[0] >= 0 else ~x[0]
            slot = slot0[b] + i - at[b]
            if slot < capacity:
                records[b][slot] = x
            elif x[0] >= 0:
                direct(*x)
    for b in range(buckets):
        for x in records[b][:min(cursor[b], capacity)]:
            if x[0] >= 0:
                direct(*x)


def row_model(s, v, n, published, rng, init=0, **kw):
    """(mult, psum) of `ccve_merge_stats_*` on a row-form stream."""
    pad = np.iinfo(s.dtype).max
    is_build = (s & 1) == 0
    values = scan_model(segments(s >> 1, is_build, v), published)
    probes = [(i, int(v[i]), *values[i]) for i in range(s.size)
              if not is_build[i] and s[i] != pad and 0 <= v[i] < n]
    mult = np.full(n, init, np.int32)
    psum = np.full(n, init, np.int64)
    stage_model(probes, n, -(-s.size // (THREADS * ITEMS)), rng, mult, psum, **kw)
    return mult, psum


def per_element_model(keys, is_build, pay, published):
    values = scan_model(segments(keys, is_build, pay), published)
    mult = np.array([0 if b else m for b, (m, _) in zip(is_build, values)], np.int32)
    psum = np.array([0 if b else p for b, (_, p) in zip(is_build, values)], np.int64)
    return mult, psum


PUBLISHED = {
    "all": lambda tile, j: True,
    "none": lambda tile, j: False,  # every look-back walks to tile 0
    "some": lambda tile, j: (tile * 7 + j) % 5 == 0,
}


def row_stream(rng, n_probe, m, dom, pay_lo, pay_hi, dtype, n_rows=None, pad=0):
    """A merged row-form stream: builds `key' << 1`, probes `key' << 1 | 1`
    with distinct rows in [0, n_rows), a few rows outside, `pad` paddings."""
    n_rows = n_probe if n_rows is None else n_rows
    builds = np.sort(rng.integers(0, dom, m))
    probes = rng.integers(0, dom + 3, n_probe)
    s = np.concatenate([builds * 2, probes * 2 + 1])
    rows = rng.permutation(n_rows)[:n_probe]
    if n_probe > 4:
        rows[:2] = [-3, n_rows + 5]
    v = np.concatenate([rng.integers(pay_lo, pay_hi, m), rows])
    order = np.argsort(s, kind="stable")
    s, v = s[order].astype(dtype), v[order].astype(np.int32)
    info = np.iinfo(dtype)
    return (np.concatenate([s, np.full(pad, info.max, dtype)]),
            np.concatenate([v, rng.integers(0, 9, pad).astype(np.int32)]), n_rows)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("published", sorted(PUBLISHED))
@pytest.mark.parametrize("n_probe, m, dom, pay_lo, pay_hi, n_rows", [
    (5, 3, 2, 0, 9, None),  # below one tile
    (9000, 3000, 700, -(2**31), 2**31 - 1, 12_000),  # negative payloads, rows unnamed
    (20_000, 4, 2, 0, 5, None),  # one key run across every tile
    (30_000, 500, 400, 2**29, 2**30, 40_000),  # psum past 2^31, three buckets
])
def test_row_model_equals_plain(dtype, published, n_probe, m, dom, pay_lo, pay_hi, n_rows):
    """The row form's model, at the kernel's constants, equals the plain
    version; rows no probe names keep their value (here 0), rows outside
    [0, n) and the padding are ignored."""
    rng = np.random.default_rng(n_probe + m)
    s, v, n = row_stream(rng, n_probe, m, dom, pay_lo, pay_hi, dtype, n_rows, pad=7)
    got = row_model(s, v, n, PUBLISHED[published], rng)
    want = merge_scan.merge_stats_plain(torch.from_numpy(s), torch.from_numpy(v), n)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("bucket_log, bins", [(5, 1024), (5, 4), (8, 1024)])
def test_grouping_with_small_buckets(bucket_log, bins):
    """Many buckets a tile (runs of one, fillers everywhere), and more
    buckets than a block counts (each probe its own slot); unnamed rows
    keep their value."""
    rng = np.random.default_rng(bucket_log + bins)
    s, v, n = row_stream(rng, 6000, 800, 300, -50, 50, np.int64, 7000)
    got = row_model(s, v, n, PUBLISHED["some"], rng, init=-1, bucket_log=bucket_log, bins=bins)
    want = merge_scan.merge_stats_plain(torch.from_numpy(s), torch.from_numpy(v), n)
    named = np.zeros(n, bool)
    probe = (s & 1) == 1
    named[v[probe & (v >= 0) & (v < n)]] = True
    np.testing.assert_array_equal(got[0], np.where(named, want[0].numpy(), -1))
    np.testing.assert_array_equal(got[1], np.where(named, want[1].numpy(), -1))


@pytest.mark.parametrize("published", sorted(PUBLISHED))
def test_look_back_across_many_windows(published):
    """Tiles shrunk to two warps of 2 elements, so that a look-back crosses
    several windows of 64; the scan model equals the plain per-element
    scan."""
    rng = np.random.default_rng(4)
    keys = np.sort(rng.integers(0, 40, 20_000))  # 157 tiles of 128
    is_build = rng.random(20_000) < 0.3
    pay = rng.integers(-(2**40), 2**40, 20_000)
    values = scan_model(segments(keys, is_build, pay), PUBLISHED[published], threads=64, items=2)
    count, total = merge_scan._run_sums(torch.from_numpy(keys), torch.from_numpy(is_build),
                                        torch.from_numpy(pay))
    assert [m for m, _ in values] == count.tolist()
    assert [p for _, p in values] == total.tolist()


def test_row_model_matches_jax_scan():
    """The row form's model against the JAX scan (interpret mode; its
    cummax base needs non-negative payloads) scattered to probe rows."""
    rng = np.random.default_rng(12)
    s, v, n = row_stream(rng, 6000, 2500, 900, 0, 2**30, np.int64)
    s, v = s + (2**40 << 1), v  # wide keys
    is_build = (s & 1) == 0
    ok = ~is_build & (v >= 0) & (v < n)
    tagged = np.where(is_build, v.astype(np.int64) * 2 + 1, 0)
    mult_e, psum_e = interpret(jax_scan, jnp.asarray(s >> 1), jnp.asarray(tagged))
    want_mult, want_psum = np.zeros(n, np.int32), np.zeros(n, np.int64)
    want_mult[v[ok]] = np.asarray(mult_e)[ok]
    want_psum[v[ok]] = np.asarray(psum_e)[ok]
    got = row_model(s, v, n, PUBLISHED["some"], rng)
    np.testing.assert_array_equal(got[0], want_mult)
    np.testing.assert_array_equal(got[1], want_psum)


@pytest.mark.parametrize("L, dom, extremes", [(1, 3, False), (4097, 5, True), (9000, 0, True),
                                               (12_000, 2, False)])
def test_generic_model(L, dom, extremes):
    """The generic form's model per element equals the plain version, with
    INT64_MIN and INT64_MAX among the keys and payloads of any sign, and,
    without the extremes and on non-negative payloads, the JAX scan."""
    rng = np.random.default_rng(L)
    sk = np.sort(rng.integers(-dom, dom + 1, L) if dom else rng.integers(I64.min, I64.max, L))
    if extremes and L > 4:
        sk[:2], sk[-2:] = I64.min, I64.max
    is_build = rng.random(L) < 0.4
    pay = rng.integers(-(2**61), 2**61, L)
    order = np.lexsort((~is_build, sk))
    sk, is_build, pay = sk[order], is_build[order], pay[order]
    st = np.where(is_build, pay * 2 + 1, 0)
    got = per_element_model(sk, is_build, pay, PUBLISHED["some"])
    want = merge_scan.merge_scan_stats_plain(torch.from_numpy(sk), torch.from_numpy(st))
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    if not extremes:
        pos = rng.integers(0, 2**30, L)
        st = np.where(is_build, pos * 2 + 1, 0)
        got = per_element_model(sk, is_build, pos, PUBLISHED["none"])
        mult_e, psum_e = interpret(jax_scan, jnp.asarray(sk), jnp.asarray(st))
        np.testing.assert_array_equal(got[0][~is_build], np.asarray(mult_e)[~is_build])
        np.testing.assert_array_equal(got[1][~is_build], np.asarray(psum_e)[~is_build])


@pytest.mark.parametrize("pay_bits", [2, 31])
def test_packed_model(pay_bits):
    """The packed form's model per element equals the plain version and
    the JAX packed scan (interpret mode) at the narrowest and widest
    payload fields."""
    rng = np.random.default_rng(pay_bits)
    L = 6000
    key = rng.integers(0, 300, L)
    is_build = rng.random(L) < 0.5
    field = np.where(is_build, rng.integers(0, 2 ** (pay_bits - 1), L) * 2, (1 << pay_bits) - 1)
    s = np.sort((key << pay_bits) | field)
    f = s & ((1 << pay_bits) - 1)
    got = per_element_model(s >> pay_bits, (f & 1) == 0, f >> 1, PUBLISHED["some"])
    want = merge_scan.merge_scan_stats_packed_plain(torch.from_numpy(s), pay_bits)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    mult_e, psum_e = interpret(lambda x: jax_packed(x, pay_bits), jnp.asarray(s))
    probe = (f & 1) == 1
    np.testing.assert_array_equal(got[0][probe], np.asarray(mult_e)[probe])
    np.testing.assert_array_equal(got[1][probe], np.asarray(psum_e)[probe])
