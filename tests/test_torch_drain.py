"""The fused drain's plain version (`drain_segment_plain`, on the CPU)
against the JAX package's `drain_segment` in Pallas interpret mode, and
against a replay of the sorted executor's count algebra through
`ops.compactor`, with and without the occupancy variant's histograms.
Exact: totals, counters, histograms and caches are integers. Only a
cache's live prefix of its planes l2 > l is defined, so only that is
compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.drain import drain_segment as jax_drain_segment
from ccve_tpu_torch.core.chunk import Chunk, compact_rows, iota_sel
from ccve_tpu_torch.kernels import drain
from ccve_tpu_torch.ops import compactor as comp
from torch_interpret import interpret

BLOCK = 128
JAX_LANES = 1024  # the JAX kernel's planes: max(block / 128, 8) x 128 lanes


def _inputs(seed, S, fanouts, thresholds, counts=None, cache_fill=True, block=BLOCK,
            occupancy=False):
    """int32 numpy inputs: mults at each level in [0, fanout] (the last
    level's up to 5), chunk counts (random unless given) and caches with a
    random live prefix (with `occupancy`, one count more: the last level's
    count-only cache)."""
    rng = np.random.default_rng(seed)
    L = len(fanouts)
    CL = max(L - 1, 1)
    highs = list(fanouts[:-1]) + [5]
    mults = np.stack([rng.integers(0, h + 1, (S, block)) for h in highs], axis=1)
    if counts is None:
        counts = rng.integers(0, block + 1, S)
    cache_m = rng.integers(0, max(highs) + 1, (CL, L, block))
    CC = L if occupancy else CL
    cache_cnt = rng.integers(0, block, CC) if cache_fill else np.zeros(CC, np.int64)
    if L == 1 and not occupancy:
        cache_cnt[:] = 0
    as32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    return (as32(mults), as32(counts), as32(thresholds), as32(cache_m), as32(cache_cnt))


def _plain(arrays, fanouts, block=BLOCK, **occ):
    t = [torch.from_numpy(a) for a in arrays]
    out = drain.drain_segment(*t, block=block, fanouts=fanouts, **occ)
    return (int(out[0]),) + tuple(x.numpy() for x in out[1:])


def _same_caches(got, want, ccnt, L):
    for level in range(L - 1):
        live = int(ccnt[level])
        for l2 in range(level + 1, L):
            np.testing.assert_array_equal(got[level, l2, :live], want[level, l2, :live],
                                          err_msg=f"cache {level} plane {l2}")


JAX_CASES = [
    # (fanouts, thresholds, counts)
    ((1,), (0,), [BLOCK, 0, 77]),
    ((1, 1), (64, 64), [128, 5, 60, 0, 128, 31]),  # BINARY
    ((2, 2, 2), (BLOCK, BLOCK, BLOCK), [128, 0, 77, 128]),  # FULL
    ((3, 1, 2, 1), (0, BLOCK, 64, 0), [128, 100, 0, 3, 128]),  # mixed
]


@pytest.mark.parametrize("case", range(len(JAX_CASES)))
def test_plain_matches_jax_kernel(case):
    fanouts, thresholds, counts = JAX_CASES[case]
    S, L = len(counts), len(fanouts)
    arrays = _inputs(case, S, fanouts, thresholds, counts=counts)
    mults, cnt, thr, cache_m, cache_cnt = arrays
    pad = ((0, 0), (0, 0), (0, JAX_LANES - BLOCK))
    out = interpret(
        lambda m, c, t, cm, cc: jax_drain_segment(m, c, t, cm, cc, block=BLOCK,
                                                  fanouts=fanouts, interpret=True),
        jnp.asarray(np.pad(mults, pad)), jnp.asarray(cnt), jnp.asarray(thr),
        jnp.asarray(np.pad(cache_m, pad)), jnp.asarray(cache_cnt),
    )
    w_total, w_cache, w_ccnt, w_work, w_rows = (np.asarray(x) for x in out)
    w_cache = w_cache.reshape(cache_m.shape[0], L, JAX_LANES)[:, :, :BLOCK]
    total, cache, ccnt, work, rows = _plain(arrays, fanouts)
    assert total == int(w_total[0, 0]) > 0
    np.testing.assert_array_equal(ccnt, w_ccnt[:, 0])
    np.testing.assert_array_equal(work, w_work[:, 0])
    np.testing.assert_array_equal(rows, w_rows[:, 0])
    _same_caches(cache, w_cache, ccnt, L)


def _replay(arrays, fanouts, block=BLOCK, record_occupancy=False, branchy=True):
    """The count algebra of the sorted executor's `_run_tree`, chunk by
    chunk through `ops.compactor.compact`: the same outputs as
    `drain_segment`, the recursion entering empty emissions as the JAX
    kernel does (so their compactions count as work, and, unless `branchy`
    cuts the subtree, their emissions are recorded at 0). With
    `record_occupancy` the last level compacts a count-only cache."""
    mults, counts, thresholds, cache_m, cache_cnt = (torch.from_numpy(a).long() for a in arrays)
    S, L, B = mults.shape
    caches = [comp.CompactorState(cache_m[lv].clone(), int(cache_cnt[lv]))
              for lv in range(max(L - 1, 1))]
    if record_occupancy:
        caches = caches[: L - 1] + [comp.CompactorState(torch.zeros(L, B, dtype=torch.long),
                                                        int(cache_cnt[L - 1]))]
    work, rows, total = [0] * L, [0] * L, 0
    occ = np.zeros((L, B + 1), np.int64)
    lane = torch.arange(B)

    def run(level, cols, count, live):
        nonlocal total
        if level == L - 1 and not record_occupancy:
            total += int(torch.where(lane < count, cols[level], 0).sum())
            return
        for t in range(fanouts[level]):
            dense, cnt = compact_rows(cols, (lane < count) & (cols[level] > t))
            chunk = Chunk(dense, iota_sel(B, "cpu"), cnt)
            thr = int(thresholds[level])
            passthrough = cnt >= thr or cnt >= B
            emitted, caches[level] = comp.compact(caches[level], chunk, thr, chunk_dense=True)
            work[level] += 0 if passthrough else 1
            if record_occupancy and live:
                occ[level, emitted.count] += 1
            if level == L - 1:
                total += emitted.count
                continue
            work[level + 1] += 1 if emitted.count else 0
            rows[level + 1] += emitted.count
            run(level + 1, emitted.cols, emitted.count,
                live and (emitted.count > 0 or not branchy))

    for i in range(S):
        work[0] += 1
        rows[0] += int(counts[i])
        run(0, mults[i], int(counts[i]), True)
    cache = torch.stack([c.cache_cols for c in caches[: max(L - 1, 1)]]).numpy()
    ccnt = np.array([c.cache_count for c in caches])
    out = (total, cache, ccnt, np.array(work), np.array(rows))
    return out + (occ,) if record_occupancy else out


@pytest.mark.parametrize("seed", range(8))
def test_plain_matches_compactor_replay(seed):
    rng = np.random.default_rng(100 + seed)
    L = int(rng.integers(1, 6))
    fanouts = tuple(int(f) for f in rng.integers(1, 4, L))
    block = int(rng.choice([128, 256]))
    thresholds = [int(rng.choice([0, block // 2, block, int(rng.integers(1, block))]))
                  for _ in range(L)]
    S = int(rng.integers(1, 7))
    arrays = _inputs(seed, S, fanouts, thresholds, cache_fill=bool(seed % 2), block=block)
    got = _plain(arrays, fanouts, block)
    want = _replay(arrays, fanouts, block)
    assert got[0] == want[0]
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
    _same_caches(got[1], want[1], got[2], L)


@pytest.mark.parametrize("seed", range(6))
def test_occupancy_plain_matches_compactor_replay(seed):
    rng = np.random.default_rng(200 + seed)
    L = int(rng.integers(1, 5))
    fanouts = tuple(int(f) for f in rng.integers(1, 4, L))
    block = int(rng.choice([128, 256]))
    thresholds = [int(rng.choice([0, block // 2, block, int(rng.integers(1, block))]))
                  for _ in range(L)]
    S = int(rng.integers(1, 7))
    kw = dict(record_occupancy=True, branchy=bool(seed % 2))
    arrays = _inputs(seed, S, fanouts, thresholds, cache_fill=seed % 3 != 0, block=block,
                     occupancy=True)
    got = _plain(arrays, fanouts, block, **kw)
    want = _replay(arrays, fanouts, block, **kw)
    assert got[0] == want[0]
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
    _same_caches(got[1], want[1], got[2], L)
    assert got[5].sum() > 0


OCC_CASES = [
    # (fanouts, thresholds, counts, branchy)
    ((2, 3), (0, 0), [128, 0, 77, 128], True),  # NONE
    ((2, 2, 2), (BLOCK, BLOCK, BLOCK), [128, 0, 77, 128, 13], False),  # FULL
    ((3, 1, 2), (BLOCK // 2, BLOCK, 0), [128, 100, 0, 3, 128], True),  # mixed
]


@pytest.mark.parametrize("case", range(len(OCC_CASES)))
def test_occupancy_plain_matches_jax_kernel(case):
    """The occupancy variant against the JAX kernel's record_occupancy mode
    (planes padded to its 1024 lanes and cropped): histograms bin for bin
    (occ_full as the last column), total, counts, work, rows, caches."""
    fanouts, thresholds, counts, branchy = OCC_CASES[case]
    S, L = len(counts), len(fanouts)
    arrays = _inputs(50 + case, S, fanouts, thresholds, counts=counts, occupancy=True)
    mults, cnt, thr, cache_m, cache_cnt = arrays
    pad = ((0, 0), (0, 0), (0, JAX_LANES - BLOCK))
    out = interpret(
        lambda m, c, t, cm, cc: jax_drain_segment(m, c, t, cm, cc, block=BLOCK, fanouts=fanouts,
                                                  interpret=True, record_occupancy=True,
                                                  branchy=branchy),
        jnp.asarray(np.pad(mults, pad)), jnp.asarray(cnt), jnp.asarray(thr),
        jnp.asarray(np.pad(cache_m, pad)), jnp.asarray(cache_cnt),
    )
    w_total, w_cache, w_ccnt, w_work, w_rows, w_occ, w_occf = (np.asarray(x) for x in out)
    w_cache = w_cache.reshape(cache_m.shape[0], L, JAX_LANES)[:, :, :BLOCK]
    w_hist = np.concatenate([w_occ.reshape(L, JAX_LANES)[:, :BLOCK], w_occf], axis=1)
    total, cache, ccnt, work, rows, occ = _plain(arrays, fanouts, record_occupancy=True,
                                                 branchy=branchy)
    assert total == int(w_total[0, 0]) > 0
    np.testing.assert_array_equal(occ, w_hist)
    np.testing.assert_array_equal(ccnt, w_ccnt[:, 0])
    np.testing.assert_array_equal(work, w_work[:, 0])
    np.testing.assert_array_equal(rows, w_rows[:, 0])
    _same_caches(cache, w_cache, ccnt, L)
    assert occ.sum() > 0
    if thresholds[0] == BLOCK:  # FULL emits full caches: the occ_full column
        assert occ[:, BLOCK].sum() > 0


def test_limits_raise():
    """The shapes PR 5's drain refused (more than 8 levels, blocks over
    4096, caches past shared memory) run and equal the replay, with and
    without the histograms; only more than 64 drain paths, a bad fanout and
    bad types or shapes raise."""
    def call(L, block, fanouts, S=1):
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32)  # noqa: E731
        CL = max(L - 1, 1)
        drain.drain_segment(z(S, L, block), z(S), z(L), z(CL, L, block), z(CL),
                            block=block, fanouts=fanouts)

    for L, block, fanouts, thr in ((6, 2048, (1, 2, 1, 1, 2, 1), 2048), (5, 4096, (1,) * 5, 100),
                                   (9, 128, (1,) * 9, 128), (2, 8192, (2, 1), 8192),
                                   (9, 2048, (1,) * 9, [0, 0, 0, 2048, 0, 0, 1024, 0, 0])):
        counts = [block, block // 3, 0, block - 1]
        for occupancy in (False, True):
            kw = dict(record_occupancy=True) if occupancy else {}
            arrays = _inputs(L + block, len(counts), fanouts,
                             thr if isinstance(thr, list) else [thr] * L, counts=counts,
                             block=block, occupancy=occupancy)
            got = _plain(arrays, fanouts, block, **kw)
            want = _replay(arrays, fanouts, block, **kw)
            assert got[0] == want[0] and got[4][1:].sum() > 0, (L, block)
            for g, w in zip(got[2:], want[2:]):
                np.testing.assert_array_equal(g, w, err_msg=f"L={L} block={block}")
            _same_caches(got[1], want[1], got[2], L)
    with pytest.raises(ValueError, match="drain paths"):
        call(3, 128, (8, 9, 1))
    with pytest.raises(ValueError, match="fanouts"):
        call(2, 128, (0, 1))
    with pytest.raises(ValueError, match="cache_cnt"):
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32)  # noqa: E731
        drain.drain_segment(z(1, 2, 128), z(1), z(2), z(1, 2, 128), z(1), block=128,
                            fanouts=(1, 1), record_occupancy=True)  # needs L counts
    with pytest.raises(TypeError):
        drain.drain_segment(torch.zeros((1, 1, 128), dtype=torch.int64),
                            *(torch.zeros(s, dtype=torch.int32) for s in ((1,), (1,), (1, 1, 128), (1,))),
                            block=128, fanouts=(1,))
