"""A numpy model of the fused drain's level-by-level algorithm (the design
of csrc/drain.cu), held exactly against `drain_segment_plain` and, on a
few cases, against the JAX package's `drain_segment` in Pallas interpret
mode.

The depth-first walk of `drain_segment_plain` and the level-by-level
model compute the same thing because a level's cache changes only in that
level's steps, and those steps see the emissions of the level above in the
same order, (input, drain rank) lexicographically, in both. At one level
the compactor's algebra is a prefix sum modulo the block: a step that does
not pass through adds its kept rows behind the cache, and the cache fills
where the running sum crosses a multiple of the block. Every row at every
depth is an original row, of a chunk or of an incoming cache, so a row
travels as one int32 id and its mult at each level is gathered from the
chunk planes or the caches. The model walks the segment in windows of
chunks, as the kernel does where its scratch would be too large; the caches
carry from window to window.

The model is test code: the port's plain version stays
`drain_segment_plain`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.drain import drain_segment as jax_drain_segment
from ccve_tpu_torch.kernels import drain
from test_torch_drain import BLOCK, JAX_LANES, JAX_CASES, OCC_CASES, _inputs, _same_caches
from torch_interpret import interpret


def drain_levels(mults, counts, thresholds, cache_m, cache_cnt, *, block, fanouts,
                 record_occupancy=False, branchy=True, window=None):
    """`drain_segment`'s outputs (total, caches, cache counts, work, rows
    and, with `record_occupancy`, the histograms) from numpy inputs, level
    by level over windows of `window` chunks (default: the whole
    segment)."""
    S, L, B = mults.shape
    cache = cache_m.astype(np.int64)
    ccnt = [int(c) for c in cache_cnt]
    thr = [int(t) for t in thresholds]
    work = np.zeros(L, np.int64)
    rows = np.zeros(L, np.int64)
    occ = np.zeros((L, B + 1), np.int64)
    total = 0
    W = window or max(S, 1)
    lane = np.arange(B)
    for i0 in range(0, S, W):
        wm = mults[i0:i0 + W].astype(np.int64)
        n0 = wm.shape[0]
        flat, cflat = wm.reshape(-1), cache.reshape(-1)

        def value(ids, l2):
            """Plane l2 of rows by id: a chunk row j·L·B + lane (window
            relative) or cache row p of level l as ~(l·L·B + p)."""
            return np.where(ids >= 0, flat[np.maximum(ids, 0) + l2 * B],
                            cflat[np.maximum(~ids, 0) + l2 * B])

        cnt = counts[i0:i0 + n0].astype(np.int64)
        ids = np.arange(n0)[:, None] * L * B + lane  # [inputs, B] slots
        live = np.ones(n0, bool)
        cache_ids = {}
        work[0] += n0
        rows[0] += cnt.sum()
        for d in range(L):
            valid = lane < cnt[:, None]
            m = np.where(valid, value(ids, d), 0)
            if d == L - 1 and not record_occupancy:  # the count collapse
                total += int(m.sum())
                break
            f, th = fanouts[d], thr[d]
            kept = valid[:, None, :] & (m[:, None, :] > np.arange(f)[None, :, None])
            e = kept.sum(axis=2).reshape(-1)  # step s = input * f + t
            passthrough = (e >= th) | (e >= B)
            a = np.where(passthrough, 0, e)
            P = ccnt[d] + np.concatenate([[0], np.cumsum(a)[:-1]]).astype(np.int64)
            end = ccnt[d] + int(a.sum())
            full = end // B  # batches emitted at this level
            out = np.where(passthrough, e, np.where(P % B + e >= B, B, 0))
            emitter = {int(P[s] // B): s for s in np.flatnonzero(~passthrough & (out == B))}
            assert sorted(emitter) == list(range(full))
            step_live = np.repeat(live, f)
            np.add.at(occ[d], out[step_live], 1)
            work[d] += int((~passthrough).sum())
            if d == L - 1:  # the variant's last level: counts only
                total += int(out.sum())
                ccnt[d] = end % B
                break
            work[d + 1] += int((out > 0).sum())
            rows[d + 1] += int(out.sum())
            nxt = np.zeros((e.size, B), np.int64)
            cid = np.zeros(B, np.int64)
            for p in range(ccnt[d]):  # the incoming cache leads the line
                if full:
                    nxt[emitter[0], p] = ~(d * L * B + p)
                else:
                    cid[p] = ~(d * L * B + p)
            for s in np.flatnonzero(e):
                j, t = divmod(int(s), f)
                moved = ids[j][kept[j, t]]  # lane order
                if passthrough[s]:
                    nxt[s, : e[s]] = moved
                    continue
                for r, row in enumerate(moved):
                    p = int(P[s]) + r
                    if p // B < full:
                        nxt[emitter[p // B], p % B] = row
                    else:
                        cid[p % B] = row
            cache_ids[d] = cid
            ccnt[d] = end % B
            ids, cnt = nxt, out
            live = step_live & ((out > 0) | (not branchy))
        cache = cache.copy()
        for level, cid in cache_ids.items():
            for l2 in range(level + 1, L):
                cache[level, l2, : ccnt[level]] = value(cid[: ccnt[level]], l2)
    out = (total, cache, np.array(ccnt), work, rows)
    return out + (occ,) if record_occupancy else out


def _same(got, want, L):
    assert got[0] == want[0]
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
    _same_caches(got[1], want[1], got[2], L)


def _check_against_plain(arrays, fanouts, block, window=None, **occ):
    want = drain.drain_segment_plain(*(torch.from_numpy(a) for a in arrays), block=block,
                                     fanouts=fanouts, **occ)
    want = (int(want[0]),) + tuple(x.numpy() for x in want[1:])
    got = drain_levels(*arrays, block=block, fanouts=fanouts, window=window, **occ)
    _same(got, want, len(fanouts))
    return got


@pytest.mark.parametrize("case", range(len(JAX_CASES)))
def test_model_matches_plain_on_jax_cases(case):
    fanouts, thresholds, counts = JAX_CASES[case]
    arrays = _inputs(case, len(counts), fanouts, thresholds, counts=counts)
    assert _check_against_plain(arrays, fanouts, BLOCK)[0] > 0
    _check_against_plain(arrays, fanouts, BLOCK, window=1)


@pytest.mark.parametrize("case", range(len(OCC_CASES)))
def test_occupancy_model_matches_plain_on_jax_cases(case):
    fanouts, thresholds, counts, branchy = OCC_CASES[case]
    arrays = _inputs(50 + case, len(counts), fanouts, thresholds, counts=counts,
                     occupancy=True)
    for b in (branchy, not branchy):
        got = _check_against_plain(arrays, fanouts, BLOCK, record_occupancy=True, branchy=b)
        assert got[5].sum() > 0


@pytest.mark.parametrize("seed", range(24))
def test_model_matches_plain_random(seed):
    """Random (S, L, block, fanouts, thresholds, incoming caches), both
    modes, `branchy` on and off, and a random window."""
    rng = np.random.default_rng(300 + seed)
    L = int(rng.integers(1, 6))
    fanouts = tuple(int(f) for f in rng.integers(1, 4, L))
    while np.prod(fanouts[:-1]) > drain.MAX_PATHS:
        fanouts = tuple(max(f - 1, 1) for f in fanouts)
    block = int(rng.choice([64, 100, 128, 200]))
    thresholds = [int(rng.choice([0, block // 2, block, block + 5, int(rng.integers(1, block))]))
                  for _ in range(L)]
    S = int(rng.integers(0, 9))
    window = int(rng.integers(1, S + 1)) if S else None
    occupancy = bool(seed % 2)
    arrays = _inputs(seed, S, fanouts, thresholds, block=block, cache_fill=seed % 3 != 0,
                     occupancy=occupancy)
    kw = dict(record_occupancy=True, branchy=bool(seed % 4 == 1)) if occupancy else {}
    _check_against_plain(arrays, fanouts, block, window=window, **kw)


EDGE_CASES = [
    # (S, fanouts, block, thresholds)
    (0, (1, 2, 1), 128, (128, 0, 64)),  # no chunk
    (5, (1,), 128, (0,)),  # L = 1: the collapse alone
    (5, (3,), 100, (50,)),  # L = 1, a block that is no multiple of 32
    (6, (2, 1, 3), 100, (100, 33, 100)),
    (4, (1, 2, 1, 1, 2, 1), 256, (256,) * 6),  # phase 28's (6, 2048), cut
    (4, (1,) * 5, 512, (100,) * 5),  # (5, 4096), cut
    (4, (1,) * 9, 128, (0, 0, 0, 128, 0, 0, 64, 0, 0)),  # (9, 2048), cut
    (4, (2, 1), 1024, (1024, 1024)),  # (2, 8192), cut
]


@pytest.mark.parametrize("case", range(len(EDGE_CASES)))
@pytest.mark.parametrize("occupancy", [False, True])
def test_model_edge_shapes(case, occupancy):
    S, fanouts, block, thresholds = EDGE_CASES[case]
    counts = [block, block // 3, 0, block - 1, block, 7][:S]
    arrays = _inputs(700 + case, S, fanouts, thresholds, counts=counts, block=block,
                     occupancy=occupancy)
    kw = dict(record_occupancy=True, branchy=case % 2 == 0) if occupancy else {}
    _check_against_plain(arrays, fanouts, block, **kw)
    if S > 1:
        _check_against_plain(arrays, fanouts, block, window=S - 1, **kw)


@pytest.mark.parametrize("occupancy", [False, True])
def test_model_matches_jax_kernel(occupancy):
    """The model against the JAX kernel (planes padded to its 1024 lanes
    and cropped), FULL at fanouts (2, 2, 2) with incoming caches."""
    fanouts, thresholds, counts = (2, 2, 2), (BLOCK, BLOCK // 2, BLOCK), [128, 0, 77, 128, 13]
    L = len(fanouts)
    arrays = _inputs(900 + occupancy, len(counts), fanouts, thresholds, counts=counts,
                     occupancy=occupancy)
    mults, cnt, thr, cache_m, cache_cnt = arrays
    pad = ((0, 0), (0, 0), (0, JAX_LANES - BLOCK))
    kw = dict(record_occupancy=True, branchy=False) if occupancy else {}
    out = interpret(
        lambda m, c, t, cm, cc: jax_drain_segment(m, c, t, cm, cc, block=BLOCK, fanouts=fanouts,
                                                  interpret=True, **kw),
        jnp.asarray(np.pad(mults, pad)), jnp.asarray(cnt), jnp.asarray(thr),
        jnp.asarray(np.pad(cache_m, pad)), jnp.asarray(cache_cnt),
    )
    out = [np.asarray(x) for x in out]
    w_cache = out[1].reshape(cache_m.shape[0], L, JAX_LANES)[:, :, :BLOCK]
    want = (int(out[0][0, 0]), w_cache, out[2][:, 0], out[3][:, 0], out[4][:, 0])
    if occupancy:
        want += (np.concatenate([out[5].reshape(L, JAX_LANES)[:, :BLOCK], out[6]], axis=1),)
    got = drain_levels(*arrays, block=BLOCK, fanouts=fanouts, window=2, **kw)
    _same(got, want, L)
    assert got[0] > 0
