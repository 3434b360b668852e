"""A model in numpy of #9's CUDA design (csrc/compact.cu), held exactly
against the port's plain version (`compact_plain`).

One launch: each block takes a tile of TILE = 256 threads x 32 rows; a
thread reads its 32 mask bytes as two 16-byte words and keeps one bit a
nonzero byte; a warp scan of the threads' popcounts and the warps' totals
rank each kept row in the tile; the tile's offset `excl` is the rows kept
before it, found by a look-back over windows of 256 tiles (each tile
publishes its count, then its inclusive prefix, in one 8-byte word with
its state; each warp sums its lanes' counts up to its nearest inclusive
prefix, the warps' sums are folded up to the nearest warp that met one);
each staged plane is
compacted in place (striped rows to their ranks) and written to [excl,
excl + cnt); the tile's u zeros go to [n - U - u, n - U), U = tile0 - excl
the unselected rows before it; the last tile writes the count.
"""

import numpy as np
import pytest
import torch

from ccve_tpu_torch.kernels import compact

THREADS, ITEMS = 256, 32  # compact.cu: kThreads, kItems
TILE = THREADS * ITEMS
WARP = 32
AGGREGATE, PREFIX = 1, 2  # compact.cu's published states


def nonzero_bytes(w: int) -> int:
    """compact.cu's nonzero_bytes: a bit a nonzero byte of a 32-bit word,
    in byte order."""
    return sum(1 << k for k in range(4) if (w >> (8 * k)) & 0xFF)


def thread_bits(mask_bytes: np.ndarray, t: int, rows: int) -> int:
    """Thread t's kept rows [32t, 32t + 32) of its tile as bits, read as the
    kernel reads them: 16-byte words of four little-endian 32-bit lanes
    where the thread's rows are whole, byte by byte at the tile's end."""
    r0 = t * ITEMS
    m = mask_bytes[r0:r0 + ITEMS]
    if r0 + ITEMS <= rows:
        words = m.view("<u4")
        bits = 0
        for q in range(ITEMS // 16):
            x, y, z, w = (int(v) for v in words[4 * q:4 * q + 4])
            bits |= (nonzero_bytes(x) | nonzero_bytes(y) << 4 | nonzero_bytes(z) << 8
                     | nonzero_bytes(w) << 12) << (16 * q)
        return bits
    return sum(1 << k for k in range(max(min(ITEMS, rows - r0), 0)) if m[k])


def tile_ranks(mask_bytes: np.ndarray):
    """(cnt, slot[e] for the tile's rows e, -1 where not kept): the warp
    scan of the threads' popcounts plus the totals of the warps before."""
    rows = mask_bytes.size
    bits = [thread_bits(mask_bytes, t, rows) for t in range(THREADS)]
    own = [bin(b).count("1") for b in bits]
    warp_total = [sum(own[w * WARP:(w + 1) * WARP]) for w in range(THREADS // WARP)]
    own_rank = []
    for t in range(THREADS):
        warp, lane = divmod(t, WARP)
        incl = sum(own[warp * WARP:warp * WARP + lane + 1])  # the shuffle scan
        own_rank.append(sum(warp_total[:warp]) + incl - own[t])
    # striped row e of thread e // ITEMS, bit e % ITEMS: its thread's rank
    # plus the kept rows before it in the thread
    bit = np.array([[b >> k & 1 for k in range(ITEMS)] for b in bits]).reshape(-1)
    before = (np.cumsum(bit.reshape(THREADS, ITEMS), axis=1) - bit.reshape(THREADS, ITEMS))
    slot = np.repeat(own_rank, ITEMS) + before.reshape(-1)
    slot[bit == 0] = -1
    slot[rows:] = -1
    return sum(warp_total), slot


def look_back(tile, state, agg, incl):
    """compact.cu's look_back of `tile` (> 0) over a snapshot of the tiles'
    states (none of those before it NONE)."""
    prefix = 0
    hi = tile - 1
    while True:
        v, met = [], []
        for t in range(THREADS):
            j = hi - t
            s = PREFIX if j < 0 else state[j]
            v.append(0 if j < 0 else incl[j] if s == PREFIX else agg[j])
            met.append(s == PREFIX)
        done = False
        for w in range(THREADS // WARP):
            lanes = met[w * WARP:(w + 1) * WARP]
            stop = lanes.index(True) if any(lanes) else WARP - 1
            prefix += sum(v[w * WARP:w * WARP + stop + 1])
            if any(lanes):
                done = True
                break
        if done:
            return prefix
        hi -= THREADS


def compact_model(planes: np.ndarray, mask: np.ndarray, rng, prefix_share=0.2):
    """(out, count) as the kernel writes them, the tiles' look-backs
    against random snapshots of their predecessors' states (each has
    published its count, and its prefix with probability prefix_share)."""
    n_planes, n = planes.shape
    out = np.full((n_planes, n), 0x5A5A5A5A, np.int64)  # garbage: every slot is written
    written = np.zeros((n_planes, n), int)
    n_tiles = -(-n // TILE)
    ranks = [tile_ranks(mask[i * TILE:(i + 1) * TILE].view(np.uint8)) for i in range(n_tiles)]
    cnts = [c for c, _ in ranks]
    true_incl = np.cumsum(cnts)
    count = None
    for tile in range(n_tiles):
        state = [PREFIX if j == 0 or rng.random() < prefix_share else AGGREGATE
                 for j in range(tile)]
        excl = look_back(tile, state, cnts, true_incl) if tile else 0
        assert excl == (true_incl[tile - 1] if tile else 0)
        cnt, slot = ranks[tile]
        tile0 = tile * TILE
        rows = min(TILE, n - tile0)
        u = rows - cnt
        zeros0 = n - (tile0 - excl) - u
        kept = np.flatnonzero(slot[:rows] >= 0)
        for p in range(n_planes):
            s = planes[p, tile0:tile0 + rows].astype(np.int64)
            s[slot[kept]] = s[kept]  # in place: every kept row read, a barrier, then written
            out[p, excl:excl + cnt] = s[:cnt]
            out[p, zeros0:zeros0 + u] = 0
            written[p, excl:excl + cnt] += 1
            written[p, zeros0:zeros0 + u] += 1
        if tile == n_tiles - 1:
            count = excl + cnt
    assert (written == 1).all()  # the kept ranges and the zero ranges tile [0, n)
    return out.astype(np.int32), count


def _mask(rng, n, kind):
    return {"all": np.ones(n, bool), "none": np.zeros(n, bool),
            "alternating": np.arange(n) % 2 == 1, "random": rng.random(n) < 0.4,
            "sparse": rng.random(n) < 0.001,
            "runs": np.repeat(rng.random(n // 3000 + 1) < 0.5, 3000)[:n]}[kind]


@pytest.mark.parametrize("n", [1, 31, 33, 4096, TILE - 1, TILE, TILE + 1, 3 * TILE + 517])
@pytest.mark.parametrize("kind", ["all", "none", "alternating", "random", "sparse", "runs"])
def test_compact_model_equals_plain(n, kind):
    rng = np.random.default_rng(n)
    n_planes = 1 + n % 3
    planes = rng.integers(-(2**31), 2**31 - 1, (n_planes, n)).astype(np.int32)
    mask = _mask(rng, n, kind)
    got, count = compact_model(planes, mask, rng)
    want, want_count = compact.compact_plain(torch.from_numpy(planes), torch.from_numpy(mask))
    assert count == int(want_count) == int(mask.sum())
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("n_planes", [1, 3])
def test_compact_model_many_tiles(n_planes):
    """Look-backs that cross more than one window of 256 tiles."""
    rng = np.random.default_rng(n_planes)
    n = 300 * TILE + 77
    planes = rng.integers(-50, 50, (n_planes, n)).astype(np.int32)
    mask = rng.random(n) < 0.7
    got, count = compact_model(planes, mask, rng, prefix_share=0.002)
    want, want_count = compact.compact_plain(torch.from_numpy(planes), torch.from_numpy(mask))
    assert count == int(want_count)
    np.testing.assert_array_equal(got, want.numpy())


def test_look_back_finds_the_nearest_prefix():
    """The window's fold stops at the nearest prefix, in whichever warp of
    whichever window it lies, and counts the aggregates nearer than it."""
    rng = np.random.default_rng(4)
    cnts = rng.integers(0, 9, 1000)
    incl = np.cumsum(cnts)
    for tile, prefix_at in ((1, 0), (40, 3), (40, 39), (300, 0), (300, 44), (700, 2), (999, 998)):
        state = [AGGREGATE] * tile
        state[0] = PREFIX
        state[prefix_at] = PREFIX
        assert look_back(tile, state, cnts, incl) == incl[tile - 1]


def test_mask_words_keep_byte_order():
    """A thread's bits from its 16-byte words equal its bytes' order, for
    bool bytes and for any nonzero byte."""
    rng = np.random.default_rng(1)
    m = (rng.random(TILE) < 0.5).astype(np.uint8) * rng.integers(1, 256, TILE).astype(np.uint8)
    for t in (0, 1, 100, THREADS - 1):
        bits = thread_bits(m, t, TILE)
        want = [int(b != 0) for b in m[t * ITEMS:(t + 1) * ITEMS]]
        assert [bits >> k & 1 for k in range(ITEMS)] == want
