"""A model in numpy of #17's schedule (csrc/ce_stages.cu,
`ce_stages_i32`), held exactly against the port's plain version
(`ce_stages_plain`) and the JAX package's `make_ce_kernel` in Pallas
interpret mode.

A block of THREADS threads owns a tile of 2^13 keys, kept in shared memory
as its GROUPS aligned groups of 8 keys, each group as two 16-byte halves
in two arrays: `tile[0][g]` holds keys 8g..8g+3, `tile[1][g]` keys
8g+4..8g+7. The groups come in chunks of 32; with the chunks rotated by
`rot`, warp w takes chunks 8j + ((w + rot) & 7), j = 0..3, and lane l
group 32c + l of chunk c. Stage s rotates by s: each thread loads both
halves of its 4 groups, compare-exchanges them at stride 1 << (s % 3) and
stores both back; then a barrier. The copies from and to device memory
rotate by -1 (in) and K (out), two copies of 16 groups a chunk: lane l
takes half (l >> 3) & 1 of group 16 * (2c + b) + 8 * (l >> 4) + (l & 7),
which is the tile's 16-byte word 2g + h in device memory.

What the tests hold: every half is loaded and stored once a stage; each
16-byte shared-memory access of a quarter-warp covers 128 contiguous bytes
of one array (all 32 banks once: no conflict), in the stages and in the
copies, whose warps also cover 512 contiguous bytes of device memory; each
thread reads halves that another warp stored in the stage before (the
copy in, before stage 0); and the model's result is the plain version's
and JAX's.
"""

import numpy as np
import pytest
import torch

from ccve_tpu_torch.kernels.ce_stages import TILE_LOG, ce_stages_i32, ce_stages_plain
from test_torch_roofline import _jax_ce_stages

THREADS = 256  # ce_stages.cu: kThreads
WARP = 32
WARPS = THREADS // WARP
TILE = 1 << TILE_LOG
GROUPS = TILE // 8  # kGroups
CHUNKS_A_WARP = GROUPS // 32 // WARPS  # kChunksPerWarp
BANK_BYTES, BANKS = 4, 32
HALF_BYTES = 16
PHASE = 8  # lanes a shared-memory phase of a 16-byte access: a quarter-warp

THREAD = np.arange(THREADS)
WARP_OF, LANE_OF = THREAD // WARP, THREAD % WARP


def stage_groups(rot: int, j: int) -> np.ndarray:
    """[THREADS] groups of `group_of(warp, lane, rot, j)`."""
    return 32 * (WARPS * j + ((WARP_OF + rot) & (WARPS - 1))) + LANE_OF


def copy_halves(rot: int, j: int, b: int) -> tuple[np.ndarray, np.ndarray]:
    """([THREADS] halves h, [THREADS] groups g) of `copy_tile`'s copy (j, b)."""
    h = (LANE_OF >> 3) & 1
    c = WARPS * j + ((WARP_OF + rot) & (WARPS - 1))
    return h, 32 * c + 16 * b + 8 * (LANE_OF >> 4) + (LANE_OF & 7)


def stage_accesses(rot: int):
    """[(h, groups)] of a stage's shared-memory instructions, in order: per
    j the loads of tile[0] and tile[1], then their stores."""
    return [(h, stage_groups(rot, j)) for j in range(CHUNKS_A_WARP) for h in (0, 1)]


def copy_accesses(rot: int):
    return [copy_halves(rot, j, b) for j in range(CHUNKS_A_WARP) for b in (0, 1)]


def ce_group(lo: np.ndarray, hi: np.ndarray, k: int) -> None:
    """`ce_group` in place on [n, 4] halves."""
    if k == 4:
        a, b = lo.copy(), hi.copy()
        lo[:], hi[:] = np.minimum(a, b), np.maximum(a, b)
        return
    for half in (lo, hi):
        pairs = ((0, 1), (2, 3)) if k == 1 else ((0, 2), (1, 3))
        for i, p in pairs:
            a, b = half[:, i].copy(), half[:, p].copy()
            half[:, i], half[:, p] = np.minimum(a, b), np.maximum(a, b)


def model(x: np.ndarray, n_stages: int) -> np.ndarray:
    """The kernel's result on int32 x, tile by tile, by the schedule."""
    out = np.empty_like(x)
    for base in range(0, x.size, TILE):
        words = x[base:base + TILE].reshape(-1, 4)  # the tile's 16-byte words
        tile = np.full((2, GROUPS, 4), -1, np.int32)
        for h, g in copy_accesses(-1):
            tile[h, g] = words[2 * g + h]
        k = 1
        for s in range(n_stages):
            for j in range(CHUNKS_A_WARP):
                g = stage_groups(s & (WARPS - 1), j)
                lo, hi = tile[0, g], tile[1, g]
                ce_group(lo, hi, k)
                tile[0, g], tile[1, g] = lo, hi
            k = 1 if k == 4 else 2 * k
        done = np.full_like(words, -1)
        for h, g in copy_accesses(n_stages & (WARPS - 1)):
            done[2 * g + h] = tile[h, g]
        out[base:base + TILE] = done.reshape(-1)
    return out


@pytest.mark.parametrize("rot", range(WARPS))
def test_every_half_once_a_stage(rot):
    """A stage loads each of the 2 x GROUPS halves once (and stores each
    once, at the same addresses); so do the copies in and out."""
    for accesses in (stage_accesses(rot), copy_accesses(rot)):
        seen = np.zeros((2, GROUPS), int)
        for h, g in accesses:
            np.add.at(seen, (np.broadcast_to(h, g.shape), g), 1)
        assert (seen == 1).all()


@pytest.mark.parametrize("rot", range(WARPS))
@pytest.mark.parametrize("what", ["stage", "copy"])
def test_no_bank_conflicts(rot, what):
    """Each 16-byte access instruction of each quarter-warp covers 128
    contiguous bytes, 128-byte aligned, of one shared array: its 8 lanes
    fall on all 32 banks once. (tile[1] starts 16 KB after tile[0], a
    multiple of 128 bytes, so both arrays map to the banks alike.)"""
    accesses = stage_accesses(rot) if what == "stage" else copy_accesses(rot)
    for h, g in accesses:
        h = np.broadcast_to(h, g.shape)
        addr = (h * GROUPS + g) * HALF_BYTES  # byte offsets in the block's shared memory
        for start in range(0, THREADS, PHASE):
            phase = addr[start:start + PHASE]
            assert phase.min() % 128 == 0 and np.array_equal(
                np.sort(phase), phase.min() + HALF_BYTES * np.arange(PHASE))
            banks = (phase[:, None] + BANK_BYTES * np.arange(4)) // BANK_BYTES % BANKS
            assert np.array_equal(np.sort(banks.ravel()), np.arange(BANKS))


@pytest.mark.parametrize("rot", range(WARPS))
def test_copies_are_coalesced(rot):
    """Each warp's copy instruction moves 32 halves: 512 contiguous bytes
    of the tile in device memory (the word 2g + h is bytes 16(2g + h))."""
    for h, g in copy_accesses(rot):
        word = 2 * g + h
        for w in range(WARPS):
            mine = word[w * WARP:(w + 1) * WARP]
            assert mine.min() % WARP == 0
            assert np.array_equal(np.sort(mine), mine.min() + np.arange(WARP))


@pytest.mark.parametrize("n_stages", [1, 2, 3, 8, 9, 64])
def test_each_thread_reads_what_another_warp_stored(n_stages):
    """At every stage each thread's halves were stored in the stage before
    (at stage 0 by the copy in) by a thread of another warp."""
    writer = np.full((2, GROUPS), -1)
    for h, g in copy_accesses(-1):
        writer[np.broadcast_to(h, g.shape), g] = WARP_OF
    for s in range(n_stages):
        now = np.full((2, GROUPS), -1)
        for h, g in stage_accesses(s & (WARPS - 1)):
            assert (writer[h, g] != WARP_OF).all(), s
            now[h, g] = WARP_OF
        assert (now >= 0).all()
        writer = now


@pytest.mark.parametrize("n_tiles", [1, 2, 3])
@pytest.mark.parametrize("n_stages", [*range(8), 16, 64])
def test_model_is_the_plain_version_and_jax(n_tiles, n_stages):
    rng = np.random.default_rng(100 * n_tiles + n_stages)
    x = rng.integers(-(2**31), 2**31 - 1, n_tiles * TILE, dtype=np.int64).astype(np.int32)
    got = model(x, n_stages)
    plain = ce_stages_plain(torch.from_numpy(x), n_stages).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(ce_stages_i32(torch.from_numpy(x), n_stages).numpy(), plain)
    np.testing.assert_array_equal(got, _jax_ce_stages(x, n_stages))


def test_model_keeps_ties_and_extremes():
    """Runs of equal keys and both int32 extremes, at every stride."""
    x = np.tile(np.array([2**31 - 1, -(2**31), 5, 5, -(2**31), 0, 2**31 - 1, 5], np.int32),
                TILE // 8)
    for n_stages in (1, 2, 3, 5):
        np.testing.assert_array_equal(
            model(x, n_stages), ce_stages_plain(torch.from_numpy(x), n_stages).numpy())
