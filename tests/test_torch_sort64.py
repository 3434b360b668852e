"""The port's int64 sort ladder (plain versions, on the CPU) against the JAX
package's `pairsort.pallas_sort_i64_limbs` in Pallas interpret mode, with
the tile shrunk to 2^10 on both sides and the ladder stopped early
(`n_levels_cap`), and against numpy. Tolerance 0: keys are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.pairsort import pallas_sort_i64_limbs
from ccve_tpu_torch.kernels import bigsort
from torch_interpret import interpret

TILE_LOG = 10
I64_MAX = 2**63 - 1


def _keys(rng, n, dom=None):
    """int64 keys strictly inside (INT64_MIN, INT64_MAX), the JAX limb
    ladder's sentinels: half near ±2^62, half over the range; or [0, dom)."""
    if dom is not None:
        return rng.integers(0, dom, n, dtype=np.int64)
    keys = rng.integers(-(2**63) + 1, 2**63 - 1, n, dtype=np.int64)
    near = rng.random(n) < 0.5
    k = int(near.sum())
    keys[near] = rng.integers(2**62 - 40, 2**62 + 40, k) * rng.choice([-1, 1], k)
    return keys


def _from_limbs(hi, lo):
    return (np.asarray(hi).astype(np.int64) << 32) | (np.asarray(lo).astype(np.int64) & 0xFFFFFFFF)


@pytest.mark.parametrize("n, cap", [(1000, 0), (3000, 0), (3000, 1), (4096, 1)])
def test_sort_runs_i64_matches_jax_limb_ladder(n, cap):
    rng = np.random.default_rng(n + cap)
    x = _keys(rng, n)
    hi, lo, run_log = interpret(
        lambda a: pallas_sort_i64_limbs(a, tile_log=TILE_LOG, n_levels_cap=cap), jnp.asarray(x))
    run_log = int(run_log)
    want = _from_limbs(hi, lo)
    n_pad = want.size
    padded = np.concatenate([x, np.full(n_pad - n, I64_MAX)])  # JAX pads the same way
    got = bigsort.sort_runs(torch.from_numpy(padded), run_log, TILE_LOG)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nt", [1, 2, 3, 5, 13])
@pytest.mark.parametrize("dom", [None, 3])
def test_sort_runs_i64_every_cap(nt, dom):
    """Runs of 2^run_log, each the sorted values of its positions,
    INT64_MIN and INT64_MAX included."""
    rng = np.random.default_rng(nt)
    tile_log = 6
    x = _keys(rng, nt << tile_log, dom)
    if dom is None:
        x[::7] = -(2**63)
        x[3::11] = I64_MAX
    for run_log in range(tile_log, tile_log + 6):
        got = bigsort.sort_runs(torch.from_numpy(x), run_log, tile_log).numpy()
        plain = bigsort.sort_runs_plain(torch.from_numpy(x), run_log, tile_log).numpy()
        np.testing.assert_array_equal(got, plain)
        run = 1 << run_log
        for s in range(0, x.size, run):
            np.testing.assert_array_equal(got[s : s + run], np.sort(x[s : s + run]))


@pytest.mark.parametrize("n", [0, 1, 5, 64, 100, 2049])
def test_merge_level_i64_ragged(n):
    rng = np.random.default_rng(n)
    x = _keys(rng, n)
    runs = torch.from_numpy(x)  # runs of one value are sorted
    for run_log in range(13):
        runs = bigsort.merge_level_i64(runs, run_log)
        pair = 2 << run_log
        for s in range(0, n, pair):
            np.testing.assert_array_equal(runs.numpy()[s : s + pair], np.sort(x[s : s + pair]))
    np.testing.assert_array_equal(runs.numpy(), np.sort(x))


def test_sort_tiles_i64_matches_numpy():
    rng = np.random.default_rng(1)
    x = _keys(rng, 5 << TILE_LOG)
    got = bigsort.sort_tiles_i64(torch.from_numpy(x), TILE_LOG).numpy()
    np.testing.assert_array_equal(got, np.sort(x.reshape(5, -1), axis=1).reshape(-1))


def test_i64_wrappers_check_their_operands():
    x = torch.zeros(1 << TILE_LOG, dtype=torch.int64)
    with pytest.raises(TypeError):
        bigsort.sort_tiles_i64(x.int(), TILE_LOG)
    with pytest.raises(TypeError):
        bigsort.merge_level_i64(x.int(), 3)
    with pytest.raises(TypeError):
        bigsort.sort_runs(x.double(), TILE_LOG)
    with pytest.raises(ValueError):
        bigsort.sort_tiles_i64(x[:-1], TILE_LOG)
    with pytest.raises(ValueError):
        bigsort.sort_tiles_i64(x, bigsort.MAX_TILE_LOG + 1)
    with pytest.raises(ValueError, match="device"):
        bigsort.sort_tiles_i64(x.to("meta"), TILE_LOG)
    with pytest.raises(ValueError, match="device"):
        bigsort.merge_level_i64(x.to("meta"), 3)
