"""The port's sort ladder (plain versions, on the CPU) against the JAX
package's `bigsort._sort_padded_buf` in Pallas interpret mode, with the
tile shrunk to 2^11 on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels import bigsort as jax_bigsort
from ccve_tpu_torch.kernels import bigsort
from torch_interpret import interpret

TILE_LOG = 11


def _values(rng, n, dom=None):
    # strictly inside (INT32_MIN, INT32_MAX): the JAX ladder's sentinels
    if dom is None:
        return rng.integers(-(2**31) + 1, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    return rng.integers(0, dom, n).astype(np.int32)


@pytest.mark.parametrize("nt, cap", [(1, 0), (3, 0), (3, 1), (5, 2), (8, 1), (8, 2)])
def test_sort_runs_matches_jax_ladder(nt, cap):
    rng = np.random.default_rng(10 * nt + cap)
    n_pad = nt << TILE_LOG
    x = _values(rng, n_pad)
    want = np.asarray(interpret(
        lambda a: jax_bigsort._sort_padded_buf(a, TILE_LOG, 0, n_levels_cap=cap), jnp.asarray(x)
    )).reshape(-1)[:n_pad]
    got = bigsort.sort_runs(torch.from_numpy(x), TILE_LOG + cap, TILE_LOG)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nt", [1, 2, 3, 5, 13])
@pytest.mark.parametrize("dom", [None, 3])
def test_sort_runs_every_cap(nt, dom):
    """Runs of 2^run_log, each the sorted values of its positions."""
    rng = np.random.default_rng(nt)
    tile_log = 6
    x = _values(rng, nt << tile_log, dom)
    for run_log in range(tile_log, tile_log + 6):
        got = bigsort.sort_runs(torch.from_numpy(x), run_log, tile_log).numpy()
        run = 1 << run_log
        for s in range(0, x.size, run):
            np.testing.assert_array_equal(got[s : s + run], np.sort(x[s : s + run]))


@pytest.mark.parametrize("n", [0, 1, 5, 64, 100, 2049])
def test_merge_level_ragged(n):
    rng = np.random.default_rng(n)
    x = _values(rng, n, 9)
    runs = torch.from_numpy(x)  # runs of one value are sorted
    for run_log in range(13):
        runs = bigsort.merge_level_i32(runs, run_log)
        pair = 2 << run_log
        got = runs.numpy()
        for s in range(0, n, pair):  # each pair is now one ascending run
            np.testing.assert_array_equal(got[s : s + pair], np.sort(x[s : s + pair]))
    np.testing.assert_array_equal(runs.numpy(), np.sort(x))


def test_sort_tiles_matches_numpy():
    rng = np.random.default_rng(1)
    x = _values(rng, 5 << TILE_LOG)
    got = bigsort.sort_tiles_i32(torch.from_numpy(x), TILE_LOG).numpy()
    want = np.sort(x.reshape(5, -1), axis=1).reshape(-1)
    np.testing.assert_array_equal(got, want)


def test_wrappers_check_their_operands():
    x = torch.zeros(1 << TILE_LOG, dtype=torch.int32)
    with pytest.raises(TypeError):
        bigsort.sort_tiles_i32(x.long(), TILE_LOG)
    with pytest.raises(ValueError):
        bigsort.sort_tiles_i32(x[:-1], TILE_LOG)  # not a tile multiple
    with pytest.raises(ValueError):
        bigsort.sort_tiles_i32(x, bigsort.MAX_TILE_LOG + 1)
    with pytest.raises(ValueError):
        bigsort.merge_level_i32(x.view(2, -1).t(), 3)  # 2-D
    with pytest.raises(ValueError):
        bigsort.merge_level_i32(x[::2], 3)  # not contiguous
    with pytest.raises(ValueError):
        bigsort.sort_runs(x, TILE_LOG - 1, TILE_LOG)


def test_no_plain_version_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device goes to a
    kernel or raises (a meta tensor has no kernel)."""
    x = torch.empty(1 << TILE_LOG, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        bigsort.sort_tiles_i32(x, TILE_LOG)
    with pytest.raises(ValueError, match="device"):
        bigsort.merge_level_i32(x, 3)
