"""The port's multi-plane sort and merges (plain versions, on the CPU)
against the JAX package's `pallas_sort_multi_i32` and
`merge_sorted_multi_i32` in interpret mode, with tiles shrunk so that the
tile sort, the merge levels and the unequal merge all run. The JAX sort is
unstable: key planes are compared exactly and (key, cargo...) tuples as
multisets. The port's sort is stable, so it is also held exactly against
numpy's stable argsort."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.pairsort import merge_sorted_multi_i32 as jax_merge
from ccve_tpu.kernels.pairsort import pallas_sort_multi_i32 as jax_sort
from ccve_tpu_torch.kernels import pairsort
from torch_interpret import interpret


def _tuples(keys, vals):
    rows = np.stack([np.asarray(keys), *map(np.asarray, vals)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


@pytest.mark.parametrize("n_planes", [1, 2, 3])
@pytest.mark.parametrize("tile_log, n, dom", [(10, 5000, 40), (11, 4097, 2**30)])
def test_sort_multi_matches_jax(n_planes, tile_log, n, dom):
    rng = np.random.default_rng(n_planes * 7 + tile_log)
    keys = rng.integers(-dom, dom, n).astype(np.int32)
    vals = [rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32) for _ in range(n_planes)]
    want_keys, want_vals = interpret(lambda k, vs: jax_sort(k, vs, tile_log=tile_log),
                                     jnp.asarray(keys), [jnp.asarray(v) for v in vals])
    got_keys, got_vals = pairsort.sort_multi_i32(_i32(keys), [_i32(v) for v in vals], tile_log)
    np.testing.assert_array_equal(got_keys.numpy(), np.asarray(want_keys))
    np.testing.assert_array_equal(_tuples(got_keys, got_vals), _tuples(want_keys, want_vals))
    order = np.argsort(keys, kind="stable")  # the port's sort is stable
    np.testing.assert_array_equal(got_keys.numpy(), keys[order])
    for g, v in zip(got_vals, vals):
        np.testing.assert_array_equal(g.numpy(), v[order])


@pytest.mark.parametrize(
    "na, nb", [(0, 300), (300, 0), (5000, 3000), (100, 3000), (4096, 1)]
)
@pytest.mark.parametrize("n_planes", [1, 3])
def test_merge_sorted_multi_matches_jax(na, nb, n_planes):
    rng = np.random.default_rng(na + 3 * nb + n_planes)
    ak = np.sort(rng.integers(0, 700, na)).astype(np.int32)
    bk = np.sort(rng.integers(0, 700, nb)).astype(np.int32)
    avs = [rng.integers(0, 1 << 30, na).astype(np.int32) for _ in range(n_planes)]
    bvs = [rng.integers(0, 1 << 30, nb).astype(np.int32) for _ in range(n_planes)]
    want_keys, want_vals = interpret(
        lambda a, av, b, bv: jax_merge(a, av, b, bv, tile_log=10),
        jnp.asarray(ak), [jnp.asarray(v) for v in avs],
        jnp.asarray(bk), [jnp.asarray(v) for v in bvs],
    )
    got_keys, got_vals = pairsort.merge_sorted_multi_i32(
        _i32(ak), [_i32(v) for v in avs], _i32(bk), [_i32(v) for v in bvs]
    )
    np.testing.assert_array_equal(got_keys.numpy(), np.asarray(want_keys))
    np.testing.assert_array_equal(_tuples(got_keys, got_vals), _tuples(want_keys, want_vals))
    # stable: A's elements first at equal keys, each stream in its order
    order = np.argsort(np.concatenate([ak, bk]), kind="stable")
    for g, a, b in zip(got_vals, avs, bvs):
        np.testing.assert_array_equal(g.numpy(), np.concatenate([a, b])[order])


@pytest.mark.parametrize("run_log", [4, 6, 9])
def test_sort_multi_runs(run_log):
    """Padded to a tile multiple and sorted into runs of 2^run_log: each
    run is the stable sort of its slice of the padded input."""
    rng = np.random.default_rng(run_log)
    n, tile_log = 1000, 4
    keys = rng.integers(0, 30, n).astype(np.int32)
    vals = [np.arange(n, dtype=np.int32)]
    got_keys, (got_rows,) = pairsort.sort_multi_i32_runs(_i32(keys), [_i32(vals[0])],
                                                          run_log, tile_log)
    n_pad = n + (-n) % (1 << tile_log)
    assert got_keys.numel() == n_pad
    padded = np.concatenate([keys, np.full(n_pad - n, 2**31 - 1, np.int32)])
    rows = np.concatenate([vals[0], np.zeros(n_pad - n, np.int32)])
    run = 1 << run_log
    for lo in range(0, n_pad, run):
        order = np.argsort(padded[lo : lo + run], kind="stable")
        np.testing.assert_array_equal(got_keys[lo : lo + run].numpy(), padded[lo : lo + run][order])
        np.testing.assert_array_equal(got_rows[lo : lo + run].numpy(), rows[lo : lo + run][order])


@pytest.mark.parametrize("n", [0, 1, 17, 4096])
@pytest.mark.parametrize("tile_log", [1, 4, 13])
def test_sort_multi_any_length_and_tile(n, tile_log):
    """Every length goes through the ladder; the result is the stable
    sort whatever the tile, INT32_MAX keys included."""
    rng = np.random.default_rng(n + tile_log)
    keys = rng.integers(-5, 5, n).astype(np.int32)
    keys[: n // 3] = 2**31 - 1
    rows = np.arange(n, dtype=np.int32)
    got_keys, (got_rows,) = pairsort.sort_multi_i32(_i32(keys), [_i32(rows)], tile_log)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_keys.numpy(), keys[order])
    np.testing.assert_array_equal(got_rows.numpy(), order)
    plain_keys, (plain_rows,) = pairsort.sort_multi_plain(_i32(keys), [_i32(rows)], tile_log)
    assert torch.equal(plain_keys, got_keys) and torch.equal(plain_rows, got_rows)


def test_wrappers_reject_bad_operands():
    k = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="cargo planes"):
        pairsort.sort_tiles_multi_i32(k, [], 4)
    with pytest.raises(ValueError, match="cargo planes"):
        pairsort.sort_tiles_multi_i32(k, [k, k, k, k], 4)
    with pytest.raises(TypeError):
        pairsort.sort_tiles_multi_i32(k, [k.long()], 4)
    with pytest.raises(ValueError, match="values"):
        pairsort.merge_level_multi_i32(k, [k[:3]], 2)
    with pytest.raises(ValueError, match="multiple"):
        pairsort.sort_tiles_multi_i32(k[:10], [k[:10]], 4)
    with pytest.raises(ValueError, match="tile_log"):
        pairsort.sort_tiles_multi_i32(k, [k], 14)
    with pytest.raises(ValueError, match="planes"):
        pairsort.merge_two_multi_i32(k, [k], k, [k, k])
