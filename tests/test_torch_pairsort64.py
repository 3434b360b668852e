"""The port's multi-plane sort and merges on int64 keys (plain versions, on
the CPU) against the JAX package's `pallas_sort_multi_i64` and
`merge_sorted_multi_i64` in interpret mode, with 2^10 tiles so that the
limb tile sort, the merge levels and the unequal merge all run. The JAX
sort is unstable: key planes are compared exactly and (key, cargo...)
tuples as multisets. The port's sort is stable, so it is also held
exactly against numpy's stable argsort. Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.pairsort import merge_sorted_multi_i64 as jax_merge
from ccve_tpu.kernels.pairsort import pallas_sort_multi_i64 as jax_sort
from ccve_tpu_torch.kernels import pairsort
from torch_interpret import interpret

I64_MAX = 2**63 - 1


def _tuples(keys, vals):
    rows = np.stack([np.asarray(keys), *(np.asarray(v).astype(np.int64) for v in vals)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _planes(rng, n, count):
    return [rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32) for _ in range(count)]


@pytest.mark.parametrize(
    "n_planes, n, dom", [(1, 2500, 40), (2, 3000, 2**62), (3, 1800, 2**62)]
)
def test_sort_multi_i64_matches_jax(n_planes, n, dom):
    rng = np.random.default_rng(n_planes * 7 + n)
    keys = rng.integers(-dom, dom, n, dtype=np.int64)  # inside the JAX sentinels
    vals = _planes(rng, n, n_planes)
    want_keys, want_vals = interpret(lambda k, vs: jax_sort(k, vs, tile_log=10),
                                     jnp.asarray(keys), [jnp.asarray(v) for v in vals])
    got_keys, got_vals = pairsort.sort_multi_i64(torch.from_numpy(keys), [_i32(v) for v in vals], 10)
    assert got_keys.dtype == torch.int64 and all(v.dtype == torch.int32 for v in got_vals)
    np.testing.assert_array_equal(got_keys.numpy(), np.asarray(want_keys))
    np.testing.assert_array_equal(_tuples(got_keys, got_vals), _tuples(want_keys, want_vals))
    order = np.argsort(keys, kind="stable")  # the port's sort is stable
    np.testing.assert_array_equal(got_keys.numpy(), keys[order])
    for g, v in zip(got_vals, vals):
        np.testing.assert_array_equal(g.numpy(), v[order])


@pytest.mark.parametrize("na, nb", [(0, 300), (300, 0), (2000, 1500), (100, 2000)])
@pytest.mark.parametrize("n_planes", [1, 3])
def test_merge_sorted_multi_i64_matches_jax(na, nb, n_planes):
    rng = np.random.default_rng(na + 3 * nb + n_planes)
    ak = np.sort(rng.integers(0, 700, na) * 2**52 + 2**60)
    bk = np.sort(rng.integers(0, 700, nb) * 2**52 + 2**60)
    avs, bvs = _planes(rng, na, n_planes), _planes(rng, nb, n_planes)
    want_keys, want_vals = interpret(
        lambda a, av, b, bv: jax_merge(a, av, b, bv, tile_log=10),
        jnp.asarray(ak), [jnp.asarray(v) for v in avs],
        jnp.asarray(bk), [jnp.asarray(v) for v in bvs],
    )
    got_keys, got_vals = pairsort.merge_sorted_multi_i64(
        torch.from_numpy(ak), [_i32(v) for v in avs], torch.from_numpy(bk), [_i32(v) for v in bvs]
    )
    np.testing.assert_array_equal(got_keys.numpy(), np.asarray(want_keys))
    np.testing.assert_array_equal(_tuples(got_keys, got_vals), _tuples(want_keys, want_vals))
    # stable: A's elements first at equal keys, each stream in its order
    order = np.argsort(np.concatenate([ak, bk]), kind="stable")
    for g, a, b in zip(got_vals, avs, bvs):
        np.testing.assert_array_equal(g.numpy(), np.concatenate([a, b])[order])


@pytest.mark.parametrize("n", [0, 1, 17, 4096])
@pytest.mark.parametrize("tile_log", [1, 4, 13])
def test_sort_multi_i64_any_length_and_tile(n, tile_log):
    """Every length goes through the ladder; the result is the stable
    sort whatever the tile, INT64_MIN and INT64_MAX keys included."""
    rng = np.random.default_rng(n + tile_log)
    keys = rng.integers(-5, 5, n) * 2**61
    keys[: n // 3] = I64_MAX
    keys[n // 3 : n // 2] = -(2**63)
    rows = np.arange(n, dtype=np.int32)
    got_keys, (got_rows,) = pairsort.sort_multi_i64(torch.from_numpy(keys), [_i32(rows)], tile_log)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_keys.numpy(), keys[order])
    np.testing.assert_array_equal(got_rows.numpy(), order)
    plain_keys, (plain_rows,) = pairsort.sort_multi_plain(torch.from_numpy(keys), [_i32(rows)],
                                                         tile_log)
    assert torch.equal(plain_keys, got_keys) and torch.equal(plain_rows, got_rows)


@pytest.mark.parametrize("n", [1, 5, 2049])
def test_merge_level_multi_i64_ragged(n):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(-3, 3, n) * 2**62)
    vals = [_i32(np.arange(n))]
    for run_log in range(13):
        keys, vals = pairsort.merge_level_multi_i64(keys, vals, run_log)
    # the stable sort: ascending keys, equal keys in row order
    k, r = keys.numpy(), vals[0].numpy()
    order = np.lexsort((r, k))
    np.testing.assert_array_equal(k, k[order])
    np.testing.assert_array_equal(r, r[order])


def test_i64_wrappers_reject_bad_operands():
    k = torch.zeros(16, dtype=torch.int64)
    v = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(TypeError):
        pairsort.sort_tiles_multi_i64(k.int(), [v], 4)
    with pytest.raises(TypeError):
        pairsort.sort_tiles_multi_i64(k, [k], 4)  # int64 cargo
    with pytest.raises(ValueError, match="cargo planes"):
        pairsort.merge_level_multi_i64(k, [], 2)
    with pytest.raises(ValueError, match="tile_log"):
        pairsort.sort_tiles_multi_i64(k, [v], 14)
    with pytest.raises(TypeError):
        pairsort.merge_two_multi_i64(k, [v], k.int(), [v])
    with pytest.raises(ValueError, match="device"):
        pairsort.merge_two_multi_i64(k.to("meta"), [v.to("meta")], k.to("meta"), [v.to("meta")])
