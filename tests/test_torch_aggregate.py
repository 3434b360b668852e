"""The port's aggregates (`ops.aggregate`, on the CPU) and its hash
partition (`parallel.distributed._owner`) against the JAX package on the
same numpy inputs. Tolerance 0: every field is an integer, and the padding
past `n_groups` is compared too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.core.datagen import gen_rhs_table, gen_zipf_keys
from ccve_tpu.ops import aggregate as jax_agg
from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu.parallel import distributed as jax_dist
from ccve_tpu_torch.ops import aggregate as agg
from ccve_tpu_torch.ops import sort_merge as sm
from ccve_tpu_torch.parallel import distributed as dist

FIELDS = ("keys", "count", "sum", "min", "max")
EXTREMES = [0, 1, -1, -(2**63), 2**63 - 1, 2**32, -(2**32)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    """Every field of the port's GroupByResult equals JAX's, padding included."""
    for field in FIELDS:
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == torch.int64, field
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
    assert int(got.n_groups) == int(want.n_groups)


def _groups_numpy(keys, vals):
    """{key: (count, sum, min, max)} in numpy."""
    return {int(k): (int((keys == k).sum()), int(vals[keys == k].sum()),
                     int(vals[keys == k].min()), int(vals[keys == k].max()))
            for k in np.unique(keys)}


def test_hash_aggregate_matches_numpy_and_jax():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 50, size=1000).astype(np.int64)
    vals = rng.integers(-100, 100, size=1000).astype(np.int64)
    got = agg.hash_aggregate(_t(keys), _t(vals))
    _same(got, jax_agg.hash_aggregate(jnp.asarray(keys), jnp.asarray(vals)))
    ng = int(got.n_groups)
    assert ng == np.unique(keys).shape[0]
    assert {int(got.keys[g]): (int(got.count[g]), int(got.sum[g]), int(got.min[g]),
                               int(got.max[g])) for g in range(ng)} == _groups_numpy(keys, vals)


@pytest.mark.parametrize("n, n_keys", [(1, 1), (7, 7), (2000, 3), (4099, 700)])
def test_hash_aggregate_int64_extremes_match_jax(n, n_keys):
    rng = np.random.default_rng(n)
    pool = np.concatenate([np.array(EXTREMES, np.int64),
                           rng.integers(-(2**63), 2**63 - 1, n_keys, dtype=np.int64)])
    keys = rng.choice(pool[:n_keys], n)
    vals = rng.integers(-(2**40), 2**40, n, dtype=np.int64)
    vals[: min(n, 3)] = [2**62, -(2**62), 2**63 - 1][: min(n, 3)]
    _same(agg.hash_aggregate(_t(keys), _t(vals)),
          jax_agg.hash_aggregate(jnp.asarray(keys), jnp.asarray(vals)))


def test_hash_aggregate_empty():
    got = agg.hash_aggregate(torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int64))
    assert int(got.n_groups) == 0 and all(getattr(got, f).numel() == 0 for f in FIELDS)


def test_hash_aggregate_int32_values_accumulate_in_int64():
    keys = np.zeros(4, np.int64)
    vals = np.full(4, 2**30, np.int32)
    got = agg.hash_aggregate(_t(keys), _t(vals))
    _same(got, jax_agg.hash_aggregate(jnp.asarray(keys), jnp.asarray(vals)))
    assert int(got.sum[0]) == 4 * 2**30 and int(got.count[0]) == 4


@pytest.mark.parametrize("n, domain, alpha", [(2000, 64, 1.2), (5000, 257, 1.1), (300, 1000, 0.8)])
def test_dense_aggregate_matches_jax_and_hash_aggregate(n, domain, alpha):
    keys = gen_zipf_keys(n, domain, alpha=alpha)
    vals = np.arange(n, dtype=np.int64) * 7 - 1000
    d = agg.dense_aggregate(_t(keys), _t(vals), domain)
    _same(d, jax_agg.dense_aggregate(jnp.asarray(keys), jnp.asarray(vals), domain))
    h = agg.hash_aggregate(_t(keys), _t(vals))
    assert int(d.n_groups) == int(h.n_groups)
    for g in range(int(h.n_groups)):
        k = int(h.keys[g])
        for field in ("count", "sum", "min", "max"):
            assert int(getattr(d, field)[k]) == int(getattr(h, field)[g]), field


def test_dense_aggregate_drops_keys_outside_the_domain():
    """The port drops keys -1 and `domain`; numpy says what the groups are.
    The JAX version wraps -1 into group domain - 1 (ROADMAP Queue 3), so
    parity tests stay on in-domain keys."""
    domain = 8
    keys = np.array([-1, 3, 8, 7, 3, -1, 0, 8, 7], np.int64)
    vals = np.array([100, 1, 200, 2, 3, 300, 4, 400, 5], np.int64)
    got = agg.dense_aggregate(_t(keys), _t(vals), domain)
    inside = (keys >= 0) & (keys < domain)
    want = _groups_numpy(keys[inside], vals[inside])
    np.testing.assert_array_equal(got.count.numpy(), np.bincount(keys[inside], minlength=domain))
    for k in range(domain):
        c, s, mn, mx = want.get(k, (0, 0, agg.I64_MAX, agg.I64_MIN))
        assert (int(got.count[k]), int(got.sum[k]), int(got.min[k]), int(got.max[k])) \
            == (c, s, mn, mx), k
    assert int(got.n_groups) == len(want) == 3
    jax_d = jax_agg.dense_aggregate(jnp.asarray(keys), jnp.asarray(vals), domain)
    assert int(jax_d.count[domain - 1]) == int(got.count[domain - 1]) + 2  # the two -1 rows


@pytest.mark.parametrize("domain, n, alpha", [(257, 5000, 1.1), (1024, 50_000, 1.1), (64, 9000, 1.3)])
def test_join_dense_aggregate_matches_jax(domain, n, alpha):
    keys, payloads = gen_rhs_table(domain, 1)
    probe = gen_zipf_keys(n, domain, alpha)
    got, total = agg.join_dense_aggregate(sm.build_sorted(keys, payloads, device="cpu"),
                                          _t(probe), domain)
    want, want_total = jax_agg.join_dense_aggregate(jax_sm.build_sorted(keys, payloads),
                                                    jnp.asarray(probe), domain)
    _same(got, want)
    assert int(total) == int(want_total) == n


def test_join_dense_aggregate_matches_scatter_path():
    """The pushed-down aggregate equals the dense aggregate of each probe's
    matched-payload sum (the port's `sorted_match_stats`), as the JAX test
    holds it."""
    domain = 257
    keys, payloads = gen_rhs_table(domain, 1)
    table = sm.build_sorted(keys, payloads, device="cpu")
    probe = _t(gen_zipf_keys(5000, domain, 1.1))
    stats = sm.sorted_match_stats(table, probe)
    ref = agg.dense_aggregate(probe, stats.psum, domain)
    got, total = agg.join_dense_aggregate(table, probe, domain)
    assert int(total) == int(stats.mult.to(torch.int64).sum())
    for field in FIELDS:
        assert torch.equal(getattr(got, field), getattr(ref, field)), field
    assert int(got.n_groups) == int(ref.n_groups)


@pytest.mark.parametrize("keys, domain", [
    (np.arange(10), 11),  # too few rows
    (np.arange(1, 11), 10),  # the keys start at 1
    (np.repeat(np.arange(5), 2), 10),  # duplicate keys
    (np.array([0, 1, 5]), 3),  # unique keys from 0, but not 0 .. domain - 1
    (np.array([0, 1, 3, 4]), 4),  # a gap below the largest key
])
def test_join_dense_aggregate_refuses_other_tables(keys, domain):
    table = sm.build_sorted(keys, device="cpu")
    with pytest.raises(ValueError, match="join_dense_aggregate needs"):
        agg.join_dense_aggregate(table, torch.arange(5), domain)


@pytest.mark.parametrize("n_parts", [1, 4, 12, 16])
def test_partition_histogram_matches_jax(n_parts):
    probe = gen_zipf_keys(20_000, 5000, 1.1)
    got = agg.partition_histogram(_t(probe), n_parts)
    want = np.asarray(jax_agg.partition_histogram(jnp.asarray(probe), n_parts))
    assert got.dtype == torch.int64 and got.shape == (n_parts,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == probe.size


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4, 12, 16, 64, 1000])
def test_owner_matches_jax(n_parts):
    rng = np.random.default_rng(n_parts)
    keys = np.concatenate([np.array(EXTREMES, np.int64),
                           rng.integers(-(2**63), 2**63 - 1, 3000, dtype=np.int64)])
    got = dist._owner(_t(keys), n_parts)
    want = jax_dist._owner_np(keys, n_parts)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_dist._owner_jnp(jnp.asarray(keys),
                                                                             n_parts)))
    np.testing.assert_array_equal(dist._owner_np(keys, n_parts), want)
    # a P that is no power of two owns only its low power of two's parts
    assert int(got.max()) < 1 << int(np.log2(n_parts))
