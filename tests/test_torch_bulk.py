"""The port's N-level bulk engine (plain versions, on the CPU) against the
JAX package and the numpy oracle: `bulk_count` over 2-4 levels,
`bulk_materialize` in both payload modes, the port's copy of the oracle
against JAX's, and an empty build table. Tolerance 0: counts, checksums
and rows are integers."""

import numpy as np
import pytest
import torch

from ccve_tpu.config import PayloadMode as JaxPayloadMode
from ccve_tpu.core.datagen import gen_probe_table, gen_rhs_table
from ccve_tpu.exec import bulk as jax_bulk
from ccve_tpu.exec import oracle as jax_oracle
from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.exec import bulk, oracle
from ccve_tpu_torch.ops import sort_merge as sm


def _expected(probe, keys, payloads, n_joins):
    rows = oracle.oracle_pipeline(
        probe, [oracle.OracleBuildTable(keys, payloads)] * n_joins, PayloadMode.FULL
    )
    return rows.shape[0], [int(rows[:, n_joins + 2 * lv + 1].sum()) for lv in range(n_joins)]


@pytest.mark.parametrize("n_joins", [2, 3, 4])
@pytest.mark.parametrize("chunk_factor", [1, 2])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_n_level_bulk_count_matches_jax_and_oracle(n_joins, chunk_factor, dtype):
    keys, payloads = gen_rhs_table(120, chunk_factor)
    probe = gen_probe_table(900, n_joins, 240).astype(dtype)  # about half hit per level
    want = jax_bulk.bulk_count([jax_sm.build_sorted(keys, payloads)] * n_joins, probe)
    got = bulk.bulk_count([sm.build_sorted(keys, payloads, device="cpu")] * n_joins, torch.from_numpy(probe))
    count, checksums = _expected(probe, keys, payloads, n_joins)
    assert int(got.count) == int(want.count) == count
    assert [int(c) for c in got.payload_checksums] == [int(c) for c in want.payload_checksums]
    assert [int(c) for c in got.payload_checksums] == checksums


@pytest.mark.parametrize("tile_rows", [1, 100, 899, 5000])
def test_n_level_tile_rows(tile_rows):
    keys, payloads = gen_rhs_table(80, 2)
    probe = gen_probe_table(700, 3, 100)
    tables = [sm.build_sorted(keys, payloads, device="cpu")] * 3
    got = bulk.bulk_count(tables, probe, tile_rows=tile_rows)
    count, checksums = _expected(probe, keys, payloads, 3)
    assert int(got.count) == count
    assert [int(c) for c in got.payload_checksums] == checksums


def test_levels_with_different_tables():
    """Each level has its own table: duplicates with negative payloads,
    a key span past 2^30 (the generic route), and random keys. Held to the
    oracle. The JAX package agrees on the count and on the levels with
    non-negative payloads; on level 0 its `match_stats` takes the cummax
    base, which assumes non-negative payloads (ROADMAP Queue 3)."""
    rng = np.random.default_rng(12)
    builds = [
        (np.repeat(np.arange(50), 3), rng.integers(-1000, 1000, 150)),
        (np.arange(0, 2**36, 2**30), np.arange(64) + 7),
        (rng.integers(0, 60, 90), None),
    ]
    probe = np.stack([rng.integers(0, 55, 2000), rng.integers(0, 70, 2000) * 2**30,
                      rng.integers(0, 65, 2000)], axis=1)
    got = bulk.bulk_count([sm.build_sorted(k, p, device="cpu") for k, p in builds], probe)
    rows = oracle.oracle_pipeline(
        probe, [oracle.OracleBuildTable(k, p) for k, p in builds], PayloadMode.FULL
    )
    assert int(got.count) == rows.shape[0] > 0
    assert got.payload_checksums.tolist() == [int(rows[:, 3 + 2 * lv + 1].sum()) for lv in range(3)]
    want = jax_bulk.bulk_count([jax_sm.build_sorted(k, p) for k, p in builds], probe)
    assert int(want.count) == rows.shape[0]
    np.testing.assert_array_equal(got.payload_checksums.numpy()[1:],
                                  np.asarray(want.payload_checksums)[1:])


@pytest.mark.parametrize("mode", list(PayloadMode))
@pytest.mark.parametrize("n_joins, chunk_factor", [(1, 3), (2, 2), (3, 1)])
def test_bulk_materialize_matches_oracle(mode, n_joins, chunk_factor):
    keys, payloads = gen_rhs_table(96, chunk_factor)
    probe = gen_probe_table(600, n_joins, 150)
    got = bulk.bulk_materialize([sm.build_sorted(keys, payloads, device="cpu")] * n_joins, probe, mode)
    want = oracle.oracle_pipeline(probe, [oracle.OracleBuildTable(keys, payloads)] * n_joins, mode)
    assert got.dtype == torch.int64 and got.shape == want.shape
    oracle.assert_same_multiset(got.numpy(), want)
    by_value = bulk.bulk_materialize([sm.build_sorted(keys, payloads, device="cpu")] * n_joins,
                                     torch.from_numpy(probe), mode.value)
    oracle.assert_same_multiset(by_value.numpy(), want)


@pytest.mark.parametrize("mode", ["reference", "full"])
@pytest.mark.parametrize("n_joins", [1, 3])
def test_oracle_matches_jax_oracle(mode, n_joins):
    keys, payloads = gen_rhs_table(70, 2)
    probe = gen_probe_table(500, n_joins, 90)
    got = oracle.oracle_pipeline(probe, [oracle.OracleBuildTable(keys, payloads)] * n_joins,
                                 PayloadMode(mode))
    want = jax_oracle.oracle_pipeline(
        probe, [jax_oracle.OracleBuildTable(keys, payloads)] * n_joins, JaxPayloadMode(mode)
    )
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(oracle.sort_rows(got), jax_oracle.sort_rows(want))
    with pytest.raises(AssertionError):
        oracle.assert_same_multiset(got[1:], want)


def test_empty_build_table_bulk_count_is_zero():
    empty = np.zeros(0, np.int64)
    probe = np.arange(12, dtype=np.int64).reshape(6, 2)
    for n_joins, cols in ((1, probe[:, :1]), (2, probe)):
        want = jax_bulk.bulk_count([jax_sm.build_sorted(empty, empty)] * n_joins, cols)
        got = bulk.bulk_count([sm.build_sorted(empty, empty, device="cpu")] * n_joins, cols)
        assert int(got.count) == int(want.count) == 0
        assert got.payload_checksums.tolist() == [0] * n_joins
        np.testing.assert_array_equal(np.asarray(want.payload_checksums), [0] * n_joins)
    rows = bulk.bulk_materialize([sm.build_sorted(empty, empty, device="cpu")], probe[:, :1], PayloadMode.FULL)
    assert rows.shape == (0, 3)


def test_hash_tables_are_not_ported():
    """Hash tables are ported now (tests/test_torch_hash_bulk.py): an LP
    level answers beside a sorted one; an unknown table type raises
    TypeError, as the JAX package's `match_stats` does."""
    from ccve_tpu_torch.ops.hash_table import build_lp

    table = sm.build_sorted(np.arange(5), device="cpu")
    with pytest.raises(TypeError, match="unknown table type"):
        bulk.match_stats(object(), torch.arange(3))
    with pytest.raises(TypeError, match="unknown table type"):
        bulk.bulk_count([table, object()], np.zeros((2, 2), np.int64))
    with pytest.raises(TypeError, match="unknown table type"):
        bulk.bulk_materialize([object()], np.zeros((2, 1), np.int64), PayloadMode.FULL)
    with pytest.raises(ValueError):
        bulk.bulk_count([table, table], np.zeros((4, 3), np.int64))
    stats = bulk.match_stats(table, torch.tensor([1, 9], dtype=torch.int32))
    assert stats.mult.tolist() == [1, 0]
    mixed = bulk.bulk_count([table, build_lp(np.arange(5), device="cpu")],
                            np.array([[1, 1], [2, 9], [4, 3]]))
    assert int(mixed.count) == 2
