"""The port's count-side join (plain versions, on the CPU) against the JAX
package on the same table and probes: `bulk_count` on the CPU (its XLA
path), `sorted_build_counts`, the numpy oracle, and `build_sorted`'s
static fields."""

import numpy as np
import pytest
import torch

from ccve_tpu.config import PayloadMode
from ccve_tpu.core.datagen import gen_rhs_table
from ccve_tpu.exec import bulk as jax_bulk
from ccve_tpu.exec.oracle import OracleBuildTable, oracle_pipeline
from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch.exec.bulk import bulk_count
from ccve_tpu_torch.kernels import bigsort
from ccve_tpu_torch.ops import sort_merge as sm


def _crossed(jax_table):
    """The port's table from a JAX table, through table_from_arrays."""
    arrays = {"keys": np.asarray(jax_table.keys), "payloads": np.asarray(jax_table.payloads)}
    meta = {f: getattr(jax_table, f) for f in sm.META_FIELDS}
    return sm.table_from_arrays(arrays, meta, "cpu")


def _numpy_totals(keys, payloads, probe):
    match = probe[:, None] == keys[None, :]
    return int(match.sum()), int((match * payloads[None, :]).sum())


@pytest.mark.parametrize("n", [5000, 30_000])  # one tile (n <= 2^13) and several
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("chunk_factor", [1, 2, 4])
def test_bulk_count_matches_jax(chunk_factor, dtype, n):
    keys, payloads = gen_rhs_table(2000, chunk_factor)
    rng = np.random.default_rng(n + chunk_factor)
    # probes below and above the build range too
    probe = rng.integers(-30, int(keys.max()) + 40, (n, 1)).astype(dtype)
    jax_table = jax_sm.build_sorted(keys, payloads)
    want = jax_bulk.bulk_count([jax_table], probe)
    got = bulk_count([_crossed(jax_table)], probe)
    assert int(got.count) == int(want.count)
    assert int(got.payload_checksums[0]) == int(want.payload_checksums[0])
    assert got.payload_checksums.shape == (1,)


def test_bulk_count_matches_oracle():
    keys, payloads = gen_rhs_table(300, 3)
    rng = np.random.default_rng(4)
    probe = rng.integers(0, 320, (4000, 1))
    rows = oracle_pipeline(probe, [OracleBuildTable(keys, payloads)], PayloadMode.FULL)
    got = bulk_count([sm.build_sorted(keys, payloads, device="cpu")], torch.from_numpy(probe))
    assert int(got.count) == rows.shape[0]
    assert int(got.payload_checksums[0]) == int(rows[:, 2].sum())


def test_shrunken_tile_many_runs(monkeypatch):
    """With a 2^8 tile the plan stops the ladder early and leaves >= 3
    runs; the totals stay exact."""
    monkeypatch.setattr(bigsort, "TILE_LOG", 8)
    keys, payloads = gen_rhs_table(2000, 2)
    rng = np.random.default_rng(8)
    probe = rng.integers(0, 2100, 20_000).astype(np.int32)
    n_pad, run_log = sm.count_side_plan(20_000, 2000, 8)
    assert -(-n_pad // (1 << run_log)) >= 3
    jax_table = jax_sm.build_sorted(keys, payloads)
    c, s = sm.sorted_match_totals(_crossed(jax_table), probe)
    want = jax_sm.sorted_match_totals(jax_table, probe.astype(np.int64))
    assert (int(c), int(s)) == (int(want[0]), int(want[1]))
    assert (int(c), int(s)) == _numpy_totals(keys, payloads, probe)


@pytest.mark.parametrize("skip", [0, 1, 100])
def test_skip_levels_override(monkeypatch, skip):
    monkeypatch.setattr(bigsort, "TILE_LOG", 6)
    monkeypatch.setattr(sm, "SKIP_LEVELS_OVERRIDE", skip)
    keys, payloads = gen_rhs_table(500, 1)
    # more than 2^SMALL_PROBE_LOG probes: the tile route
    probe = np.random.default_rng(skip).integers(0, 520, 9000)
    table = sm.build_sorted(keys, payloads, device="cpu")
    got = sm.sorted_match_totals(table, probe)
    assert (int(got[0]), int(got[1])) == _numpy_totals(keys, payloads, probe)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("chunk_factor", [1, 3])
def test_sorted_build_counts_matches_jax(chunk_factor, dtype):
    keys, payloads = gen_rhs_table(900, chunk_factor)
    rng = np.random.default_rng(chunk_factor)
    probe = rng.integers(-5, int(keys.max()) + 5, 12_000).astype(dtype)
    jax_table = jax_sm.build_sorted(keys, payloads)
    want = np.asarray(jax_sm.sorted_build_counts(jax_table, probe.astype(np.int64)))
    got = sm.sorted_build_counts(_crossed(jax_table), torch.from_numpy(probe))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_negative_payloads_exact():
    rng = np.random.default_rng(22)
    keys = rng.integers(0, 300, 700)
    payloads = rng.integers(-5000, 5000, 700)
    probe = rng.integers(0, 320, 2500)
    got = sm.sorted_match_totals(sm.build_sorted(keys, payloads, device="cpu"), probe)
    assert (int(got[0]), int(got[1])) == _numpy_totals(keys, payloads, probe)


@pytest.mark.parametrize(
    "keys, payloads",
    [
        (gen_rhs_table(1000, 2)[0], None),
        (np.array([5, 5, 9, 1]), np.array([-10, 3, -7, 2])),  # negative payloads
        (np.array([0, 2**40, 7]), np.array([1, 2, 3])),  # span past 2^30
        (np.array([3]), np.array([2**40])),  # payload past 2^31
        (np.array([-(2**62), 2**62]), None),  # span past 2^62
    ],
)
def test_build_sorted_static_fields_match_jax(keys, payloads):
    want = jax_sm.build_sorted(keys, payloads)
    got = sm.build_sorted(keys, payloads, device="cpu")
    for f in sm.META_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys))
    np.testing.assert_array_equal(got.payloads.numpy(), np.asarray(want.payloads))
    crossed = _crossed(want)
    assert all(getattr(crossed, f) == getattr(got, f) for f in sm.META_FIELDS)
    assert got.key_range == crossed.key_range == (int(np.min(keys)), int(np.max(keys)))


def test_unported_branches_raise():
    """A table of no known type raises. Wide tables (span past 2^30, below
    2^62), full-range tables (span of 2^62 or more), an empty table,
    N-level joins and the hash tables are ported: they answer."""
    wide = sm.build_sorted(np.array([0, 2**40]), np.array([1, 2]), device="cpu")
    assert wide.pack32 is None and wide.span62
    probe = np.array([0, 1, 2**40, 2**40, -(2**63), 2**63 - 1])
    count, checksum = sm.sorted_match_totals(wide, probe)
    assert (int(count), int(checksum)) == (3, 5)
    assert sm.sorted_build_counts(wide, probe).tolist() == [1, 2]
    res = bulk_count([wide], probe[:, None])
    assert int(res.count) == 3 and res.payload_checksums.tolist() == [5]
    huge = sm.build_sorted(np.array([-(2**62), 2**62]), device="cpu")
    assert not huge.span62
    huge_probe = np.array([2**62, 0, -(2**62), 2**62, 2**63 - 1])
    count, checksum = sm.sorted_match_totals(huge, huge_probe)
    assert (int(count), int(checksum)) == (3, 10_000_000 + 2 * 10_000_001)
    assert sm.sorted_build_counts(huge, huge_probe).tolist() == [1, 2]
    res = bulk_count([huge], huge_probe[:, None])
    assert int(res.count) == 3 and res.payload_checksums.tolist() == [30_000_002]
    count, checksum = sm.sorted_match_totals(sm.build_sorted(np.zeros(0, np.int64), device="cpu"), probe)
    assert (int(count), int(checksum)) == (0, 0)
    narrow = sm.build_sorted(np.arange(10), device="cpu")
    two = bulk_count([narrow, narrow], np.zeros((4, 2), np.int64))
    assert int(two.count) == 4 and two.payload_checksums.tolist() == [40_000_000] * 2
    with pytest.raises(TypeError, match="unknown table type"):
        bulk_count([object()], probe[:, None])
    from ccve_tpu_torch.ops.hash_table import build_csr

    res = bulk_count([build_csr(np.array([0, 2**40]), np.array([1, 2]), device="cpu")],
                     probe[:, None])
    assert int(res.count) == 3 and res.payload_checksums.tolist() == [5]
    with pytest.raises(ValueError):
        sm.table_from_arrays({"keys": np.arange(3)}, {}, "cpu")


def test_tile_rows_and_empty_probe():
    keys, payloads = gen_rhs_table(500, 2)
    table = sm.build_sorted(keys, payloads, device="cpu")
    probe = np.random.default_rng(3).integers(0, 510, (7001, 1))
    whole = bulk_count([table], probe)
    tiled = bulk_count([table], probe, tile_rows=1000)
    assert int(whole.count) == int(tiled.count)
    assert int(whole.payload_checksums[0]) == int(tiled.payload_checksums[0])
    empty = bulk_count([table], np.zeros((0, 1), np.int64))
    assert int(empty.count) == 0 and int(empty.payload_checksums[0]) == 0
