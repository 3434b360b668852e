"""The port's int64 count side (plain versions, on the CPU) against the JAX
package: `_count_side_bc` on int64 streams against `_count_side_bc64` (the
limb ladder, per-run limb merges and the 64-bit counts kernel, in Pallas
interpret mode with a 2^10 tile), `merge_counts_i64` against
`merge_scan_build_counts64`, the int64 packing at the edges of the int64
range, and numpy. Tolerance 0: counts are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.merge_scan import merge_scan_build_counts64
from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch.kernels import bigsort, merge_scan
from ccve_tpu_torch.ops import sort_merge as sm
from torch_interpret import interpret

I64_MAX = 2**63 - 1


def _streams(keys, probes):
    """(p64, b64) of the count side, packed in numpy as the JAX package
    packs them (builds odd, probes even)."""
    key_lo, key_hi = keys[0] - 1, keys[-1] + 1
    b64 = ((keys - key_lo) << 1) | 1
    p64 = (np.clip(probes, key_lo, key_hi) - key_lo) << 1
    return p64, b64


def _expected(keys, probes):
    """bc by numpy: every build row gets its key's probe count."""
    sp = np.sort(probes)
    return (np.searchsorted(sp, keys, "right") - np.searchsorted(sp, keys, "left")).astype(np.int32)


@pytest.mark.parametrize("m, n", [(300, 3000), (2000, 2500)])
def test_count_side_bc_i64_matches_jax_limb_ladder(monkeypatch, m, n):
    """A 2^10 tile on both sides: the port's plan keeps several runs of
    the int64 ladder; JAX's limb ladder merges each run with the build
    stream. Unique build keys, where the JAX route is exact."""
    monkeypatch.setattr(bigsort, "TILE_LOG", 10)
    rng = np.random.default_rng(m)
    keys = np.unique(rng.integers(0, 2**40, m, dtype=np.int64))
    probes = np.concatenate([rng.choice(keys, n - 400), rng.integers(0, 2**40, 400)])
    rng.shuffle(probes)
    p64, b64 = _streams(keys, probes)
    got = sm._count_side_bc(torch.from_numpy(p64), torch.from_numpy(b64), keys.size)
    want = np.asarray(interpret(
        lambda p, b: jax_sm._count_side_bc64(p, b, keys.size, tile_log=10),
        jnp.asarray(p64), jnp.asarray(b64)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _expected(keys, probes))


def test_count_side_bc_i64_duplicate_builds(monkeypatch):
    """Repeated build keys: every row of a key gets the key's full count
    (numpy only: the JAX limb route spreads a key's count over its rows)."""
    monkeypatch.setattr(bigsort, "TILE_LOG", 6)
    rng = np.random.default_rng(5)
    keys = np.sort(np.repeat(rng.integers(-(2**50), 2**50, 200, dtype=np.int64), 3))
    probes = np.concatenate([rng.choice(keys, 3000), rng.integers(-(2**51), 2**51, 500)])
    p64, b64 = _streams(keys, probes)
    got = sm._count_side_bc(torch.from_numpy(p64), torch.from_numpy(b64), keys.size)
    n_pad, run_log = sm.count_side_plan(probes.size, keys.size, 6)
    assert -(-n_pad // (1 << run_log)) >= 3  # several runs
    np.testing.assert_array_equal(got.numpy(), _expected(keys, probes))


@pytest.mark.parametrize("m, n, hi", [(500, 6000, 2**61), (3000, 1000, 2**40)])
def test_merge_counts_i64_matches_jax_counts64(m, n, hi):
    """One sorted run against the JAX counts kernel over the merged stream
    of probes and builds (packed keys near 2^62 in the first case)."""
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(hi - 2**30, hi, m, dtype=np.int64))
    probes = np.concatenate([rng.choice(keys, n // 2), rng.integers(hi - 2**30, hi, n - n // 2)])
    p64, b64 = _streams(keys, probes)
    merged = np.sort(np.concatenate([p64, b64]))
    want = np.asarray(interpret(
        lambda hi, lo: merge_scan_build_counts64(hi, lo, keys.size),
        jnp.asarray((merged >> 32).astype(np.int32)), jnp.asarray(merged.astype(np.int32)),
    ))
    runs = torch.from_numpy(np.concatenate([np.sort(p64), np.full(77, I64_MAX)]))
    got = merge_scan.merge_counts_i64(runs, n, n, torch.from_numpy(b64), keys.size)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _expected(keys, probes))


@pytest.mark.parametrize("run_len", [1, 7, 64, 1000])
def test_merge_counts_i64_many_runs(run_len):
    rng = np.random.default_rng(run_len)
    n = 4000
    probes = (2**60 + rng.integers(0, 700, n)) * 2
    pk = np.concatenate([np.sort(probes[s : s + run_len]) for s in range(0, n, run_len)])
    b64 = (2**60 + np.sort(rng.integers(3, 600, 400))) * 2 + 1
    runs = torch.from_numpy(np.concatenate([pk, np.full(3 * run_len, I64_MAX)]))
    got = merge_scan.merge_counts_i64(runs, run_len, n, torch.from_numpy(b64), b64.size)
    want = merge_scan.merge_counts_plain(runs, run_len, n, torch.from_numpy(b64), b64.size)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), _expected(b64 // 2, probes // 2))


@pytest.mark.parametrize(
    "keys",
    [
        np.array([-(2**63), -(2**63) + 5, -(2**63) + 9]),  # the int64 minimum
        np.array([-(2**63), -(2**63) + 2**40]),
        np.array([2**63 - 9, 2**63 - 3, 2**63 - 1]),  # the int64 maximum
        np.array([2**63 - 1 - 2**40, 2**63 - 1]),
        np.array([-(2**61), 0, 2**61 - 3]),  # a span of 2^62 - 1
        np.array([7, 7, 2**35]),
    ],
    ids=["min narrow", "min wide", "max narrow", "max wide", "span 2^62", "duplicates"],
)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_packing_at_the_int64_edges(keys, dtype):
    """Tables at the int64 extremes pack without wrapping, narrow (int32
    streams) or wide (int64 streams); probes at the extremes clamp without
    wrapping; int32 probes are widened. Totals, build counts, stats and
    the expanded triples against numpy."""
    pays = np.arange(keys.size) - 1
    table = sm.build_sorted(keys, pays, device="cpu")
    assert table.span62
    edge = [-(2**63), 2**63 - 1] if dtype == np.int64 else [-(2**31), 2**31 - 1]
    probes = np.concatenate([keys, keys[:1], edge, [0, 6, 8]])
    probes = probes[(probes >= np.iinfo(dtype).min) & (probes <= np.iinfo(dtype).max)]
    probes = probes.astype(dtype)
    if table.pack32 is None:
        p64, b64 = sm.pack64_streams(table, torch.from_numpy(probes))
        assert p64.dtype == b64.dtype == torch.int64
        assert int(p64.min()) >= 0 and int(b64.max()) < 2**63 - 1
    count, checksum = sm.sorted_match_totals(table, probes)
    match = probes.astype(np.int64)[:, None] == keys[None, :]
    assert int(count) == int(match.sum())
    assert int(checksum) == int((match * pays).sum())
    np.testing.assert_array_equal(sm.sorted_build_counts(table, probes).numpy(), match.sum(0))
    stats = sm.sorted_match_stats(table, torch.from_numpy(probes))
    np.testing.assert_array_equal(stats.mult.numpy(), match.sum(1))
    np.testing.assert_array_equal(stats.psum.numpy(), (match * pays).sum(1))
    rows, got_keys, got_pays, total = sm.sorted_expand(table, probes, match.sum())
    r, c = np.nonzero(match)
    assert int(total) == r.size
    got = sorted(zip(rows.tolist(), got_keys.tolist(), got_pays.tolist()))
    assert got == sorted(zip(r.tolist(), keys[c].tolist(), pays[c].tolist()))


def test_merge_counts_i64_checks_operands():
    runs = torch.zeros(16, dtype=torch.int64)
    b = torch.ones(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        merge_scan.merge_counts_i64(runs.int(), 16, 16, b, 4)
    with pytest.raises(TypeError):
        merge_scan.merge_counts_i64(runs, 16, 16, b.int(), 4)
    with pytest.raises(ValueError):
        merge_scan.merge_counts_i64(runs, 16, 17, b, 4)
    with pytest.raises(ValueError, match="device"):
        merge_scan.merge_counts_i64(runs.to("meta"), 16, 16, b.to("meta"), 4)
