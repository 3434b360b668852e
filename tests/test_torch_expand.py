"""The port's materializing join (plain versions, on the CPU) against the
JAX package: `sorted_expand`'s triple multiset against the XLA route and
the Pallas route (interpret mode), `sorted_expand_tiled` against the
monolithic call, the capacity contract, and an empty build table. Row
order is not part of the contract; the multiset is compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch.ops import sort_merge as sm
from torch_interpret import interpret, once


def _triples(rows, keys, pays):
    rows, keys, pays = (np.asarray(t).astype(np.int64) for t in (rows, keys, pays))
    live = rows >= 0
    out = np.stack([rows[live], keys[live], pays[live]], axis=1)
    return out[np.lexsort(out.T[::-1])]


def _tables(keys, payloads):
    return jax_sm.build_sorted(keys, payloads), sm.build_sorted(keys, payloads, device="cpu")


CASES = {
    "dups": (np.repeat(np.arange(40) * 3, 3), np.arange(120) + 500, 0, 125),
    "mixed mult": (np.sort(np.repeat(np.arange(900), 1 + np.arange(900) % 3)), None, -5, 950),
    "negative keys and payloads": (np.arange(-1000, -700), np.arange(300) * -5, -1010, -690),
    "span past 2^30": (np.arange(200) * 2**33, np.arange(200), -5, 2**41),
    "payload past 2^31": (np.array([4, 4, 8]), np.array([2**40, -3, 9]), 0, 10),
}


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sorted_expand_matches_jax_xla(case, use_kernel):
    keys, payloads, lo, hi = CASES[case]
    rng = np.random.default_rng(len(keys))
    probe = rng.integers(lo, hi, 2000)
    probe[:100] = rng.choice(keys, 100)
    jax_table, table = _tables(keys, payloads)
    cap = probe.size * table.max_mult
    want = once(("expand xla", case), lambda: jax_sm.sorted_expand(
        jax_table, jnp.asarray(probe), cap, use_kernel=False))
    got = sm.sorted_expand(table, torch.from_numpy(probe), cap, use_kernel=use_kernel)
    assert int(got[3]) == int(want[3])
    assert got[0].dtype == torch.int32 and got[1].dtype == got[2].dtype == torch.int64
    np.testing.assert_array_equal(_triples(*got[:3]), _triples(*want[:3]))


def test_sorted_expand_matches_jax_kernel_route():
    """Against the JAX package's multi-plane Pallas expand (interpret
    mode, 2^11 tiles, the compaction-sort branch)."""
    rng = np.random.default_rng(31)
    keys = np.sort(np.repeat(rng.integers(0, 900, 600), 2))
    payloads = rng.integers(0, 2**20, keys.size)
    probe = rng.integers(-5, 950, 2500).astype(np.int64)
    jax_table, table = _tables(keys, payloads)
    cap = 1 << 13
    want = interpret(lambda p: jax_sm.sorted_expand(jax_table, p, cap, use_kernel=True,
                                                    tile_log=11), jnp.asarray(probe))
    got = sm.sorted_expand(table, torch.from_numpy(probe), cap, tile_log=11)
    assert int(got[3]) == int(want[3])
    np.testing.assert_array_equal(_triples(*got[:3]), _triples(*want[:3]))


@pytest.mark.slow  # the JAX compaction-kernel branch in interpret mode, as tests/test_sort_merge.py
def test_sorted_expand_matches_jax_compact_branch():
    rng = np.random.default_rng(37)
    m, n = 2560, 5120  # (m + n) % 128 == 0: JAX takes its compaction kernel
    keys = np.sort(np.repeat(rng.integers(0, 900, m // 2), 2))
    payloads = rng.integers(0, 2**20, keys.size)
    probe = rng.integers(-5, 950, n).astype(np.int64)
    jax_table, table = _tables(keys, payloads)
    want = interpret(lambda p: jax_sm.sorted_expand(jax_table, p, 1 << 14, use_kernel=True,
                                                    tile_log=11), jnp.asarray(probe))
    got = sm.sorted_expand(table, torch.from_numpy(probe), 1 << 14, tile_log=11)
    np.testing.assert_array_equal(_triples(*got[:3]), _triples(*want[:3]))


@pytest.mark.parametrize("use_kernel", [None, False])
def test_capacity_contract(use_kernel):
    """Slots past the total hold (-1, 0, 0); a tight capacity keeps the
    first `capacity` triples and still reports the full total."""
    keys = np.repeat(np.arange(40) * 3, 3)
    probe = torch.from_numpy(np.random.default_rng(5).integers(0, 125, 300))
    table = sm.build_sorted(keys, np.arange(keys.size) + 500, device="cpu")
    rows, ks, ps, total = sm.sorted_expand(table, probe, 2000, use_kernel=use_kernel)
    t = int(total)
    assert (rows[:t] >= 0).all() and (rows[t:] == -1).all()
    assert not ks[t:].any() and not ps[t:].any()
    rows8, _, _, total8 = sm.sorted_expand(table, probe, 8, use_kernel=use_kernel)
    assert int(total8) == t > 8 and rows8.shape == (8,) and (rows8 >= 0).all()
    rows0, _, _, total0 = sm.sorted_expand(table, probe, 0, use_kernel=use_kernel)
    assert rows0.numel() == 0 and int(total0) == t


@pytest.mark.parametrize("tile_rows", [1, 333, 1000, 5000])
def test_tiled_matches_monolithic(tile_rows):
    rng = np.random.default_rng(tile_rows)
    keys = np.sort(np.repeat(rng.integers(0, 500, 600), 2))
    table = sm.build_sorted(keys, rng.integers(-(2**31), 2**31 - 1, keys.size), device="cpu")
    n = 301 if tile_rows == 1 else 3001  # one call per row: keep the one-row tiles few
    probe = torch.from_numpy(rng.integers(-5, 510, n).astype(np.int32))
    whole = sm.sorted_expand(table, probe, probe.numel() * table.max_mult)
    tiles, total = sm.sorted_expand_tiled(table, probe, tile_rows=tile_rows)
    assert len(tiles) == -(-n // tile_rows) and total == int(whole[3])
    assert sum(int(t[3]) for t in tiles) == total
    got = _triples(*(torch.cat([t[i] for t in tiles]) for i in range(3)))
    np.testing.assert_array_equal(got, _triples(*whole[:3]))
    assert all(t[0].dtype == torch.int64 for t in tiles)


def test_tiled_default_tile_is_sized_by_memory(monkeypatch):
    table = sm.build_sorted(np.repeat(np.arange(10), 4), device="cpu")
    monkeypatch.setattr(sm, "_free_bytes", lambda device: 2 * (1 << 30))
    per_row = sm.EXPAND_BYTES_PER_ELEMENT + 4 * sm.EXPAND_BYTES_PER_CANDIDATE
    assert sm.expand_tile_rows(table) == (1 << 30) // per_row - 40
    monkeypatch.setattr(sm, "_free_bytes", lambda device: 0)
    assert sm.expand_tile_rows(table) == 1 << 16
    probe = np.arange(100_000) % 12
    tiles, total = sm.sorted_expand_tiled(table, probe)
    assert len(tiles) == 2 and total == 4 * int((probe < 10).sum())


def test_empty_build_table_expands_to_nothing():
    """m == 0: no triples and total 0, also past one tile. The JAX
    package's tiled call raises IndexError there (it reads the smallest
    key to pad the last tile)."""
    empty = np.zeros(0, np.int64)
    probe = np.arange(-3, 997)
    jax_table, table = _tables(empty, empty)
    want = jax_sm.sorted_expand(jax_table, jnp.asarray(probe), probe.size)
    assert int(want[3]) == 0
    for use_kernel in (None, False):
        rows, keys, pays, total = sm.sorted_expand(table, probe, probe.size, use_kernel=use_kernel)
        assert int(total) == 0 and (rows == -1).all() and not keys.any() and not pays.any()
    tiles, total = sm.sorted_expand_tiled(table, probe, tile_rows=300)
    assert total == 0 and len(tiles) == 4 and all((t[0] == -1).all() for t in tiles)
    with pytest.raises(IndexError):
        jax_sm.sorted_expand_tiled(jax_table, jnp.asarray(probe), tile_rows=300)
    tiles, total = sm.sorted_expand_tiled(table, np.zeros(0, np.int64))
    assert total == 0 and len(tiles) == 1 and tiles[0][0].numel() == 0
