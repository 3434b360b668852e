"""The count side's narrowing load (`bigsort.sort_runs_narrowed`), its
plain route on the CPU: bit for bit the composition it replaces (the probe
column narrowed by `_probe_key32`, padded by `_padded`, then `sort_runs`)
on int64 and int32 columns, over keys at the clamp bounds and the int64
extremes and over lengths around a tile and the small-probe boundary; the
count side takes it exactly on `pack32` tables above 2^SMALL_PROBE_LOG
probes; and `sorted_match_totals` and `sorted_build_counts` through it
equal the JAX package on config 1 and config 4 at a tiny size. The kernel
itself is held to the same composition on the card in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch.bench.configs import config1_host
from ccve_tpu_torch.bench.edge_cases import NARROW_TABLES, narrow_case
from ccve_tpu_torch.core.datagen import gen_rhs_table, gen_zipf_keys
from ccve_tpu_torch.kernels import bigsort
from ccve_tpu_torch.ops import sort_merge as sm

I64_MIN = -(2**63)
TILE_LOG = 6  # so that a few hundred probes take merge levels

LENGTHS = {"a tile multiple": 5 << TILE_LOG, "one above": (5 << TILE_LOG) + 1,
           "small-route boundary + 1": (1 << sm.SMALL_PROBE_LOG) + 1}


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("table_kind", NARROW_TABLES)
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_narrowed_runs_equal_the_composition_they_replace(dtype, table_kind, length):
    n = LENGTHS[length]
    keys, col = narrow_case(np.random.default_rng(n), table_kind, n, dtype)
    table = sm.build_sorted(keys, device="cpu")
    col = torch.from_numpy(col)
    p = sm._probe_key32(table, col)
    np.testing.assert_array_equal(
        bigsort.narrow_plain(col, *sm._narrow_bounds(table)).numpy(), p.numpy())
    n_pad, run_log = sm.count_side_plan(n, keys.size, TILE_LOG)
    assert run_log > TILE_LOG  # the plan keeps merge levels
    padded = torch.cat([p, p.new_full((n_pad - n,), bigsort.PAD[torch.int32])])
    want = bigsort.sort_runs(padded, run_log, TILE_LOG)
    got = bigsort.sort_runs_narrowed(col, *sm._narrow_bounds(table), n_pad, run_log, TILE_LOG)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    assert torch.equal(got, bigsort.sort_runs_narrowed_plain(
        col, *sm._narrow_bounds(table), n_pad, run_log, TILE_LOG))


def test_sort_runs_narrowed_refuses_bad_operands():
    col = torch.arange(100, dtype=torch.int64)
    with pytest.raises(TypeError):
        bigsort.sort_runs_narrowed(col.double(), 0, 10, 0, 128, TILE_LOG, TILE_LOG)
    with pytest.raises(ValueError):
        bigsort.sort_runs_narrowed(col.view(10, 10), 0, 10, 0, 128, TILE_LOG, TILE_LOG)
    for n_pad in (64, 100, 130):  # below n, or no tile multiple
        with pytest.raises(ValueError):
            bigsort.sort_runs_narrowed(col, 0, 10, 0, n_pad, TILE_LOG, TILE_LOG)
    with pytest.raises(ValueError):
        bigsort.sort_runs_narrowed(col, 11, 10, 0, 128, TILE_LOG, TILE_LOG)


@pytest.mark.parametrize("view", ["every other key", "a column of a table"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_a_strided_column_is_read_in_place(dtype, view):
    """A strided view gives the runs of its contiguous copy, and the count
    side hands it over as it is (no copy of the column)."""
    np_dtype = np.int64 if dtype == torch.int64 else np.int32
    keys, col = narrow_case(np.random.default_rng(7), "negative keys", 2000, np_dtype)
    table = sm.build_sorted(keys, device="cpu")
    wide = torch.from_numpy(np.stack([col[::-1], col, col[::-1]], 1))
    strided = wide[:, 1] if view == "a column of a table" else wide.flatten()[::2]
    assert not strided.is_contiguous()
    n_pad, run_log = sm.count_side_plan(strided.numel(), keys.size, TILE_LOG)
    bounds = sm._narrow_bounds(table)
    assert torch.equal(
        bigsort.sort_runs_narrowed(strided, *bounds, n_pad, run_log, TILE_LOG),
        bigsort.sort_runs_narrowed(strided.contiguous(), *bounds, n_pad, run_log, TILE_LOG))


def test_count_side_hands_a_strided_column_over_in_place(monkeypatch):
    monkeypatch.setattr(bigsort, "TILE_LOG", TILE_LOG)
    keys, col = narrow_case(np.random.default_rng(8), "negative keys", 9000, np.int64)
    table = sm.build_sorted(keys, device="cpu")
    probe = torch.from_numpy(np.stack([col[::-1], col], 1))[:, 1]
    seen, narrowed = [], bigsort.sort_runs_narrowed

    def spy(c, *args):
        seen.append(c.stride())
        return narrowed(c, *args)

    monkeypatch.setattr(bigsort, "sort_runs_narrowed", spy)
    got = sm._count_side(table, probe)
    assert seen == [(2,)]
    assert torch.equal(got, sm._count_side(table, probe.contiguous()))


def test_packed_int32_streams_on_the_tile_route_are_refused():
    """Above 2^SMALL_PROBE_LOG probes an int32 count side sorts the probe
    column itself: `_count_side_bc` takes packed int32 streams only on the
    small-probe route, and int64 streams at any length."""
    keys, col = narrow_case(np.random.default_rng(9), "negative keys", 9000, np.int64)
    table = sm.build_sorted(keys, device="cpu")
    for n, route in ((1 << sm.SMALL_PROBE_LOG, None), ((1 << sm.SMALL_PROBE_LOG) + 1, "tile")):
        p, b = sm.pack32_streams(table, torch.from_numpy(col[:n]))
        assert (sm._plan(n, b.numel(), torch.int32) is None) == (route is None)
        if route is None:
            assert torch.equal(sm._count_side_bc(p, b, b.numel()),
                               sm._count_side(table, torch.from_numpy(col[:n])))
        else:
            with pytest.raises(ValueError):
                sm._count_side_bc(p, b, b.numel())
            assert sm._plan(n, b.numel(), torch.int64) is not None
            assert sm._count_side_bc(p.long(), b.long(), b.numel()).equal(
                sm._count_side(table, torch.from_numpy(col[:n])))


ROUTES = ["tile route", "small probe", "wide", "full range", "stats side"]


@pytest.mark.parametrize("route", ROUTES)
def test_count_side_narrows_on_load_only_on_the_int32_tile_route(monkeypatch, route):
    """`_count_side` hands the raw column to `sort_runs_narrowed` exactly on
    `pack32` tables above 2^SMALL_PROBE_LOG probes; the small-probe, wide,
    full-range and stats routes never call it. Every route's answer is
    the JAX package's."""
    calls = []
    narrowed = bigsort.sort_runs_narrowed

    def spy(col, *args):
        calls.append(col.numel())
        return narrowed(col, *args)

    monkeypatch.setattr(bigsort, "sort_runs_narrowed", spy)
    rng = np.random.default_rng(ROUTES.index(route))
    stride = {"wide": 1 << 22, "full range": 1 << 50}.get(route, 1)
    keys = (rng.permutation(3000) - 1500).astype(np.int64) * stride
    if route == "full range":
        keys[0] = I64_MIN + 5
    n = 8192 if route == "small probe" else 9000
    probe = rng.choice(keys, n) + rng.integers(0, 2, n)
    payloads = rng.integers(0, 10**6, keys.size)
    table = sm.build_sorted(keys, payloads, device="cpu")
    jax_table = jax_sm.build_sorted(keys, payloads)
    if route == "stats side":
        got = sm.sorted_match_stats(table, probe)
        want = jax_sm.sorted_match_stats(jax_table, jnp.asarray(probe), use_kernel=False)
        np.testing.assert_array_equal(got.mult.numpy(), np.asarray(want.mult))
        np.testing.assert_array_equal(got.psum.numpy(), np.asarray(want.psum))
    else:
        count, checksum = sm.sorted_match_totals(table, probe)
        want = jax_sm.sorted_match_totals(jax_table, jnp.asarray(probe), use_kernel=False)
        assert (int(count), int(checksum)) == (int(want[0]), int(want[1]))
        np.testing.assert_array_equal(
            sm.sorted_build_counts(table, probe).numpy(),
            np.asarray(jax_sm.sorted_build_counts(jax_table, jnp.asarray(probe))))
    assert (table.pack32 is not None) == (route in ("tile route", "small probe", "stats side"))
    taken = {"tile route": [n, n]}.get(route, [])
    assert calls == taken


@pytest.mark.parametrize("config", ["config 1", "config 4"])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_totals_and_build_counts_through_the_load_equal_jax(config, dtype):
    """Config 1 (unique keys, uniform probes) and config 4 (Zipf probes
    over 0 .. domain - 1) at a tiny size, on the tile route."""
    if config == "config 1":
        keys, payloads, probe = config1_host(3000, 20_000)
        probe = probe[:, 0]
    else:
        keys, payloads = gen_rhs_table(3000, 1)
        probe = gen_zipf_keys(20_000, 3000, 1.1)
    table = sm.build_sorted(keys, payloads, device="cpu")
    assert table.pack32 is not None and probe.size > 1 << sm.SMALL_PROBE_LOG
    jax_table = jax_sm.build_sorted(keys, payloads)
    col = probe.astype(dtype)
    count, checksum = sm.sorted_match_totals(table, col)
    want = jax_sm.sorted_match_totals(jax_table, jnp.asarray(probe), use_kernel=False)
    assert (int(count), int(checksum)) == (int(want[0]), int(want[1]))
    np.testing.assert_array_equal(
        sm.sorted_build_counts(table, col).numpy(),
        np.asarray(jax_sm.sorted_build_counts(jax_table, jnp.asarray(probe))))
