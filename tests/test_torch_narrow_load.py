"""The count side's narrowing loads (`bigsort.sort_runs_narrowed` into
int32 keys, `sort_runs_narrowed_i64` into int64 keys), their plain route
on the CPU: bit for bit the composition each replaces (the probe column
narrowed by `_probe_key32` or `_probe_key64`, padded by `_padded`, then
`sort_runs`) on int64 and int32 columns, over keys at the clamp bounds
and the int64 extremes, wide tables with a span just below 2^62, and
lengths around a tile and the small-probe boundary; the count side takes
the int32 form exactly on `pack32` tables above 2^SMALL_PROBE_LOG probes
and the int64 form exactly on wide tables; and `sorted_match_totals` and
`sorted_build_counts` through them equal the JAX package on config 1,
config 4 and config1_wide at a tiny size. The kernels themselves are held
to the same compositions on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch.bench.configs import config1_host, config1_wide_host
from ccve_tpu_torch.bench.edge_cases import NARROW_TABLES, NARROW_WIDE_TABLES, narrow_case
from ccve_tpu_torch.core.datagen import gen_rhs_table, gen_zipf_keys
from ccve_tpu_torch.kernels import bigsort
from ccve_tpu_torch.ops import sort_merge as sm

I64_MIN = -(2**63)
TILE_LOG = 6  # so that a few hundred probes take merge levels

LENGTHS = {"a tile multiple": 5 << TILE_LOG, "one above": (5 << TILE_LOG) + 1,
           "small-route boundary + 1": (1 << sm.SMALL_PROBE_LOG) + 1}


# (key type, clamp bounds, narrowing, narrowing load) of a table's count side
def _form(table):
    if table.pack32 is None:
        return (torch.int64, sm._wide_bounds(table), sm._probe_key64,
                bigsort.sort_runs_narrowed_i64)
    return torch.int32, sm._narrow_bounds(table), sm._probe_key32, bigsort.sort_runs_narrowed


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("table_kind", [*NARROW_TABLES, *NARROW_WIDE_TABLES])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_narrowed_runs_equal_the_composition_they_replace(dtype, table_kind, length):
    n = LENGTHS[length]
    keys, col = narrow_case(np.random.default_rng(n), table_kind, n, dtype)
    table = sm.build_sorted(keys, device="cpu")
    assert (table.pack32 is None) == (table_kind in NARROW_WIDE_TABLES) and table.span62
    key_type, bounds, probe_key, load = _form(table)
    col = torch.from_numpy(col)
    p = probe_key(table, col)
    assert p.dtype == key_type
    np.testing.assert_array_equal(bigsort.narrow_plain(col, *bounds, key_type).numpy(), p.numpy())
    n_pad, run_log = sm.count_side_plan(n, keys.size, TILE_LOG)
    assert run_log > TILE_LOG  # the plan keeps merge levels
    want = bigsort.sort_runs(sm._padded(p, (n_pad, run_log, TILE_LOG)), run_log, TILE_LOG)
    got = load(col, *bounds, n_pad, run_log, TILE_LOG)
    assert got.dtype == key_type
    assert torch.equal(got, want)
    assert torch.equal(got, bigsort.sort_runs_narrowed_plain(
        col, *bounds, n_pad, run_log, TILE_LOG, key_type))


def test_sort_runs_narrowed_refuses_bad_operands():
    col = torch.arange(100, dtype=torch.int64)
    for load in (bigsort.sort_runs_narrowed, bigsort.sort_runs_narrowed_i64):
        with pytest.raises(TypeError):
            load(col.double(), 0, 10, 0, 128, TILE_LOG, TILE_LOG)
        with pytest.raises(ValueError):
            load(col.view(10, 10), 0, 10, 0, 128, TILE_LOG, TILE_LOG)
        for n_pad in (64, 100, 130):  # below n, or no tile multiple
            with pytest.raises(ValueError):
                load(col, 0, 10, 0, n_pad, TILE_LOG, TILE_LOG)
        with pytest.raises(ValueError):
            load(col, 11, 10, 0, 128, TILE_LOG, TILE_LOG)


@pytest.mark.parametrize("view", ["every other key", "a column of a table"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_a_strided_column_is_read_in_place(dtype, view):
    """A strided view gives the runs of its contiguous copy, into int32
    and into int64 keys, and the count side hands it over as it is (no
    copy of the column)."""
    np_dtype = np.int64 if dtype == torch.int64 else np.int32
    for table_kind in ("negative keys", "span 2^40 to INT64_MAX"):
        keys, col = narrow_case(np.random.default_rng(7), table_kind, 2000, np_dtype)
        table = sm.build_sorted(keys, device="cpu")
        _, bounds, _, load = _form(table)
        wide = torch.from_numpy(np.stack([col[::-1], col, col[::-1]], 1))
        strided = wide[:, 1] if view == "a column of a table" else wide.flatten()[::2]
        assert not strided.is_contiguous()
        n_pad, run_log = sm.count_side_plan(strided.numel(), keys.size, TILE_LOG)
        assert torch.equal(load(strided, *bounds, n_pad, run_log, TILE_LOG),
                           load(strided.contiguous(), *bounds, n_pad, run_log, TILE_LOG))


def test_count_side_hands_a_strided_column_over_in_place(monkeypatch):
    """To the int32 load on a `pack32` table, to the int64 one on a wide
    table."""
    monkeypatch.setattr(bigsort, "TILE_LOG", TILE_LOG)
    seen = []
    for name in ("sort_runs_narrowed", "sort_runs_narrowed_i64"):
        load = getattr(bigsort, name)

        def spy(c, *args, load=load, name=name):
            seen.append((name, c.stride()))
            return load(c, *args)

        monkeypatch.setattr(bigsort, name, spy)
    for table_kind, taken in (("negative keys", "sort_runs_narrowed"),
                              ("span 2^40", "sort_runs_narrowed_i64")):
        keys, col = narrow_case(np.random.default_rng(8), table_kind, 9000, np.int64)
        table = sm.build_sorted(keys, device="cpu")
        probe = torch.from_numpy(np.stack([col[::-1], col], 1))[:, 1]
        seen.clear()
        got = sm._count_side(table, probe)
        assert seen == [(taken, (2,))]
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
    """`_count_side` hands the raw column to the int32 load,
    `sort_runs_narrowed`, exactly on `pack32` tables above
    2^SMALL_PROBE_LOG probes, and to the int64 load,
    `sort_runs_narrowed_i64`, exactly on wide tables; the small-probe,
    full-range and stats routes call neither. Every route's answer is the
    JAX package's."""
    calls = {"sort_runs_narrowed": [], "sort_runs_narrowed_i64": []}
    for name in calls:
        load = getattr(bigsort, name)

        def spy(col, *args, load=load, name=name):
            calls[name].append(col.numel())
            return load(col, *args)

        monkeypatch.setattr(bigsort, name, spy)
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
    assert calls == {"sort_runs_narrowed": [n, n] if route == "tile route" else [],
                     "sort_runs_narrowed_i64": [n, n] if route == "wide" else []}


@pytest.mark.parametrize("config", ["config 1", "config 4", "config1_wide"])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_totals_and_build_counts_through_the_load_equal_jax(config, dtype):
    """Config 1 (unique keys, uniform probes), config 4 (Zipf probes over
    0 .. domain - 1) and config1_wide (keys over 2^40, half the probes
    misses, through the int64 load; its int32 column is the probes cast,
    most of them clamped) at a tiny size, on the tile route."""
    if config == "config 1":
        keys, payloads, probe = config1_host(3000, 20_000)
        probe = probe[:, 0]
    elif config == "config 4":
        keys, payloads = gen_rhs_table(3000, 1)
        probe = gen_zipf_keys(20_000, 3000, 1.1)
    else:
        keys, payloads, probe = config1_wide_host(3000, 20_000, 40)
    table = sm.build_sorted(keys, payloads, device="cpu")
    assert (table.pack32 is None) == (config == "config1_wide")
    assert probe.size > 1 << sm.SMALL_PROBE_LOG
    jax_table = jax_sm.build_sorted(keys, payloads)
    col = probe.astype(dtype)
    jcol = jnp.asarray(col.astype(np.int64))
    count, checksum = sm.sorted_match_totals(table, col)
    want = jax_sm.sorted_match_totals(jax_table, jcol, use_kernel=False)
    assert (int(count), int(checksum)) == (int(want[0]), int(want[1]))
    np.testing.assert_array_equal(
        sm.sorted_build_counts(table, col).numpy(),
        np.asarray(jax_sm.sorted_build_counts(jax_table, jcol)))
