"""Slice 3 as a whole on wide tables (key span past 2^30, below 2^62), on
the CPU: `sorted_match_totals`, `sorted_build_counts`, `sorted_match_ranks`
and N-level `bulk_count` against the JAX package (its wide Pallas routes in
interpret mode, its XLA routes) and numpy; negative payloads against the
oracle; a JAX wide table crossing over; `config1_wide` and the CLI's
`--wide-span`; and `build_sorted`'s default device. Tolerance 0."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.config import PayloadMode
from ccve_tpu.exec import bulk as jax_bulk
from ccve_tpu.exec.oracle import OracleBuildTable, oracle_pipeline
from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch.bench.configs import config1_wide, config1_wide_host
from ccve_tpu_torch.exec import bulk
from ccve_tpu_torch.ops import sort_merge as sm
from torch_interpret import interpret

ROOT = Path(__file__).resolve().parent.parent


def _wide_setup(m=1500, n=4000, span=2**40, seed=3):
    """The JAX package's wide fixture (tests/test_sort_merge.py), scaled
    down: keys over ±span with duplicates, payloads below 2^30, probes
    drawn from the keys plus 200 over ±2·span."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-span, span, m, dtype=np.int64)
    keys = np.concatenate([keys, keys[: m // 4]])
    payloads = rng.integers(0, 2**30, keys.shape[0], dtype=np.int64)
    probes = np.concatenate([
        rng.choice(keys, n - 200), rng.integers(-2 * span, 2 * span, 200, dtype=np.int64),
    ])
    rng.shuffle(probes)
    return keys, payloads, probes


def _crossed(jax_table):
    arrays = {"keys": np.asarray(jax_table.keys), "payloads": np.asarray(jax_table.payloads)}
    return sm.table_from_arrays(arrays, {f: getattr(jax_table, f) for f in sm.META_FIELDS}, "cpu")


def _numpy_totals(keys, payloads, probes):
    order = np.argsort(keys, kind="stable")
    prefix = np.concatenate([[0], np.cumsum(payloads[order])])
    lo = np.searchsorted(keys[order], probes, "left")
    hi = np.searchsorted(keys[order], probes, "right")
    return int((hi - lo).sum()), int((prefix[hi] - prefix[lo]).sum())


@pytest.mark.parametrize("seed, span", [(21, 2**40), (11, 2**60)])
def test_sorted_match_totals_wide_matches_jax(monkeypatch, seed, span):
    """Against JAX's wide count side on its limb route (its default split
    route can go quadratic on crowded probes) in interpret mode, its XLA
    route, and numpy; the JAX table crosses over with table_from_arrays."""
    monkeypatch.setattr(jax_sm, "WIDE_COUNT_ROUTE", "limb")
    keys, payloads, probes = _wide_setup(span=span, seed=seed)
    jax_table = jax_sm.build_sorted(keys, payloads)
    assert jax_table.pack32 is None and jax_table.wide_ok
    want = interpret(lambda p: jax_sm.sorted_match_totals(jax_table, p, use_kernel=True),
                     jnp.asarray(probes))
    xla = jax_sm.sorted_match_totals(jax_table, jnp.asarray(probes), use_kernel=False)
    got = sm.sorted_match_totals(_crossed(jax_table), torch.from_numpy(probes))
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    assert (int(got[0]), int(got[1])) == (int(xla[0]), int(xla[1]))
    assert (int(got[0]), int(got[1])) == _numpy_totals(keys, payloads, probes)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_sorted_build_counts_wide_matches_jax(dtype):
    keys, payloads, probes = _wide_setup(seed=4)
    if dtype == np.int32:
        keys, probes = keys >> 9, (probes >> 9).astype(np.int32)  # span past 2^31
    jax_table = jax_sm.build_sorted(keys, payloads)
    assert jax_table.pack32 is None
    want = np.asarray(jax_sm.sorted_build_counts(jax_table, jnp.asarray(probes.astype(np.int64))))
    got = sm.sorted_build_counts(sm.build_sorted(keys, payloads, device="cpu"),
                                 torch.from_numpy(probes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sorted_match_ranks_wide_matches_jax_pallas():
    keys, payloads, probes = _wide_setup(m=400, n=1200, seed=5)
    jax_rt = jax_sm.rank_table(jax_sm.build_sorted(keys, payloads))
    assert jax_rt.wide_ok
    want_mult, want_start = interpret(
        lambda p: jax_sm.sorted_match_ranks(jax_rt, p, use_kernel=True, tile_log=10),
        jnp.asarray(probes))
    rt = sm.rank_table(sm.build_sorted(keys, payloads, device="cpu"))
    assert rt.pack32 is None and sm.stats_key_type(rt) == torch.int64
    mult, start = sm.sorted_match_ranks(rt, torch.from_numpy(probes), tile_log=10)
    want_mult, want_start = np.asarray(want_mult), np.asarray(want_start)
    np.testing.assert_array_equal(mult.numpy(), want_mult)
    live = want_mult > 0
    np.testing.assert_array_equal(start.numpy()[live], want_start[live])
    sk = np.sort(keys)
    np.testing.assert_array_equal(start.numpy()[live], np.searchsorted(sk, probes[live]))


@pytest.mark.parametrize("n_joins", [1, 2, 3])
def test_bulk_count_wide_matches_jax_and_oracle(n_joins):
    """N levels over wide tables (stats side, int64 kernels' plain
    versions) and one level (count side), against JAX's bulk_count and the
    numpy oracle."""
    keys, payloads, _ = _wide_setup(m=400, seed=6)
    rng = np.random.default_rng(n_joins)
    probe = np.stack([
        np.concatenate([rng.choice(keys, 900), rng.integers(-(2**41), 2**41, 100)])
        for _ in range(n_joins)
    ], axis=1)
    want = jax_bulk.bulk_count([jax_sm.build_sorted(keys, payloads)] * n_joins, probe)
    got = bulk.bulk_count([sm.build_sorted(keys, payloads, device="cpu")] * n_joins,
                          torch.from_numpy(probe))
    rows = oracle_pipeline(probe, [OracleBuildTable(keys, payloads)] * n_joins, PayloadMode.FULL)
    assert int(got.count) == int(want.count) == rows.shape[0]
    checksums = [int(rows[:, n_joins + 2 * level + 1].sum()) for level in range(n_joins)]
    assert got.payload_checksums.tolist() == [int(c) for c in want.payload_checksums] == checksums


def test_negative_payloads_on_wide_tables_match_the_oracle():
    """Negative payloads (JAX's wide gates exclude them): totals, stats
    and a 2-level bulk_count against the oracle."""
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 2**45, 500, dtype=np.int64)
    keys = np.concatenate([keys, keys[:100]])
    payloads = rng.integers(-(2**31), 2**31 - 1, keys.size)
    table = sm.build_sorted(keys, payloads, device="cpu")
    assert table.pack32 is None and table.pay32 and not table.wide_ok
    probe = np.stack([np.concatenate([rng.choice(keys, 1500), rng.integers(0, 2**45, 500)])
                      for _ in range(2)], axis=1)
    one = oracle_pipeline(probe[:, :1], [OracleBuildTable(keys, payloads)], PayloadMode.FULL)
    count, checksum = sm.sorted_match_totals(table, probe[:, 0])
    assert (int(count), int(checksum)) == (one.shape[0], int(one[:, 2].sum()))
    stats = sm.sorted_match_stats(table, torch.from_numpy(probe[:, 0]))
    assert int(stats.mult.sum()) == one.shape[0] and int(stats.psum.sum()) == int(one[:, 2].sum())
    two = oracle_pipeline(probe, [OracleBuildTable(keys, payloads)] * 2, PayloadMode.FULL)
    got = bulk.bulk_count([table] * 2, probe)
    assert int(got.count) == two.shape[0]
    assert got.payload_checksums.tolist() == [int(two[:, 3].sum()), int(two[:, 5].sum())]


def test_config1_wide_matches_jax_generator():
    """The port's generator draws what the JAX package's config1_wide
    draws (same seed, same order), and its run's count and checksum are
    numpy's."""
    keys, payloads, probe = config1_wide_host(4096, 1 << 13, 40)
    rng = np.random.default_rng(1)  # the JAX package's draws, in order
    want_keys = rng.integers(0, 1 << 40, 4096, dtype=np.int64)
    want_probe = np.concatenate([rng.choice(want_keys, 1 << 12),
                                 rng.integers(0, 1 << 40, 1 << 12, dtype=np.int64)])
    rng.shuffle(want_probe)
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_array_equal(probe, want_probe)
    np.testing.assert_array_equal(payloads, rng.integers(0, 2**30, 4096, dtype=np.int64))
    res = config1_wide(4096, 1 << 13, 40, device="cpu")
    assert (res["count"], res["checksum"]) == _numpy_totals(keys, payloads, probe)
    assert res["device"] == "cpu" and res["span_bits"] == 40
    with pytest.raises(ValueError, match="wide"):
        config1_wide(4096, 1 << 10, 20, device="cpu")


def test_cli_wide_span_tiny():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "ccve_tpu_torch.cli", "baseline", "--config", "1", "--tiny",
         "--wide-span", "40", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    keys, payloads, probe = config1_wide_host(4096, 1 << 15, 40)
    assert (got["count"], got["checksum"]) == _numpy_totals(keys, payloads, probe)
    assert got["name"] == "config1_wide" and got["n_probe"] == 1 << 15
    bad = subprocess.run(
        [sys.executable, "-m", "ccve_tpu_torch.cli", "baseline", "--config", "3", "--tiny",
         "--wide-span", "40", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert bad.returncode != 0 and "--config 1 only" in bad.stderr


def test_build_sorted_defaults_to_the_card():
    """Without `device`, build_sorted builds on the GPU, and raises where
    there is none: it never falls back to the CPU."""
    keys = np.arange(10)
    if torch.cuda.is_available():
        assert sm.build_sorted(keys).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sm.build_sorted(keys)
    assert sm.build_sorted(keys, device="cpu").device.type == "cpu"
