"""The port's hash engines in the bulk executor (plain versions, on the
CPU) against the JAX package and the numpy oracle: LP match stats on both
schedules (the compacted ladder and its overflow recompute included), CSR
match stats, `bulk_count` over hash and mixed levels, `bulk_materialize`
over hash tables, `config1_single_join` and the CLI on the hash engines.
Tolerance 0: counts, checksums and rows are integers."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.config import PayloadMode as JaxPayloadMode
from ccve_tpu.core.datagen import gen_probe_table, gen_rhs_table
from ccve_tpu.exec import bulk as jax_bulk
from ccve_tpu.ops import hash_table as jax_ht
from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch import cli
from ccve_tpu_torch.bench.configs import config1_single_join, numpy_totals
from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.exec import bulk, oracle
from ccve_tpu_torch.ops import hash_table as ht
from ccve_tpu_torch.ops import sort_merge as sm

ROOT = Path(__file__).resolve().parent.parent

BUILDERS = {
    "lp": (ht.build_lp, jax_ht.build_lp),
    "csr": (ht.build_csr, jax_ht.build_csr),
    "sorted": (sm.build_sorted, jax_sm.build_sorted),
}


def _run(args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def _tables(kinds, keys, payloads):
    ours = [BUILDERS[k][0](keys, payloads, device="cpu") for k in kinds]
    theirs = [BUILDERS[k][1](keys, payloads) for k in kinds]
    return ours, theirs


def _stats_equal(got, want):
    np.testing.assert_array_equal(got.mult.numpy(), np.asarray(want.mult))
    np.testing.assert_array_equal(got.psum.numpy(), np.asarray(want.psum))
    assert got.mult.dtype == torch.int32 and got.psum.dtype == torch.int64


@pytest.mark.parametrize(
    "chunk_factor, n_probe, probe_dom, compact_lanes",
    [(1, 5000, 2600, False), (1, 5000, 2600, True), (3, 70_000, 40_000, None),
     (2, 70_000, 2600, False)],
)
def test_lp_match_stats_matches_jax(monkeypatch, chunk_factor, n_probe, probe_dom, compact_lanes):
    """n >= 2^16 takes the compacted ladder by default (three stages at
    70,000 probes; about 2 % of them hit, so no stage overflows and the
    ladder's own answer is the one checked); JAX's full-width drain is the
    reference, as its own tests hold its ladder to it."""
    keys, payloads = gen_rhs_table(2048, chunk_factor)
    probe = gen_probe_table(n_probe, 1, probe_dom)[:, 0]
    table = ht.build_lp(keys, payloads, device="cpu")
    recomputed = []
    inner = bulk.lp_match_stats
    monkeypatch.setattr(bulk, "lp_match_stats",
                        lambda *a, **kw: recomputed.append(a) or inner(*a, **kw))
    got = inner(table, torch.from_numpy(probe), compact_lanes=compact_lanes)
    assert not recomputed
    want = jax_bulk.lp_match_stats(jax_ht.build_lp(keys, payloads), jnp.asarray(probe),
                                   compact_lanes=False, pallas_compact=False)
    _stats_equal(got, want)
    assert int(got.mult.max()) == chunk_factor
    plain = bulk.lp_match_stats(table, torch.from_numpy(probe), compact_lanes=compact_lanes,
                                route=bulk.HASH_PLAIN)
    assert torch.equal(plain.mult, got.mult) and torch.equal(plain.psum, got.psum)


def test_lp_ladder_overflow_recomputes_at_full_width(monkeypatch):
    """Every probe key is in the table, so every lane survives step 0 and
    the first stage (half the width) overflows: the call recomputes at full
    width and still equals JAX's drain."""
    keys, payloads = gen_rhs_table(4096, 8)
    rng = np.random.default_rng(2)
    probe = rng.choice(keys, 1 << 16)
    table = ht.build_lp(keys, payloads, device="cpu")
    full_width_calls = []
    inner = bulk.lp_match_stats

    def spy(tbl, k, compact_lanes=None, **route):
        full_width_calls.append(compact_lanes)
        return inner(tbl, k, compact_lanes, **route)

    monkeypatch.setattr(bulk, "lp_match_stats", spy)
    got = inner(table, torch.from_numpy(probe))
    assert full_width_calls == [False]
    want = jax_bulk.lp_match_stats(jax_ht.build_lp(keys, payloads), jnp.asarray(probe),
                                   compact_lanes=False, pallas_compact=False)
    _stats_equal(got, want)
    np.testing.assert_array_equal(got.mult.numpy(), np.full(probe.size, 8))


@pytest.mark.parametrize("chunk_factor", [1, 4])
def test_csr_match_stats_matches_jax(chunk_factor):
    keys, payloads = gen_rhs_table(1500, chunk_factor)
    probe = gen_probe_table(9000, 1, 2000)[:, 0]
    table = ht.build_csr(keys, payloads, device="cpu")
    got = bulk.csr_match_stats(table, torch.from_numpy(probe))
    _stats_equal(got, jax_bulk.csr_match_stats(jax_ht.build_csr(keys, payloads), jnp.asarray(probe)))


def test_match_stats_dispatches_on_the_table():
    keys, payloads = gen_rhs_table(64, 2)
    probe32 = torch.from_numpy(gen_probe_table(500, 1, 80)[:, 0].astype(np.int32))
    tables, _ = _tables(["lp", "csr", "sorted"], keys, payloads)
    stats = [bulk.match_stats(t, probe32) for t in tables]
    for s in stats[1:]:
        assert torch.equal(s.mult, stats[0].mult) and torch.equal(s.psum, stats[0].psum)
    with pytest.raises(TypeError, match="unknown table type"):
        bulk.match_stats(object(), probe32)


@pytest.mark.parametrize(
    "kinds", [("lp",), ("csr",), ("lp", "csr"), ("sorted", "lp"), ("csr", "sorted", "lp")]
)
@pytest.mark.parametrize("chunk_factor", [1, 3])
def test_bulk_count_over_hash_levels_matches_jax_and_oracle(kinds, chunk_factor):
    n_joins = len(kinds)
    keys, payloads = gen_rhs_table(80, chunk_factor)
    probe = gen_probe_table(900, n_joins, 160)
    ours, theirs = _tables(kinds, keys, payloads)
    got = bulk.bulk_count(ours, probe)
    want = jax_bulk.bulk_count(theirs, probe)
    rows = oracle.oracle_pipeline(probe, [oracle.OracleBuildTable(keys, payloads)] * n_joins,
                                  PayloadMode.FULL)
    assert int(got.count) == int(want.count) == rows.shape[0]
    checksums = [int(rows[:, n_joins + 2 * lv + 1].sum()) for lv in range(n_joins)]
    assert got.payload_checksums.tolist() == checksums
    np.testing.assert_array_equal(np.asarray(want.payload_checksums), checksums)


def test_bulk_count_hash_tiles_and_int32_columns():
    keys, payloads = gen_rhs_table(64, 2)
    probe = gen_probe_table(700, 3, 100)
    tables, _ = _tables(["lp", "csr", "lp"], keys, payloads)
    whole = bulk.bulk_count(tables, probe)
    tiled = bulk.bulk_count(tables, torch.from_numpy(probe.astype(np.int32)), tile_rows=128)
    assert int(tiled.count) == int(whole.count) > 0
    assert torch.equal(tiled.payload_checksums, whole.payload_checksums)


@pytest.mark.parametrize("mode", list(PayloadMode))
@pytest.mark.parametrize("kinds, chunk_factor", [(("lp",), 3), (("csr", "lp"), 2), (("lp", "sorted", "csr"), 1)])
def test_bulk_materialize_over_hash_tables_matches_oracle(mode, kinds, chunk_factor):
    n_joins = len(kinds)
    keys, payloads = gen_rhs_table(48, chunk_factor)
    probe = gen_probe_table(300, n_joins, 64)
    ours, _ = _tables(kinds, keys, payloads)
    got = bulk.bulk_materialize(ours, probe, mode)
    want = oracle.oracle_pipeline(probe, [oracle.OracleBuildTable(keys, payloads)] * n_joins, mode)
    assert got.dtype == torch.int64 and got.shape == want.shape
    oracle.assert_same_multiset(got.numpy(), want)


@pytest.mark.parametrize("kind", ["lp", "csr"])
def test_bulk_materialize_rows_equal_jax(kind):
    """Same rows in the same order as the JAX package: the compaction of
    the candidate grid keeps its row-major order, as JAX's stable argsort
    does."""
    keys, payloads = gen_rhs_table(48, 2)
    probe = gen_probe_table(300, 2, 64)
    ours, theirs = _tables([kind, kind], keys, payloads)
    got = bulk.bulk_materialize(ours, probe, PayloadMode.FULL)
    want = jax_bulk.bulk_materialize(theirs, probe, JaxPayloadMode.FULL)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("engine", ["hash_lp", "hash_csr"])
def test_config1_single_join_on_hash_engines(engine):
    keys, payloads = gen_rhs_table(4096, 1)
    probe = gen_probe_table(65536, 1, 4096)
    got = config1_single_join(n_build=4096, n_probe=65536, engine=engine, device="cpu")
    assert (got["count"], got["checksum"]) == numpy_totals(keys, payloads, probe[:, 0])
    builder = jax_ht.build_lp if engine == "hash_lp" else jax_ht.build_csr
    want = jax_bulk.bulk_count([builder(keys, payloads)], probe)
    assert got["count"] == int(want.count) and got["checksum"] == int(want.payload_checksums[0])
    assert got["engine"] == engine and got["build_seconds"] > 0
    with pytest.raises(ValueError, match="engine"):
        config1_single_join(n_build=16, n_probe=64, engine="hash", device="cpu")


@pytest.mark.parametrize("engine", ["hash_lp", "hash_csr"])
def test_cli_tiny_config1_hash_engines(capsys, engine):
    proc = _run(["-m", "ccve_tpu_torch.cli", "baseline", "--config", "1", "--tiny",
                 "--engine", engine, "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    keys, payloads = gen_rhs_table(4096, 1)
    expected = numpy_totals(keys, payloads, gen_probe_table(65536, 1, 4096)[:, 0])
    assert (got["count"], got["checksum"]) == expected
    assert got["count"] == 65525 and got["engine"] == engine and got["device"] == "cpu"
    for extra in (["--materialize"], ["--wide-span", "40"]):
        assert cli.main(["baseline", "--config", "1", "--tiny", "--engine", engine,
                         "--device", "cpu", *extra]) == 2
        assert "does not combine" in capsys.readouterr().err
