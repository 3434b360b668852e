"""The cursor executor through the port's CLI: `baseline --config 2` and
`--config 6` at the JAX CLI's tiny sizes against the JAX package's oracle
on the JAX generators, config 3's cursor entries over CSR and LP, and
`strategy-matrix`."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-m", "ccve_tpu_torch.cli", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)


def _baseline(config: int) -> dict:
    proc = _run(["baseline", "--config", str(config), "--tiny", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cli_tiny_config2_matches_jax_oracle():
    """5000 probe rows behind key % 10 == 0 against 512 build rows (chunk
    factor 2), block 256: FULL and DYNAMIC on the cursor executor and FULL
    on the sorted executor count what JAX's oracle counts (each count is
    asserted inside)."""
    from ccve_tpu.config import PayloadMode
    from ccve_tpu.core.datagen import gen_probe_table, gen_rhs_table
    from ccve_tpu.exec.oracle import OracleBuildTable, oracle_pipeline

    got = _baseline(2)
    probe = gen_probe_table(5000, 1, 512)
    kept = probe[probe[:, 0] % 10 == 0]
    want = oracle_pipeline(kept, [OracleBuildTable(*gen_rhs_table(512, 2))],
                           PayloadMode.REFERENCE).shape[0]
    assert got["expected"] == want and got["name"] == "config2_filtered_join"
    for case in ("full_compaction", "dynamic_compaction"):
        assert got[case]["seconds"] > 0 and got[case]["level_steps"][0] > 0
    assert got["sorted_full"]["preloaded_seconds"] > 0


def test_cli_tiny_config6_matches_jax_oracle():
    """65536 rows x 2 levels in phases of 32 chunks of 256: its four runs
    count what JAX's oracle counts on JAX's data; the device tuner
    reports its commits."""
    from ccve_tpu.config import PayloadMode
    from ccve_tpu.core.datagen import gen_rhs_table
    from ccve_tpu.exec.oracle import OracleBuildTable, oracle_pipeline

    got = _baseline(6)
    lhs, rhs, mod = 65536, 2048, 10
    rng = np.random.default_rng(7)
    probe = np.empty((lhs, 2), np.int64)
    phase = (np.arange(lhs) // (32 * 256)) % 2
    probe[:, 0] = rng.integers(0, rhs, lhs)
    probe[phase == 0, 0] = rng.integers(0, rhs // mod, int((phase == 0).sum())) * mod
    probe[:, 1] = rng.integers(0, rhs, lhs)
    kept = probe[probe[:, 0] % mod == 0]
    want = oracle_pipeline(kept, [OracleBuildTable(*gen_rhs_table(rhs, 1))] * 2,
                           PayloadMode.REFERENCE).shape[0]
    assert got["expected"] == want
    for case in ("no_compaction", "full_compaction", "dynamic_compaction",
                 "dynamic_compaction_device"):
        assert got[case]["seconds"] > 0
    steps = {case: got[case]["level_steps"] for case in ("no_compaction", "full_compaction")}
    assert steps["no_compaction"][0] == steps["full_compaction"][0]  # level 0 sees the same chunks
    assert steps["full_compaction"][1] < steps["no_compaction"][1]
    device = got["dynamic_compaction_device"]
    assert set(device["greedy_thresholds"]) <= {0, 128, 192, 256}
    assert len(device["bandit_committed"]) == 2 and got["dynamic_vs_best_static"] > 0


def test_cli_tiny_config3_cursor_entries():
    """Config 3's cursor entries over CSR (the CLI's) count the oracle's
    251, as its bulk and sorted entries do; FULL takes fewer steps below
    level 0 than NONE."""
    got = _baseline(3)
    assert got["table_kind"] == "csr" and got["count"] == got["expected"] == 251
    none, full = got["no_compaction"]["level_steps"], got["full_compaction"]["level_steps"]
    assert none[0] == full[0] and all(f < n for f, n in zip(full[1:], none[1:]))


def test_config3_cursor_over_lp():
    from ccve_tpu_torch.bench.configs import config3_four_way

    got = config3_four_way(lhs=4000, rhs=256, block=256, table_kind="lp", device="cpu")
    assert got["table_kind"] == "lp" and got["count"] == 251
    assert got["full_compaction"]["level_steps"][0] > 0


@pytest.mark.parametrize("table", ["csr", "lp"])
def test_cli_strategy_matrix(table):
    """Every strategy in turn on the cursor executor, each counting what
    the oracle counts."""
    from ccve_tpu.core.datagen import gen_probe_table, gen_rhs_table
    from ccve_tpu.exec.oracle import OracleBuildTable, oracle_pipeline

    proc = _run(["strategy-matrix", "--join-num", "2", "--lhs-size", "3000", "--rhs-size", "256",
                 "--block-size", "256", "--table", table, "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    want = oracle_pipeline(gen_probe_table(3000, 2, 256),
                           [OracleBuildTable(*gen_rhs_table(256, 2))] * 2).shape[0]
    lines = proc.stderr.splitlines()
    assert [line for line in lines if line.startswith("==== strategy")] == [
        f"==== strategy: {s} ====" for s in ("none", "full", "binary", "dynamic")]
    assert lines.count(f" [Result Rows] {want}") == 4
    assert all(f"table: {table}, executor: pipeline" in line
               for line in lines if line.startswith(" [Settings]"))
