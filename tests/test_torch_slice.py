"""The port's slices as a whole: the CLI against the JAX package's configs
1, 3 and 7, its materializing config 1 and its known-good `pipeline`
command, no JAX anywhere in the port, and no CPU fallback in
`chip_smoke.py`."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(args, cwd=ROOT, timeout=300, repo_on_path=False):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if repo_on_path:  # for a run in another directory
        env["PYTHONPATH"] = str(ROOT)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


def test_cli_tiny_config1_matches_jax():
    from ccve_tpu.bench.configs import config1_single_join
    from ccve_tpu.core.datagen import gen_probe_table, gen_rhs_table

    proc = _run(["-m", "ccve_tpu_torch.cli", "baseline", "--config", "1", "--tiny",
                 "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = config1_single_join(n_build=4096, n_probe=65536)
    assert got["count"] == want["count"]
    assert got["device"] == "cpu" and got["timer"] == "host clock"
    keys, payloads = gen_rhs_table(4096, 1)  # unique keys, ascending
    probe = gen_probe_table(65536, 1, 4096)[:, 0]
    idx = np.minimum(np.searchsorted(keys, probe), keys.size - 1)
    hit = keys[idx] == probe
    assert got["checksum"] == int(payloads[idx[hit]].sum())


def test_cli_tiny_config3_matches_jax():
    """Config 3's bulk engine at the JAX CLI's tiny size: count and the
    four checksums against the JAX package's bulk_count and its oracle."""
    from ccve_tpu.config import PayloadMode
    from ccve_tpu.core.datagen import gen_probe_table, gen_rhs_table
    from ccve_tpu.exec.bulk import bulk_count
    from ccve_tpu.exec.oracle import OracleBuildTable, oracle_pipeline
    from ccve_tpu.ops.sort_merge import build_sorted

    proc = _run(["-m", "ccve_tpu_torch.cli", "baseline", "--config", "3", "--tiny",
                 "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    probe = gen_probe_table(4000, 4, 512)
    keys, payloads = gen_rhs_table(256, 1)
    want = bulk_count([build_sorted(keys, payloads)] * 4, probe)
    rows = oracle_pipeline(probe, [OracleBuildTable(keys, payloads)] * 4, PayloadMode.FULL)
    assert got["count"] == got["expected"] == int(want.count) == rows.shape[0]
    assert got["payload_checksums"] == [int(c) for c in want.payload_checksums]
    assert got["n_joins"] == 4 and got["device"] == "cpu" and got["block"] == 256
    for strategy in ("no_compaction", "full_compaction"):  # counts asserted inside
        assert got[f"sorted_{strategy}"]["preloaded_seconds"] > 0


def test_cli_tiny_config7_matches_jax_oracle():
    """Config 7 at the JAX CLI's tiny size (16384 x 4 levels, 512 build
    keys, block 256): its three static policies and the device tuner count
    what the JAX package's oracle counts on the JAX generators (each count
    is asserted inside)."""
    from ccve_tpu.core.datagen import gen_rhs_table
    from ccve_tpu.exec.oracle import OracleBuildTable, oracle_pipeline

    proc = _run(["-m", "ccve_tpu_torch.cli", "baseline", "--config", "7", "--tiny",
                 "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    rng = np.random.default_rng(2)
    probe = np.stack([rng.integers(0, max(int(512 / h), 1), size=16384, dtype=np.int64)
                      for h in (0.95, 0.03, 1.0, 1.0)], axis=1)
    want = oracle_pipeline(probe, [OracleBuildTable(*gen_rhs_table(512, 1))] * 4).shape[0]
    assert got["expected"] == got["bulk_count"] == want == 451
    for case in ("no_compaction", "full_compaction", "mixed_static",
                 "dynamic_compaction_device"):
        assert got[case]["seconds"] > 0
    dynamic = got["dynamic_compaction_device"]
    assert set(dynamic["greedy_thresholds"]) <= {0, 256} and len(dynamic["bandit_committed"]) == 4
    assert sum(map(sum, dynamic["bandit_n_sel"])) == 4 * 16  # 64 chunks, 4 a segment
    assert got["dynamic_vs_best_static"] > 0


KNOWN_GOOD = ["pipeline", "--join-num", "2", "--chunk-factor", "2", "--lhs-size", "3000",
              "--rhs-size", "256", "--block-size", "256", "--table", "sorted", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    ["--executor", "sorted", "--strategy", "full"],
    ["--executor", "sorted", "--strategy", "binary", "--preload"],
    ["--executor", "bulk", "--strategy", "full"],
    ["--executor", "sorted", "--strategy", "dynamic"],
    ["--executor", "sorted", "--strategy", "full", "--record-occupancy"],
    ["--executor", "sorted", "--strategy", "full", "--zebra-profile"],
])
def test_cli_pipeline_known_good(extra, tmp_path):
    """The JAX CLI's known-good pipeline command: [Result Rows] 2992, as
    the JAX package's oracle counts on its generators, also with the host
    tuner, the occupancy histograms and the Zebra profile (run in
    `tmp_path`, where it writes its CSVs, as the JAX CLI reports: two
    measured segments)."""
    from ccve_tpu.core.datagen import gen_probe_table, gen_rhs_table
    from ccve_tpu.exec.oracle import OracleBuildTable, oracle_pipeline

    zebra = "--zebra-profile" in extra
    proc = _run(["-m", "ccve_tpu_torch.cli", *KNOWN_GOOD, *extra],
                cwd=tmp_path if zebra else ROOT, repo_on_path=zebra)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stderr.splitlines()
    assert lines[0].startswith(" [Settings] #joins: 2")
    assert any(line.startswith(" [Total Time] ") for line in lines)
    assert any(line.startswith(" [Bee] [Generate Data]") for line in lines)
    want = oracle_pipeline(gen_probe_table(3000, 2, 256),
                           [OracleBuildTable(*gen_rhs_table(256, 2))] * 2).shape[0]
    assert " [Result Rows] 2992" in lines and want == 2992
    if zebra:
        (log_dir,) = tmp_path.iterdir()
        assert log_dir.name.startswith("zebra_log_0x")
        assert f" [Zebra] 2 measured segments -> ./{log_dir.name}/" in lines
        assert sorted(p.name for p in log_dir.iterdir()) == [
            "level0_full_compaction.csv", "level1_full_compaction.csv"]


@pytest.mark.parametrize("table", ["csr", "lp"])
def test_cli_pipeline_unported_exits_2(table):
    """The cursor executor (`--executor pipeline`, the default), which
    exited 2 before slice 6, runs the known-good command to the oracle's
    count over either hash table; the flag combinations no executor takes
    still exit 2."""
    from ccve_tpu.core.datagen import gen_probe_table, gen_rhs_table
    from ccve_tpu.exec.oracle import OracleBuildTable, oracle_pipeline

    args = [a if a != "sorted" else table for a in KNOWN_GOOD]
    proc = _run(["-m", "ccve_tpu_torch.cli", *args, "--strategy", "full"])
    assert proc.returncode == 0, proc.stderr
    assert f"table: {table}, executor: pipeline" in proc.stderr
    want = oracle_pipeline(gen_probe_table(3000, 2, 256),
                           [OracleBuildTable(*gen_rhs_table(256, 2))] * 2).shape[0]
    assert " [Result Rows] 2992" in proc.stderr.splitlines() and want == 2992
    for refused, message in ((["--table", "sorted", "--executor", "pipeline"], "pairs with"),
                             (["--table", table, "--executor", "sorted"],
                              "requires --table sorted")):
        proc = _run(["-m", "ccve_tpu_torch.cli", "pipeline", "--lhs-size", "1000",
                     "--rhs-size", "100", "--device", "cpu", *refused])
        assert proc.returncode == 2 and message in proc.stderr


def test_cli_tiny_materialize_matches_jax():
    """Config 1 materialized at the JAX CLI's tiny size: the triple count
    and payload sum against the JAX package's config1_materialize and its
    count-side checksum."""
    from ccve_tpu.bench.configs import config1_materialize
    from ccve_tpu.core.datagen import gen_probe_table, gen_rhs_table
    from ccve_tpu.exec.bulk import bulk_count
    from ccve_tpu.ops.sort_merge import build_sorted

    proc = _run(["-m", "ccve_tpu_torch.cli", "baseline", "--config", "1", "--tiny",
                 "--materialize", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = config1_materialize(n_build=4096, n_probe=65536)
    assert got["tuples_out"] == want["tuples_out"]
    assert got["tiles"] == want["tiles"] == 1
    assert got["sampled_triples_ok"] == want["sampled_triples_ok"] == 256
    checksum = bulk_count([build_sorted(*gen_rhs_table(4096, 1))],
                          gen_probe_table(65536, 1, 4096)).payload_checksums[0]
    assert got["payload_checksum"] == int(checksum)


@pytest.mark.parametrize(
    "args, message",
    [
        # config 5 is ported (slice 9): its cases, whose ids date from before,
        # now check that it refuses config 1's flags
        pytest.param(["--config", "5", "--materialize"], "--config 1 only",
                     id="args0-not ported yet"),
        pytest.param(["--config", "5", "--engine", "hash_lp"], "--config 1 only",
                     id="args1-not ported yet"),
        (["--config", "3", "--materialize"], "--config 1 only"),
    ],
)
def test_cli_unported_exits_nonzero(args, message):
    proc = _run(["-m", "ccve_tpu_torch.cli", "baseline", "--tiny", "--device", "cpu", *args])
    assert proc.returncode != 0
    assert message in proc.stderr


def test_cli_without_gpu_does_not_fall_back():
    proc = _run(["-m", "ccve_tpu_torch.cli", "baseline", "--config", "1", "--tiny"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ccve_tpu_torch\n"
        "for m in pkgutil.walk_packages(ccve_tpu_torch.__path__, 'ccve_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ccve_tpu'))\n"
        "mine = sorted(m for m in sys.modules if m.startswith('ccve_tpu_torch'))\n"
        "print(len(mine), bad, ' '.join(mine))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules, _, names = proc.stdout.partition(" [] ")
    assert int(n_modules) >= 37
    for name in ("config", "exec.oracle", "exec.bulk", "kernels.pairsort",
                 "kernels.compact", "kernels.merge_scan", "ops.sort_merge",
                 "ops.hashing", "ops.hash_table", "kernels.murmur", "core.chunk",
                 "ops.compactor", "ops.filter", "kernels.drain", "exec.pipeline",
                 "exec.sorted_pipeline", "control.bandit", "control.device_bandit",
                 "utils.profiler", "kernels.chunk_probe", "device", "bench.small_probe",
                 "bench.roofline", "kernels.ce_stages", "core.collection", "bench.micro",
                 "bench.configs", "ops.aggregate", "ops.sort", "parallel",
                 "parallel.distributed", "parallel.dist_aggregate", "parallel.bootstrap",
                 "parallel.dryrun", "bench.dist_model"):
        assert f"ccve_tpu_torch.{name}" in names.split()


def test_chip_smoke_fails_without_gpu():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone, the script stops at its import of the port, before it asks
    for a device."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert "No module named 'ccve_tpu_torch'" in proc.stderr
    assert "no CUDA device" not in proc.stderr
    assert '"ok": true' not in proc.stdout
