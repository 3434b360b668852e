"""The port's slices as a whole: the CLI against the JAX package's configs
1 and 3 and its materializing config 1, no JAX anywhere in the port, and
no CPU fallback in `chip_smoke.py`."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(args, cwd=ROOT, timeout=300):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
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
    assert got["n_joins"] == 4 and got["device"] == "cpu"


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
        (["--config", "2"], "not ported yet"),
        (["--config", "4"], "not ported yet"),
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
    assert int(n_modules) >= 19
    for name in ("config", "exec.oracle", "exec.bulk", "kernels.pairsort",
                 "kernels.compact", "kernels.merge_scan", "ops.sort_merge",
                 "ops.hashing", "ops.hash_table", "kernels.murmur"):
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
