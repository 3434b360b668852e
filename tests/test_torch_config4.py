"""Config 4 in the port, on the CPU, against the JAX package: the Zipf key
generator bit for bit, the device CSR build array for array, and
`config4_zipf_pipeline` and `cli baseline --config 4` at small sizes.
Tolerance 0: the partition skew is the same float ratio of the same
integer histogram."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.bench import configs as jax_configs
from ccve_tpu.core import datagen as jax_datagen
from ccve_tpu.ops import hash_table as jax_ht
from ccve_tpu_torch.bench import configs
from ccve_tpu_torch.core import datagen
from ccve_tpu_torch.ops import hash_table as ht

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n, domain, alpha, seed", [
    (5000, 100, 1.1, 7), (40_000, 512, 1.3, 7), (12_345, 100_000, 0.9, 3)])
def test_gen_zipf_keys_bit_exact(n, domain, alpha, seed):
    got = datagen.gen_zipf_keys(n, domain, alpha, seed)
    want = jax_datagen.gen_zipf_keys(n, domain, alpha, seed)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n, chunk_factor", [(100, 2), (3000, 1), (1000, 7)])
def test_build_csr_device_matches_jax_and_build_csr(n, chunk_factor):
    keys, payloads = datagen.gen_rhs_table(n, chunk_factor)
    host = ht.build_csr(keys, payloads, device="cpu")
    got = ht.build_csr_device(torch.from_numpy(keys), torch.from_numpy(payloads),
                              host.n_buckets, host.max_len)
    want = jax_ht.build_csr_device(jnp.asarray(keys), jnp.asarray(payloads),
                                   host.n_buckets, host.max_len)
    assert got.offsets.dtype == torch.int32 and got.max_len == host.max_len
    for field in ("offsets", "entry_keys", "entry_payloads"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), getattr(host, field).numpy(),
                                      err_msg=field)
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)


def test_build_csr_device_random_keys_and_refusals():
    rng = np.random.default_rng(5)
    keys = rng.integers(-(2**63), 2**63 - 1, 500, dtype=np.int64)
    host = ht.build_csr(keys, device="cpu")
    got = ht.build_csr_device(torch.from_numpy(keys), torch.arange(500) + 10_000_000,
                              host.n_buckets, host.max_len)
    assert torch.equal(got.offsets, host.offsets)
    assert torch.equal(got.entry_payloads, host.entry_payloads)
    with pytest.raises(ValueError, match="power of two"):
        ht.build_csr_device(torch.from_numpy(keys), torch.from_numpy(keys), 1000, 4)


def test_config4_tiny_matches_jax():
    kw = dict(n_probe=40_000, domain=512, alpha=1.3)
    got = configs.config4_zipf_pipeline(device="cpu", **kw)
    want = jax_configs.config4_zipf_pipeline(**kw)
    assert got["name"] == want["name"] == "config4_zipf_pipeline"
    assert got["matches"] == want["matches"] == 40_000
    assert got["n_groups"] == want["n_groups"] <= 512
    assert got["partition_skew_16"] == want["partition_skew_16"]
    assert got["seconds"] > 0 and got["rows_per_s"] > 0
    assert got["device"] == "cpu" and got["timer"] == "host clock"
    assert "single_dispatch_seconds" not in got


def test_config4_numpy_answers_match_jax_run():
    """The numpy answers the config asserts (matches, n_groups, the ORDER BY's
    last pair, the 16-way histogram) equal the JAX package's own ops on the
    same keys."""
    from ccve_tpu.ops.aggregate import join_dense_aggregate, partition_histogram
    from ccve_tpu.ops.sort import xla_sort_pairs
    from ccve_tpu.ops.sort_merge import build_sorted

    domain, probe = 700, jax_datagen.gen_zipf_keys(30_000, 700, 1.2)
    matches, n_groups, top, hist = configs.config4_numpy(probe, domain)
    agg, total = join_dense_aggregate(build_sorted(*jax_datagen.gen_rhs_table(domain, 1)),
                                      jnp.asarray(probe), domain)
    sk, sv = xla_sort_pairs(agg.sum, agg.keys)
    assert (matches, n_groups, top) == (int(total), int(agg.n_groups), (int(sk[-1]), int(sv[-1])))
    np.testing.assert_array_equal(hist, np.asarray(partition_histogram(jnp.asarray(probe), 16)))


def _cli(*args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-m", "ccve_tpu_torch.cli", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_tiny_config4_matches_jax():
    proc = _cli("baseline", "--config", "4", "--tiny", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = jax_configs.config4_zipf_pipeline(n_probe=50_000, domain=1024)
    assert (got["n_probe"], got["domain"]) == (50_000, 1024)
    assert (got["matches"], got["n_groups"]) == (want["matches"], want["n_groups"])
    assert got["partition_skew_16"] == want["partition_skew_16"]


def test_cli_config5_still_exits_2():
    """The name is from before slice 9: `baseline --config 5` runs now,
    and its tiny run equals the JAX package's count."""
    proc = _cli("baseline", "--config", "5", "--tiny", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = jax_configs.config5_distributed(n_build=2048, n_probe=20_000, n_devices=1)
    assert (got["name"], got["n_devices"], got["n_build"], got["n_probe"]) == (
        "config5_distributed", 1, 2048, 20_000)
    assert got["skew"] == want["skew"] == 1.0
    assert got["overflow"] is want["overflow"] is False
    keys, payloads = jax_datagen.gen_rhs_table(2048, 1)
    probe = jax_datagen.gen_probe_table(20_000, 1, 2048)
    count, checksum = configs.numpy_totals(keys, payloads, probe[:, 0])
    assert (got["count"], got["payload_checksums"]) == (count, [checksum])