"""The port's probe micro-benchmark against the JAX package's: glibc
`rand()` bit-exact with JAX's numpy `GlibcRand`, the micro-benchmark's key
stream equal, and the bulk, staged and phased variants over LP and CSR
counting the tuples JAX's count, at small n. `cli microbench` prints the
same counts."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ccve_tpu.core import datagen as jdg
from ccve_tpu_torch.core import datagen as tdg

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", [1, 2, 12345, 2**31 - 2])
def test_glibc_rand_bit_exact(seed):
    """Draws of 1, 1023, 1024, 1025 and 2500 outputs in a row continue one
    stream, as in JAX."""
    with np.errstate(over="ignore"):
        j, t = jdg.GlibcRand(seed), tdg.GlibcRand(seed)
        for n in (1, 1023, 1024, 1025, 2500):
            a, b = j.draw(n), t.draw(n)
            assert a.dtype == b.dtype == np.int64
            assert np.array_equal(a, b), n


def test_glibc_rand_first_outputs():
    """glibc's srand(1) stream starts 1804289383, 846930886, 1681692777."""
    assert tdg.GlibcRand(1).draw(3).tolist() == [1804289383, 846930886, 1681692777]


@pytest.mark.parametrize("rhs_tuples, hit_freq", [(128, 1), (256, 2), (512, 4)])
def test_microbench_keys_match_jax(rhs_tuples, hit_freq):
    with np.errstate(over="ignore"):
        want = jdg.gen_microbench_keys(5000, rhs_tuples, hit_freq, use_native=False)
    got = tdg.gen_microbench_keys(5000, rhs_tuples, hit_freq)
    assert np.array_equal(got, want)
    assert got.max() < rhs_tuples * hit_freq


@pytest.mark.parametrize("scale, hit_freq, chunk_factor, n_keys",
                         [(0, 1, 1, 1 << 13), (1, 2, 4, 5 << 10)])
def test_variants_count_what_jax_counts(scale, hit_freq, chunk_factor, n_keys):
    from ccve_tpu.bench.micro import run_micro_bench as jax_micro
    from ccve_tpu_torch.bench.micro import report, run_micro_bench

    want = jax_micro(scale=scale, hit_freq=hit_freq, chunk_factor=chunk_factor, n_keys=n_keys)
    got = run_micro_bench(scale=scale, hit_freq=hit_freq, chunk_factor=chunk_factor,
                          n_keys=n_keys, device="cpu")
    assert [r.name for r in got] == [r.name for r in want]
    assert [r.tuples for r in got] == [r.tuples for r in want]
    assert [r.n_keys for r in got] == [r.n_keys for r in want]
    phased = [r for r in got if r.name.startswith("phased")]
    assert all(set(r.phase_seconds) == {"hash", "match", "gather", "advance"} for r in phased)
    assert "[Phase] total" in report(got)


def test_variants_refuse_to_disagree():
    """A stream that is no whole number of chunks: the staged variants
    scan fewer keys than the bulk ones, and the run raises, as JAX's."""
    from ccve_tpu_torch.bench.micro import run_micro_bench

    with pytest.raises(AssertionError, match="disagree"):
        run_micro_bench(n_keys=1000, device="cpu")


def test_cli_microbench():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "ccve_tpu_torch.cli", "microbench", "--n-keys", "4096",
         "--variants", "bulk,staged", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [line for line in proc.stderr.splitlines() if "#tuples" in line]
    assert [line.split()[0] for line in lines] == [
        "bulk_fused_lp", "bulk_fused_csr", "staged_scan_lp", "staged_scan_csr"]
    assert {line.split("#tuples")[1].split()[0] for line in lines} == {"4096"}
