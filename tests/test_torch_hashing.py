"""The port's murmur64 (`ops.hashing`, `kernels.murmur`; plain version, on
the CPU) against the JAX package's jnp, numpy and pure-Python hashes and
its Pallas kernel #12 in interpret mode. Tolerance 0: hashes are
integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.murmur import murmurhash64_pallas
from ccve_tpu.ops import hashing as jax_hashing
from ccve_tpu_torch.kernels import murmur
from ccve_tpu_torch.ops import hashing
from torch_interpret import interpret

EXTREMES = [0, 1, -1, -(2**63), 2**63 - 1, 2**32 - 1, 2**32, -(2**32)]


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64, endpoint=True),
        np.array(EXTREMES, dtype=np.int64),
    ])


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("n", [0, 1, 1001, 100_003])
def test_murmurhash64_matches_jax_and_numpy(n):
    x = _keys(n, n)  # unaligned lengths: n + 8
    got = _bits(hashing.murmurhash64(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, np.asarray(jax_hashing.murmurhash64(jnp.asarray(x))))
    np.testing.assert_array_equal(got, jax_hashing.murmurhash64_np(x))
    np.testing.assert_array_equal(hashing.murmurhash64_np(x), jax_hashing.murmurhash64_np(x))


def test_murmurhash64_matches_python():
    x = _keys(500, 7)
    got = _bits(hashing.murmurhash64(torch.from_numpy(x)))
    want = [jax_hashing.murmurhash64_py(int(v)) for v in x]
    assert got.tolist() == want
    assert [hashing.murmurhash64_py(int(v)) for v in x] == want
    assert hashing.MURMUR_MULTIPLIER == jax_hashing.MURMUR_MULTIPLIER


def test_int32_keys_widen_as_jax_does():
    x = np.array([0, 1, -1, -(2**31), 2**31 - 1, 12345], dtype=np.int32)
    got = _bits(hashing.murmurhash64(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, np.asarray(jax_hashing.murmurhash64(jnp.asarray(x))))


def test_murmur_plain_matches_pallas_kernel():
    """Kernel #12 in interpret mode, as the JAX package's own tests run it:
    4096 random keys and the extremes."""
    x = _keys(4088, 3)
    want = np.asarray(interpret(murmurhash64_pallas, jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(murmur.murmurhash64_plain(torch.from_numpy(x))), want)


def test_wrapper_on_cpu_runs_the_plain_version_and_checks_its_input():
    x = torch.from_numpy(_keys(100, 1))
    before = murmur.murmurhash64_i64.launches
    assert torch.equal(murmur.murmurhash64_i64(x), murmur.murmurhash64_plain(x))
    assert murmur.murmurhash64_i64.launches == before  # no kernel on the CPU
    with pytest.raises(TypeError):
        murmur.murmurhash64_i64(x.to(torch.int32))
    with pytest.raises(ValueError):
        murmur.murmurhash64_i64(x.reshape(2, -1))
    with pytest.raises(TypeError):
        hashing.murmurhash64(x.to(torch.float64))
