"""The port's LSD radix sort (`ops.sort`, on the CPU) against the JAX
package on the same numpy inputs: equal permutations, not only equal
sorted keys. Tolerance 0: permutations and keys are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.core.datagen import gen_zipf_keys
from ccve_tpu.ops import sort as jax_sort
from ccve_tpu_torch.ops import sort


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [512, 4096 * 3 + 17])
def test_radix_sort_matches_numpy_and_jax(n):
    rng = np.random.default_rng(1)
    keys = rng.integers(-(2**62), 2**62, size=n).astype(np.int64)
    got = sort.radix_sort(_t(keys), tile=256, bits=64)
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))
    np.testing.assert_array_equal(
        sort.radix_argsort(_t(keys), tile=256, bits=64).numpy(),
        np.asarray(jax_sort.radix_argsort(jnp.asarray(keys), 256, 64)))


def test_radix_argsort_stable():
    keys = np.array([3, 1, 3, 1, 2, 2, 3] * 40, dtype=np.int64)
    perm = sort.radix_argsort(_t(keys), tile=128, bits=8)
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(jax_sort.radix_argsort(jnp.asarray(keys), 128, 8)))


@pytest.mark.parametrize("bits, tile, seg_tiles", [(8, 128, 2), (12, 64, 3), (17, 256, 1),
                                                   (64, 64, 5)])
def test_radix_argsort_permutation_matches_jax(bits, tile, seg_tiles):
    """Keys of mixed magnitude, both signs, the int64 extremes and INT64_MAX
    itself (the padding's key): with `bits` < 64 the high bits are masked
    away, so the permutation is the stable order of the low bits, JAX's
    exactly."""
    rng = np.random.default_rng(bits)
    n = 3 * tile * seg_tiles + 11
    keys = np.concatenate([
        rng.integers(0, 300, n // 3),
        rng.integers(-(2**63), 2**63 - 1, n // 3, dtype=np.int64),
        rng.integers(-5, 5, n - 2 * (n // 3) - 3),
        [2**63 - 1, -(2**63), 2**63 - 1],
    ]).astype(np.int64)
    rng.shuffle(keys)
    got = sort.radix_argsort(_t(keys), tile, bits, seg_tiles).numpy()
    want = np.asarray(jax_sort.radix_argsort(jnp.asarray(keys), tile, bits, seg_tiles))
    np.testing.assert_array_equal(got, want)
    if bits == 64:
        np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))


def test_radix_sort_pairs_zipf():
    keys = gen_zipf_keys(3000, 256, alpha=1.3)
    vals = np.arange(3000, dtype=np.int64)
    k, v = sort.radix_sort_pairs(_t(keys), _t(vals), tile=256, bits=16)
    jk, jv = jax_sort.radix_sort_pairs(jnp.asarray(keys), jnp.asarray(vals), tile=256, bits=16)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k.numpy(), keys[order])
    np.testing.assert_array_equal(v.numpy(), vals[order])
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_xla_sort_pairs_matches_jax(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(-3, 4, n).astype(np.int64)  # many ties
    vals = rng.integers(-(2**62), 2**62, n).astype(np.int64)
    k, v = sort.xla_sort_pairs(_t(keys), _t(vals))
    jk, jv = jax_sort.xla_sort_pairs(jnp.asarray(keys), jnp.asarray(vals))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_radix_argsort_refuses_bad_bits():
    with pytest.raises(ValueError, match="bits"):
        sort.radix_argsort(torch.arange(4), bits=0)
