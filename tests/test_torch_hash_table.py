"""The port's hash tables (`ops.hash_table`, on the CPU) against the JAX
package: LP and CSR builds array for array, and the candidate grids of
both. Tolerance 0: slots, offsets, keys and payloads are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.core.datagen import gen_probe_table, gen_rhs_table
from ccve_tpu.ops import hash_table as jax_ht
from ccve_tpu_torch.ops import hash_table as ht


def _host(chunk_factor, default_payloads, n=300):
    keys, payloads = gen_rhs_table(n, chunk_factor)
    return keys, (None if default_payloads else payloads * 3 - 7)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("chunk_factor", [1, 3])
@pytest.mark.parametrize("default_payloads", [False, True])
def test_build_lp_matches_jax(chunk_factor, default_payloads):
    keys, payloads = _host(chunk_factor, default_payloads)
    got = ht.build_lp(keys, payloads, device="cpu")
    want = jax_ht.build_lp(keys, payloads)
    np.testing.assert_array_equal(got.slot_keys.numpy(), _np(want.slot_keys))
    np.testing.assert_array_equal(got.slot_payloads.numpy(), _np(want.slot_payloads))
    assert got.max_run == want.max_run > 0
    assert got.n_slots == want.n_slots == ht.next_pow2(4 * keys.size)
    assert got.device == torch.device("cpu")


@pytest.mark.parametrize("chunk_factor", [1, 3])
@pytest.mark.parametrize("default_payloads", [False, True])
def test_build_csr_matches_jax(chunk_factor, default_payloads):
    keys, payloads = _host(chunk_factor, default_payloads)
    got = ht.build_csr(keys, payloads, device="cpu")
    want = jax_ht.build_csr(keys, payloads)
    assert got.offsets.dtype == torch.int32
    np.testing.assert_array_equal(got.offsets.numpy(), _np(want.offsets))
    np.testing.assert_array_equal(got.entry_keys.numpy(), _np(want.entry_keys))
    np.testing.assert_array_equal(got.entry_payloads.numpy(), _np(want.entry_payloads))
    assert got.max_len == want.max_len > 0
    assert got.n_buckets == want.n_buckets


def test_empty_and_random_key_builds_match_jax():
    rng = np.random.default_rng(4)
    for keys in (np.zeros(0, np.int64), rng.integers(-(2**63), 2**63 - 1, 200, dtype=np.int64)):
        lp, jlp = ht.build_lp(keys, device="cpu"), jax_ht.build_lp(keys)
        np.testing.assert_array_equal(lp.slot_keys.numpy(), _np(jlp.slot_keys))
        assert lp.max_run == jlp.max_run
        csr, jcsr = ht.build_csr(keys, device="cpu"), jax_ht.build_csr(keys)
        np.testing.assert_array_equal(csr.offsets.numpy(), _np(jcsr.offsets))
        np.testing.assert_array_equal(csr.entry_payloads.numpy(), _np(jcsr.entry_payloads))
        assert csr.max_len == jcsr.max_len


def test_longest_circular_run_wraps():
    occ = np.array([1, 1, 0, 0, 1, 0, 1, 1, 1], dtype=bool)
    assert ht._longest_circular_run(occ) == 5  # slots 6, 7, 8, 0, 1
    assert ht._longest_circular_run(np.ones(4, bool)) == 4
    assert ht._longest_circular_run(np.zeros(4, bool)) == 0


def test_builds_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (ht.build_lp, ht.build_csr):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(np.arange(4))


def _grid_equal(got, want):
    match = np.asarray(want.match)
    np.testing.assert_array_equal(got.match.numpy(), match)
    np.testing.assert_array_equal(got.keys.numpy()[match], np.asarray(want.keys)[match])
    np.testing.assert_array_equal(got.payloads.numpy()[match], np.asarray(want.payloads)[match])


@pytest.mark.parametrize("chunk_factor", [1, 3])
def test_expand_grids_match_jax(chunk_factor):
    keys, payloads = gen_rhs_table(200, chunk_factor)
    probe = gen_probe_table(1500, 1, 260)[:, 0]
    lp = ht.build_lp(keys, payloads, device="cpu")
    grid = ht.lp_expand_grid(lp, torch.from_numpy(probe))
    assert grid.match.shape == (1500, lp.max_run)
    _grid_equal(grid, jax_ht.lp_expand_grid(jax_ht.build_lp(keys, payloads), jnp.asarray(probe)))
    csr = ht.build_csr(keys, payloads, device="cpu")
    grid = ht.csr_expand_grid(csr, torch.from_numpy(probe.astype(np.int32)))
    assert grid.match.shape == (1500, csr.max_len)
    _grid_equal(grid, jax_ht.csr_expand_grid(jax_ht.build_csr(keys, payloads), jnp.asarray(probe)))
    # every match is one of the oracle's: per row, as many as the key's copies
    counts = np.bincount(keys, minlength=261)
    np.testing.assert_array_equal(grid.match.numpy().sum(axis=1), counts[probe])


def test_lp_duplicate_keys_probe():
    """Duplicate build keys sit in one run; the LP drain emits one row per
    duplicate (linear_probing_ht semantics), as the JAX package's test."""
    keys = np.array([7, 7, 7, 9, 9, 1], dtype=np.int64)
    table = ht.build_lp(keys, np.arange(6), device="cpu")
    grid = ht.lp_expand_grid(table, torch.tensor([7, 9, 1, 4]))
    assert grid.match.sum(dim=1).tolist() == [3, 2, 1, 0]
    assert sorted(grid.payloads[0][grid.match[0]].tolist()) == [0, 1, 2]


def test_empty_csr_grid_has_no_matches():
    table = ht.build_csr(np.zeros(0, np.int64), device="cpu")
    grid = ht.csr_expand_grid(table, torch.arange(5))
    assert grid.match.shape == (5, 1) and not grid.match.any()
