"""The port's numpy generators are bit-exact with `ccve_tpu.core.datagen`
(both its native and its numpy generator)."""

import numpy as np
import pytest

from ccve_tpu.core import datagen as jax_datagen
from ccve_tpu_torch.core import datagen


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize(
    "n_rows, n_cols, rhs_size",
    [(1, 1, 1), (1000, 1, 100), (5000, 3, 777), (70_001, 2, 4096), (65_536, 1, 4096)],
)
def test_probe_table_bit_exact(use_native, n_rows, n_cols, rhs_size):
    want = jax_datagen.gen_probe_table(n_rows, n_cols, rhs_size, use_native=use_native)
    got = datagen.gen_probe_table(n_rows, n_cols, rhs_size)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_rhs", [1, 7, 96, 1000, 1001])
@pytest.mark.parametrize("chunk_factor", [1, 2, 3, 4, 7])
def test_rhs_table_bit_exact(n_rhs, chunk_factor):
    want = jax_datagen.gen_rhs_table(n_rhs, chunk_factor)
    got = datagen.gen_rhs_table(n_rhs, chunk_factor)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 2, 5489, 2**32 - 1])
def test_mt19937_stream(seed):
    ours, theirs = datagen.MT19937(seed), jax_datagen.MT19937(seed)
    for n in (1, 623, 624, 2000, 5):  # draws across block boundaries
        np.testing.assert_array_equal(ours.draw(n), theirs.draw(n))


@pytest.mark.parametrize("lo, hi", [(0, 0), (0, 1), (-5, 5), (0, 2**31 - 2)])
def test_uniform_int_stream(lo, hi):
    got = datagen.uniform_int_stream(datagen.MT19937(7), 3000, lo, hi)
    want = jax_datagen.uniform_int_stream(jax_datagen.MT19937(7), 3000, lo, hi)
    np.testing.assert_array_equal(got, want)
