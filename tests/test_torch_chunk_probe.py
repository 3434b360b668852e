"""The per-chunk ranks of the chunk rank mode (`kernels.chunk_probe`): the
plain version (on the CPU) against numpy's searchsorted and the JAX
package's `chunk_rank_xla`, and against its Pallas kernel `chunk_rank` in
interpret mode with the JAX package's own int32 packing. Exact: mult
everywhere, start where mult > 0 (JAX's kernel leaves it undefined
elsewhere; the port's is the lower bound)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.bigsort import I32_MAX
from ccve_tpu.kernels.chunk_probe import chunk_rank as jax_chunk_rank
from ccve_tpu.kernels.chunk_probe import chunk_rank_xla, stage_table_planes
from ccve_tpu_torch.kernels import chunk_probe
from torch_interpret import interpret

I64 = np.iinfo(np.int64)


def _case(seed, m, dom, count, block, lo=0):
    rng = np.random.default_rng(seed)
    table = np.sort(rng.integers(lo, lo + dom, m, dtype=np.int64))
    keys = rng.integers(lo - 5, lo + dom + 5, block, dtype=np.int64)
    valid = np.arange(block) < count
    return table, keys, valid


def _numpy(table, keys, valid):
    start = np.searchsorted(table, keys, side="left")
    mult = np.where(valid, np.searchsorted(table, keys, side="right") - start, 0)
    return mult.astype(np.int32), start.astype(np.int32)


CASES = [
    # (m, key domain, live lanes, block): tables around the block size,
    # partial counts, keys outside the table, duplicates, an empty table
    (500, 400, 256, 256),
    (30, 400, 170, 256),
    (256, 256, 0, 256),
    (700, 10, 256, 256),
    (128, 1000, 77, 128),
    (4000, 100, 2048, 2048),
    (0, 50, 128, 128),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_matches_numpy_and_jax(case):
    m, dom, count, block = CASES[case]
    table, keys, valid = _case(case, m, dom, count, block)
    want_mult, want_start = _numpy(table, keys, valid)
    t = torch.from_numpy
    mult, start = chunk_probe.chunk_rank(t(table), t(keys), t(valid))
    assert mult.dtype == start.dtype == torch.int32
    np.testing.assert_array_equal(mult.numpy(), want_mult)
    np.testing.assert_array_equal(start.numpy(), want_start)
    j_mult, j_start = chunk_rank_xla(jnp.asarray(table), jnp.asarray(keys), jnp.asarray(valid))
    np.testing.assert_array_equal(mult.numpy(), np.asarray(j_mult))
    np.testing.assert_array_equal(start.numpy(), np.asarray(j_start))


def test_int64_extremes():
    table = np.array([I64.min, I64.min, -(1 << 62), -1, 0, 0, 0, 1 << 40, I64.max - 1, I64.max],
                     np.int64)
    keys = np.array([I64.min, I64.max, 0, -1, 1 << 40, (1 << 40) + 1, I64.max - 1, 5, -(1 << 62),
                     I64.min + 1] * 13, np.int64)[:128]
    valid = np.arange(128) % 7 != 3
    mult, start = chunk_probe.chunk_rank_plain(torch.from_numpy(table), torch.from_numpy(keys),
                                               torch.from_numpy(valid))
    want_mult, want_start = _numpy(table, keys, valid)
    np.testing.assert_array_equal(mult.numpy(), want_mult)
    np.testing.assert_array_equal(start.numpy(), want_start)
    assert set(want_mult.tolist()) == {0, 1, 2, 3}


def test_launches_count_only_the_kernel():
    table, keys, valid = _case(0, 100, 50, 64, 128)
    before = chunk_probe.chunk_rank.launches
    chunk_probe.chunk_rank(torch.from_numpy(table), torch.from_numpy(keys),
                           torch.from_numpy(valid))
    assert chunk_probe.chunk_rank.launches == before  # the CPU runs the plain version
    t = torch.from_numpy
    with pytest.raises(TypeError):
        chunk_probe.chunk_rank(t(table).int(), t(keys), t(valid))
    with pytest.raises(TypeError):
        chunk_probe.chunk_rank(t(table), t(keys), t(valid).int())
    with pytest.raises(ValueError):
        chunk_probe.chunk_rank(t(table), t(keys), t(valid)[:64])


@pytest.mark.parametrize("m, dom, count", [(300, 250, 128), (90, 40, 101)])
def test_plain_matches_jax_kernel(m, dom, count):
    """JAX's Pallas kernel in interpret mode at block 128, with its packing
    (key' = key - kmin + 1 clamped, probes key' << 1 | 1, invalid lanes
    I32_MAX), as tests/test_sorted_pipeline.py drives it."""
    block = 128
    table, keys, valid = _case(m, m, dom, count, block, lo=1000)
    kmin = int(table.min())
    kp = np.clip(keys - kmin + 1, 0, int(table.max()) - kmin + 2)
    pk = np.where(valid, (kp << 1) | 1, I32_MAX).astype(np.int32)
    tpk = stage_table_planes(((table - kmin + 1) << 1).astype(np.int32), block)
    j_mult, j_start = (np.asarray(x) for x in interpret(
        lambda a, b: jax_chunk_rank(a, m, b, interpret=True), tpk, jnp.asarray(pk)))
    mult, start = chunk_probe.chunk_rank(torch.from_numpy(table), torch.from_numpy(keys),
                                         torch.from_numpy(valid))
    np.testing.assert_array_equal(mult.numpy(), j_mult)
    live = j_mult > 0
    assert live.sum() > 20
    np.testing.assert_array_equal(start.numpy()[live], j_start[live])
