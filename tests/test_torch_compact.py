"""The port's stream compaction (plain version, on the CPU) against the
JAX package's `pallas_compact_i32` in interpret mode, and against numpy at
lengths the TPU kernel does not take (not a multiple of 128). Exact: the
outputs are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.compact import pallas_compact_i32
from ccve_tpu_torch.kernels import compact


def _mask(rng, n, fill):
    return {"all": np.ones(n, bool), "none": np.zeros(n, bool),
            "random": rng.random(n) < 0.3}[fill]


@pytest.mark.parametrize("n_planes", [1, 2, 3])
@pytest.mark.parametrize("n", [128, 2048, 3200])
@pytest.mark.parametrize("fill", ["all", "none", "random"])
def test_compact_matches_jax(n_planes, n, fill):
    rng = np.random.default_rng(n * n_planes)
    planes = rng.integers(-(2**31), 2**31 - 1, (n_planes, n)).astype(np.int32)
    mask = _mask(rng, n, fill)
    want, want_count = pallas_compact_i32(jnp.asarray(planes), jnp.asarray(mask), interpret=True)
    got, count = compact.compact_i32(torch.from_numpy(planes), torch.from_numpy(mask))
    k = int(want_count)
    assert int(count) == k == int(mask.sum())
    np.testing.assert_array_equal(got[:, :k].numpy(), np.asarray(want)[:, :k])
    assert not got[:, k:].any()  # the port fills the tail with 0


@pytest.mark.parametrize("n", [0, 1, 5, 2047, 2049])
@pytest.mark.parametrize("fill", ["all", "none", "random"])
def test_compact_any_length(n, fill):
    rng = np.random.default_rng(n)
    planes = rng.integers(-100, 100, (2, n)).astype(np.int32)
    mask = _mask(rng, n, fill)
    got, count = compact.compact_i32(torch.from_numpy(planes), torch.from_numpy(mask))
    k = int(mask.sum())
    assert int(count) == k and count.dtype == torch.int64
    np.testing.assert_array_equal(got[:, :k].numpy(), planes[:, mask])
    assert got.shape == planes.shape and not got[:, k:].any()


def test_compact_rejects_bad_operands():
    planes = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        compact.compact_i32(planes.long(), torch.ones(8, dtype=torch.bool))
    with pytest.raises(TypeError):
        compact.compact_i32(planes, torch.ones(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        compact.compact_i32(planes, torch.ones(7, dtype=torch.bool))
    with pytest.raises(ValueError):
        compact.compact_i32(planes[0], torch.ones(8, dtype=torch.bool))
