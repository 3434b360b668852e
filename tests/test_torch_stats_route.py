"""The port's `sorted_match_stats` kernel route (plain versions, on the
CPU) against the JAX package's Pallas route (`use_kernel=True`, interpret
mode, 2^11 tiles, so its probe sort, unequal merge, fused scan and unsort
all run as kernels): int32 and int64 probes, a negative key range,
`allow_negative`, psum past 2^31, and n below one tile. Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch.ops import sort_merge as sm
from torch_interpret import interpret


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "wide psum":
        keys = np.sort(rng.integers(0, 300, 1000))
        return keys, rng.integers(2**29, 2**30, 1000), rng.integers(0, 310, 2500), False
    if name == "negative key range":
        keys = np.sort(rng.integers(-1000, -600, 800))
        return keys, rng.integers(0, 2**20, 800), rng.integers(-1005, -590, 2500), False
    if name == "allow_negative":
        keys = np.sort(rng.integers(0, 500, 1500))
        return keys, rng.integers(-(2**20), 2**20, 1500), rng.integers(-3, 510, 2500), True
    if name == "small n":
        keys = np.sort(rng.integers(0, 50, 64))
        return keys, None, rng.integers(0, 55, 200), False
    keys = np.sort(rng.integers(0, 500, 1500))  # "int32 probes", "int64 probes"
    return keys, rng.integers(0, 2**20, 1500), rng.integers(-3, 510, 2500), False


@pytest.mark.parametrize(
    "name, dtype",
    [
        ("int32 probes", np.int32),
        ("int64 probes", np.int64),
        ("negative key range", np.int64),
        ("allow_negative", np.int32),
        ("wide psum", np.int64),
        ("small n", np.int64),
    ],
)
def test_stats_kernel_route_matches_jax_pallas(name, dtype):
    keys, payloads, probe, allow_negative = _case(name)
    probe = probe.astype(dtype)
    jax_table = jax_sm.build_sorted(keys, payloads)
    assert jax_table.pack32 is not None and jax_table.pack32[1] <= 29 and jax_table.pay32
    want = interpret(lambda p: jax_sm.sorted_match_stats(
        jax_table, p, allow_negative=allow_negative, use_kernel=True, tile_log=11),
        jnp.asarray(probe))
    got = sm.sorted_match_stats(sm.build_sorted(keys, payloads, device="cpu"), torch.from_numpy(probe),
                                allow_negative=allow_negative, tile_log=11)
    np.testing.assert_array_equal(got.mult.numpy(), np.asarray(want.mult))
    np.testing.assert_array_equal(got.psum.numpy(), np.asarray(want.psum))
