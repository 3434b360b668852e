"""The port's merge counts (plain version, on the CPU) against the JAX
package's `merge_counts_fused` in Pallas interpret mode, and against a
numpy histogram."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.merge_scan import merge_counts_fused
from ccve_tpu_torch.kernels import merge_scan

IMAX = 2**31 - 1
JAX_TILE = 256 * 128  # merge_counts_fused's tile


def _histogram(probes, b32):
    """bc by numpy: per build row, how many probes equal b32 - 1."""
    keys = b32 // 2
    hist = np.bincount(probes // 2, minlength=int(keys.max(initial=0)) + 2)
    return hist[keys].astype(np.int32)


def _jax_counts(pk, b32, n_runs_at=()):
    """merge_counts_fused over the sorted runs of `pk` that start at the
    offsets `(0, *n_runs_at)`, summed (a_row_off plus mask_a_end when
    several runs share the buffer)."""
    n = pk.size
    starts = [0, *n_runs_at]
    n_a = n + (-n) % JAX_TILE
    abuf = np.full((n_a // 128 + 264 + 8, 128), IMAX, np.int32)
    abuf.reshape(-1)[:n] = pk
    total = 0
    for i, s in enumerate(starts):
        e = starts[i + 1] if i + 1 < len(starts) else n
        total = total + np.asarray(
            merge_counts_fused(
                jnp.asarray(abuf), e - s, e - s, jnp.asarray(b32), b32.size,
                interpret=True, a_row_off=s // 128, mask_a_end=i + 1 < len(starts),
            )
        )
    return total


def _port_counts(pk, b32, run_len, pad_to=None):
    n = pk.size
    pad_to = pad_to or n
    runs = torch.from_numpy(np.concatenate([pk, np.full(pad_to - n, IMAX, np.int32)]))
    return merge_scan.merge_counts_i32(
        runs, run_len, n, torch.from_numpy(b32), b32.size
    ).numpy()


@pytest.mark.parametrize(
    "name, n, builds",
    [
        # ragged n, distinct build keys
        ("ragged", 40_001, lambda rng: rng.choice(50_000, 9_000, replace=False)),
        # build keys repeat: every row of a key gets the key's full count
        ("duplicates", 33_000, lambda rng: rng.integers(0, 5_000, 4_000)),
        # builds in a narrow key range: most merged tiles hold only probes
        ("clustered", 100_000, lambda rng: rng.integers(20_000, 20_500, 3_000)),
    ],
    ids=["ragged", "duplicates", "clustered"],
)
def test_one_run_matches_jax(name, n, builds):
    rng = np.random.default_rng(len(name))
    pk = np.sort(rng.integers(0, 50_000, n)).astype(np.int32) * 2
    b32 = (np.sort(builds(rng)).astype(np.int32) * 2) | 1
    got = _port_counts(pk, b32, run_len=n, pad_to=n + 77)
    np.testing.assert_array_equal(got, _jax_counts(pk, b32))
    np.testing.assert_array_equal(got, _histogram(pk, b32))


def test_two_runs_in_one_buffer_match_jax():
    """Two back-to-back sorted runs, the second one short: the port counts
    both in one call; JAX scans each with a_row_off + mask_a_end."""
    rng = np.random.default_rng(13)
    n1, n2 = JAX_TILE * 2, 40_000
    pk = np.concatenate([
        np.sort(rng.integers(0, 50_000, n1)),
        np.sort(rng.integers(0, 50_000, n2)),
    ]).astype(np.int32) * 2
    b32 = (np.sort(rng.integers(0, 50_000, 9_000)).astype(np.int32) * 2) | 1
    got = _port_counts(pk, b32, run_len=n1, pad_to=n1 + n1)
    np.testing.assert_array_equal(got, _jax_counts(pk, b32, n_runs_at=(n1,)))
    np.testing.assert_array_equal(got, _histogram(pk, b32))


@pytest.mark.parametrize("run_len", [1, 7, 64, 1000, 5000])
def test_many_runs_and_padding(run_len):
    """Any run length, padding never counted, probes above and below every
    build key."""
    rng = np.random.default_rng(run_len)
    n = 5000
    probes = rng.integers(0, 700, n).astype(np.int32) * 2
    pk = np.concatenate([
        np.sort(probes[s : s + run_len]) for s in range(0, n, run_len)
    ])
    b32 = (np.sort(rng.integers(3, 600, 400)).astype(np.int32) * 2) | 1
    got = _port_counts(pk, b32, run_len, pad_to=n + 3 * run_len)
    np.testing.assert_array_equal(got, _histogram(pk, b32))


def test_edge_sizes():
    b32 = np.array([1, 3, 3, 9], np.int32)
    np.testing.assert_array_equal(_port_counts(np.zeros(0, np.int32), b32, 8), [0] * 4)
    pk = np.array([0, 2, 2, 8, 8, 8], np.int32)
    np.testing.assert_array_equal(_port_counts(pk, b32, 6), [1, 2, 2, 3])
    got = _port_counts(pk, np.zeros(0, np.int32), 6)
    assert got.shape == (0,)


def test_checks_operands():
    runs = torch.zeros(16, dtype=torch.int32)
    b32 = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        merge_scan.merge_counts_i32(runs, 16, 16, b32, 5)  # m != len(b32)
    with pytest.raises(ValueError):
        merge_scan.merge_counts_i32(runs, 16, 17, b32, 4)  # n_real > len
    with pytest.raises(ValueError):
        merge_scan.merge_counts_i32(runs, 0, 16, b32, 4)
    with pytest.raises(TypeError):
        merge_scan.merge_counts_i32(runs, 16, 16, b32.long(), 4)
    with pytest.raises(ValueError, match="device"):
        merge_scan.merge_counts_i32(runs.to("meta"), 16, 16, b32.to("meta"), 4)
