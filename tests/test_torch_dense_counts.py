"""The count side's small-probe route, plain versions on the CPU, against
the JAX package on the same inputs: the dense counts (#4,
`merge_scan_build_counts`, JAX's with 2^10-element tiles in Pallas
interpret mode, `extra` and phantoms included), the key-only merge (#5,
`merge_sorted_i32`, JAX's with a 2^10 tile so that its kernel runs rather
than its `lax.sort`), and `sorted_match_totals` / `bulk_count` through the
route at n = 1, 100 and 8192 probes, and at 8193 on the tile route,
against JAX's `use_kernel=True`. Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels import bigsort as jax_bigsort
from ccve_tpu.kernels import merge_scan as jax_merge_scan
from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch.exec.bulk import bulk_count
from ccve_tpu_torch.kernels import bigsort, merge_scan
from ccve_tpu_torch.ops import sort_merge as sm
from torch_interpret import interpret, once

I32_MAX = 2**31 - 1


def _merged(rng, m, n, dom, phantoms):
    """A merged ascending int32 stream of builds `key' << 1 | 1`, probes
    `key' << 1` and INT32_MAX phantoms, and its build keys'."""
    bkeys = np.sort(rng.integers(0, dom, m))
    pkeys = rng.integers(0, dom + 4, n)
    s = np.concatenate([bkeys * 2 + 1, pkeys * 2, np.full(phantoms, I32_MAX)])
    return np.sort(s).astype(np.int32), bkeys, pkeys


@pytest.mark.parametrize(
    "m, n, dom, phantoms, extra",
    [
        (900, 3000, 400, 0, 0),  # duplicate builds
        (2500, 1000, 10**6, 37, 40),  # phantoms within extra
        (3, 4000, 2, 1000, 1000),  # long probe runs
        (1200, 0, 50, 5, 5),  # no probes
    ],
)
def test_merge_scan_build_counts_matches_jax(m, n, dom, phantoms, extra):
    rng = np.random.default_rng(m + n + phantoms)
    s, bkeys, pkeys = _merged(rng, m, n, dom, phantoms)
    want = interpret(lambda x: jax_merge_scan.merge_scan_build_counts(x, m, R=8, extra=extra),
                     jnp.asarray(s))
    got = merge_scan.merge_scan_build_counts(torch.from_numpy(s), m, extra=extra)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ps = np.sort(pkeys)
    np.testing.assert_array_equal(
        got.numpy(), np.searchsorted(ps, bkeys, "right") - np.searchsorted(ps, bkeys, "left"))


def test_merge_scan_build_counts_edges():
    s = torch.tensor([0, 1, 1, 4, 5, I32_MAX], dtype=torch.int32)
    assert merge_scan.merge_scan_build_counts(s, 2).tolist() == [1, 1]
    assert merge_scan.merge_scan_build_counts(s, 5).tolist() == [1, 1, 1, 0, 0]
    assert merge_scan.merge_scan_build_counts(s[:0], 3).tolist() == [0, 0, 0]
    with pytest.raises(ValueError):
        merge_scan.merge_scan_build_counts(s, 2, extra=-1)


@pytest.mark.parametrize(
    "na, nb, dom",
    [(700, 900, 50), (3000, 5, 10**9), (1, 2000, 10), (1500, 1500, 3), (0, 800, 9), (600, 0, 9)],
)
def test_merge_sorted_i32_matches_jax(na, nb, dom):
    rng = np.random.default_rng(na * 7 + nb)
    # values strictly inside (INT32_MIN, INT32_MAX), as the JAX kernel needs
    a = np.sort(rng.integers(-dom, dom, na)).astype(np.int32)
    b = np.sort(rng.integers(-dom, dom, nb)).astype(np.int32)
    want = interpret(lambda x, y: jax_bigsort.merge_sorted_i32(x, y, tile_log=10),
                     jnp.asarray(a), jnp.asarray(b))
    got = bigsort.merge_sorted_i32(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the kernel route takes the sentinels as values too
    ext = torch.tensor([-(2**31), I32_MAX], dtype=torch.int32)
    assert bigsort.merge_sorted_i32(ext, ext).tolist() == [-(2**31)] * 2 + [I32_MAX] * 2


@pytest.mark.parametrize("n", [1, 100, 8192, 8193])
@pytest.mark.parametrize("probe_dtype", [np.int32, np.int64])
def test_small_probe_route_matches_jax(monkeypatch, n, probe_dtype):
    """n <= 2^13 probes take the small-probe route (a whole sort, #5, #4),
    8193 the tile route; both give JAX's totals and bulk_count's."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 3000, 2000)
    payloads = rng.integers(0, 10**6, 2000)
    probe = rng.integers(-5, 3005, n).astype(probe_dtype)
    jax_table = jax_sm.build_sorted(keys, payloads)
    want = once(("small-probe", n), lambda: interpret(
        lambda p: jax_sm.sorted_match_totals(jax_table, p, use_kernel=True),
        jnp.asarray(probe.astype(np.int64))))
    calls = []

    def spy(a, b):
        calls.append(a.numel())
        return bigsort.merge_sorted_i32_plain(a, b)

    monkeypatch.setattr(bigsort, "merge_sorted_i32", spy)
    table = sm.build_sorted(keys, payloads, device="cpu")
    count, checksum = sm.sorted_match_totals(table, probe)
    assert (int(count), int(checksum)) == (int(want[0]), int(want[1]))
    assert calls == ([n] if n <= 8192 else [])
    res = bulk_count([table], probe[:, None])
    assert (int(res.count), res.payload_checksums.tolist()) == (int(want[0]), [int(want[1])])


def test_small_probe_build_counts_match_jax():
    rng = np.random.default_rng(21)
    keys = rng.integers(0, 500, 1500)
    probe = rng.integers(-3, 505, 4000)
    jax_table = jax_sm.build_sorted(keys, rng.integers(0, 99, 1500))
    want = np.asarray(jax_sm.sorted_build_counts(jax_table, jnp.asarray(probe)))
    table = sm.build_sorted(keys, device="cpu")
    np.testing.assert_array_equal(sm.sorted_build_counts(table, probe).numpy(), want)


@pytest.mark.parametrize("length", [0, 1, merge_scan.DENSE_TILE - 1, merge_scan.DENSE_TILE,
                                    merge_scan.DENSE_TILE + 1, 264 * merge_scan.DENSE_TILE,
                                    264 * merge_scan.DENSE_TILE + 1, 17_000_000, 2**31 - 1])
@pytest.mark.parametrize("sm_count", [1, 132, 300])
def test_dense_counts_grid(length, sm_count):
    """The cooperative launch's grid: at least one block, never more than
    can be resident at once (DENSE_BLOCKS_PER_SM an SM) nor than the
    prefix step's threads, and one block a tile while the tiles fit, so
    that each element is then read once."""
    grid = merge_scan.dense_counts_grid(length, sm_count)
    tiles = -(-length // merge_scan.DENSE_TILE)
    cap = min(merge_scan.DENSE_BLOCKS_PER_SM * sm_count, merge_scan.DENSE_THREADS)
    assert 1 <= grid <= max(cap, 1)
    assert grid == max(1, min(tiles, cap))
    # every tile has a block: blocks take ceil(tiles / grid) tiles at most
    assert grid * -(-tiles // grid) >= tiles


def _dense_numpy(s, m):
    """bc[j] = the probes equal to the j-th build entry's value less one."""
    builds = s[(s & 1) == 1].astype(np.int64)[:m]
    v = builds - 1
    bc = np.zeros(m, np.int32)
    bc[: builds.size] = np.searchsorted(s, v, "right") - np.searchsorted(s, v, "left")
    return bc


def test_dense_counts_edge_cases():
    """`bench.edge_cases.dense_counts_cases` at a 64-element tile: the
    plain version equals numpy on every case (lengths at tile multiples
    and one off, builds only, probes only, a hot key across many tiles,
    phantoms, m below and past the builds, L = 1 and 0)."""
    from ccve_tpu_torch.bench.edge_cases import dense_counts_cases

    cases = dense_counts_cases(np.random.default_rng(37), tile=64)
    assert {len(s) for _, s, _ in cases} >= {0, 1, 63, 64, 65, 191, 192, 193}
    for what, s, m in cases:
        got = merge_scan.merge_scan_build_counts(torch.from_numpy(s), m)
        np.testing.assert_array_equal(got.numpy(), _dense_numpy(s, m), err_msg=what)
