"""The port's per-probe stats (plain versions, on the CPU) against the JAX
package: the stats scan against `merge_scan_stats32` in interpret mode
(its per-position output scattered to rows by its key2 plane), and
`sorted_match_stats` / `sorted_match_ranks` against the JAX package's XLA
route and searchsorted ground truth. Every output is an integer:
tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.core.datagen import gen_rhs_table
from ccve_tpu.kernels.merge_scan import merge_scan_stats32
from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch.kernels import merge_scan
from ccve_tpu_torch.ops import sort_merge as sm
from torch_interpret import interpret, once


def _stream(rng, n, m, dom, pay_lo, pay_hi):
    """A merged stats stream: builds even (payload cargo), probes odd (row
    id cargo), stably sorted, as int32."""
    builds = np.sort(rng.integers(0, dom, m))
    probes = rng.integers(0, dom + 3, n)
    s = np.concatenate([builds * 2, probes * 2 + 1])
    v = np.concatenate([rng.integers(pay_lo, pay_hi, m), np.arange(n)])
    order = np.argsort(s, kind="stable")
    return s[order].astype(np.int32), v[order].astype(np.int32)


def _numpy_stats(s, v, n):
    mult = np.zeros(n, np.int64)
    psum = np.zeros(n, np.int64)
    key = s >> 1
    for k in np.unique(key):
        at = key == k
        build = at & (s % 2 == 0)
        probe_rows = v[at & (s % 2 == 1)]
        mult[probe_rows] = build.sum()
        psum[probe_rows] = v[build].astype(np.int64).sum()
    return mult, psum


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n, m, dom", [(3000, 1500, 500), (2000, 40, 10), (1, 5, 3)])
def test_stats_scan_matches_jax_kernel(packed, n, m, dom):
    """Both of the JAX kernel's modes: four planes, or the one packed
    `psum << mult_bits | mult` plane (mult_bits from the largest key
    multiplicity, payloads small enough for psum to fit beside it)."""
    rng = np.random.default_rng(n + m)
    s, v = _stream(rng, n, m, dom, 0, 2**20 if packed else 2**30)
    builds = s[s % 2 == 0] >> 1
    mult_bits = max(int(np.bincount(builds).max()).bit_length(), 1) if packed else None
    out = interpret(lambda a, b: merge_scan_stats32(a, b, n, mult_bits=mult_bits),
                    jnp.asarray(s), jnp.asarray(v))
    key2 = np.asarray(out[0])
    at = key2 < n
    want_mult = np.zeros(n, np.int64)
    want_psum = np.zeros(n, np.int64)
    if mult_bits is None:
        mult, hi, lo = (np.asarray(o).astype(np.int64) for o in out[1:])
        want_mult[key2[at]] = mult[at]
        want_psum[key2[at]] = (hi[at] << 32) | (lo[at] & 0xFFFFFFFF)
    else:
        packed = np.asarray(out[1]).astype(np.int64)
        want_mult[key2[at]] = packed[at] & ((1 << mult_bits) - 1)
        want_psum[key2[at]] = packed[at] >> mult_bits
    got_mult, got_psum = merge_scan.merge_stats_i32(torch.from_numpy(s), torch.from_numpy(v), n)
    assert got_mult.dtype == torch.int32 and got_psum.dtype == torch.int64
    np.testing.assert_array_equal(got_mult.numpy(), want_mult)
    np.testing.assert_array_equal(got_psum.numpy(), want_psum)


@pytest.mark.parametrize(
    "n, m, dom, pay_lo, pay_hi",
    [
        (4000, 1500, 700, -(2**31), 2**31 - 1),  # negative payloads
        (5000, 2000, 300, 2**29, 2**30),  # psum past 2^31
        (3000, 5, 2, 0, 1),  # zero payloads, long runs
        (0, 10, 5, 0, 9),
        (10, 0, 5, 0, 9),
    ],
)
def test_stats_scan_any_sign(n, m, dom, pay_lo, pay_hi):
    rng = np.random.default_rng(n + m + dom)
    s, v = _stream(rng, n, m, dom, pay_lo, pay_hi)
    s = np.concatenate([s, np.full(33, 2**31 - 1, np.int32)])  # sort padding
    v = np.concatenate([v, np.zeros(33, np.int32)])
    got_mult, got_psum = merge_scan.merge_stats_i32(torch.from_numpy(s), torch.from_numpy(v), n)
    want_mult, want_psum = _numpy_stats(s[:-33], v[:-33], n)
    np.testing.assert_array_equal(got_mult.numpy(), want_mult)
    np.testing.assert_array_equal(got_psum.numpy(), want_psum)


def _check_stats(got, want):
    np.testing.assert_array_equal(got.mult.numpy(), np.asarray(want.mult))
    np.testing.assert_array_equal(got.psum.numpy(), np.asarray(want.psum))
    assert got.mult.dtype == torch.int32 and got.psum.dtype == torch.int64


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize(
    "keys, payloads, probe_lo, probe_hi, dtype",
    [
        (gen_rhs_table(900, 3)[0], None, -5, 2000, np.int32),
        (gen_rhs_table(900, 1)[0], None, -5, 1000, np.int64),
        (np.arange(-1000, -600), np.arange(400) * -7, -1010, -590, np.int64),  # negative keys, payloads
        (np.arange(300) * 2**35, np.arange(300), 0, 2**44, np.int64),  # span past 2^30
        (np.array([3, 3, 5]), np.array([2**40, 1, 2]), 0, 8, np.int32),  # payload past 2^31
    ],
)
def test_sorted_match_stats_matches_jax_xla(use_kernel, keys, payloads, probe_lo, probe_hi, dtype):
    rng = np.random.default_rng(len(keys))
    probe = rng.integers(probe_lo, probe_hi, 3000).astype(dtype)
    if dtype == np.int32 or probe_hi < 2**40:
        probe[:50] = rng.choice(keys, 50)
    want = once(("stats xla", keys.tobytes(), probe.tobytes()), lambda: jax_sm.sorted_match_stats(
        jax_sm.build_sorted(keys, payloads), jnp.asarray(probe.astype(np.int64)),
        allow_negative=True, use_kernel=False))
    got = sm.sorted_match_stats(sm.build_sorted(keys, payloads, device="cpu"), torch.from_numpy(probe),
                                use_kernel=use_kernel)
    _check_stats(got, want)


def test_allow_negative_changes_nothing():
    rng = np.random.default_rng(3)
    keys = np.sort(rng.integers(0, 200, 700))
    payloads = rng.integers(-(2**20), 2**20, 700)
    probe = torch.from_numpy(rng.integers(-3, 210, 4000))
    table = sm.build_sorted(keys, payloads, device="cpu")
    a = sm.sorted_match_stats(table, probe)
    b = sm.sorted_match_stats(table, probe, allow_negative=True)
    assert torch.equal(a.mult, b.mult) and torch.equal(a.psum, b.psum)


@pytest.mark.parametrize("m, dom, n", [(100, 60, 500), (64, 64, 64), (1000, 5, 333), (0, 5, 40)])
@pytest.mark.parametrize("use_kernel", [None, False])
def test_sorted_match_ranks(m, dom, n, use_kernel):
    rng = np.random.default_rng(m + dom + n)
    keys = rng.integers(0, dom, m).astype(np.int64)
    probe = rng.integers(-3, dom + 3, n).astype(np.int64)
    rt = sm.rank_table(sm.build_sorted(keys, np.arange(m), device="cpu"))
    mult, start = sm.sorted_match_ranks(rt, torch.from_numpy(probe), use_kernel=use_kernel)
    sk = np.sort(keys)
    e_start = np.searchsorted(sk, probe, side="left")
    e_mult = np.searchsorted(sk, probe, side="right") - e_start
    np.testing.assert_array_equal(mult.numpy(), e_mult)
    live = e_mult > 0
    np.testing.assert_array_equal(start.numpy()[live], e_start[live])
    assert start.dtype == torch.int32


def test_rank_table_matches_jax():
    keys = np.array([4, 1, 4, 9, 9, 9, 2])
    jax_rt = jax_sm.rank_table(jax_sm.build_sorted(keys))
    rt = sm.rank_table(sm.build_sorted(keys, device="cpu"))
    np.testing.assert_array_equal(rt.payloads.numpy(), np.asarray(jax_rt.payloads))
    for f in sm.META_FIELDS:
        assert getattr(rt, f) == getattr(jax_rt, f), f
    assert torch.equal(rt.keys, torch.from_numpy(np.sort(keys)))


def test_empty_build_table_stats_and_counts_are_zero():
    """m == 0: JAX gives zeros everywhere; so does the port."""
    empty = np.zeros(0, np.int64)
    probe = np.array([0, 5, -3, 7], np.int64)
    jax_table = jax_sm.build_sorted(empty, empty)
    table = sm.build_sorted(empty, empty, device="cpu")
    want = jax_sm.sorted_match_stats(jax_table, jnp.asarray(probe))
    for use_kernel in (None, False):
        _check_stats(sm.sorted_match_stats(table, probe, use_kernel=use_kernel), want)
    count, checksum = sm.sorted_match_totals(table, probe)
    want_count, want_checksum = jax_sm.sorted_match_totals(jax_table, jnp.asarray(probe))
    assert (int(count), int(checksum)) == (int(want_count), int(want_checksum)) == (0, 0)
    bc = sm.sorted_build_counts(table, probe)
    assert bc.shape == (0,) and bc.dtype == torch.int32
    assert np.asarray(jax_sm.sorted_build_counts(jax_table, jnp.asarray(probe))).shape == (0,)
