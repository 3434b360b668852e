"""The port's int64 stats side (plain versions, on the CPU) against the JAX
package: `merge_stats_i64` against `merge_scan_stats` (the limb scan, in
Pallas interpret mode) with its per-element output scattered to probe
rows, and `sorted_match_stats` on wide tables against JAX's wide Pallas
route (`use_kernel=True`, interpret mode, 2^10 tiles: the limb probe sort,
the unequal merge, the scan and the unsort all run as kernels), the
generic route and numpy. Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.merge_scan import merge_scan_stats
from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch.kernels import merge_scan
from ccve_tpu_torch.ops import sort_merge as sm
from torch_interpret import interpret

I64_MAX = 2**63 - 1


def _stream(rng, n, m, dom, pay_lo, pay_hi, base=2**60):
    """A merged int64 stats stream: builds `key' << 1` (even), probes
    `key' << 1 | 1` with key' = base + key, and the cargo plane (payloads,
    then probe row ids)."""
    builds = np.sort(rng.integers(0, dom, m))
    probes = rng.integers(0, dom + 3, n)  # some above every build
    s = np.concatenate([(base + builds) * 2, (base + probes) * 2 + 1])
    v = np.concatenate([rng.integers(pay_lo, pay_hi, m), np.arange(n)])
    order = np.argsort(s, kind="stable")
    return s[order], v[order].astype(np.int32)


def _numpy_stats(s, v, n):
    is_build = (s & 1) == 0
    bkeys, bpays = s[is_build] >> 1, v[is_build].astype(np.int64)
    prefix = np.concatenate([[0], np.cumsum(bpays)])
    mult = np.zeros(n, np.int32)
    psum = np.zeros(n, np.int64)
    rows = v[~is_build]
    lo = np.searchsorted(bkeys, s[~is_build] >> 1, "left")
    hi = np.searchsorted(bkeys, s[~is_build] >> 1, "right")
    mult[rows], psum[rows] = hi - lo, prefix[hi] - prefix[lo]
    return mult, psum


@pytest.mark.parametrize(
    "n, m, dom, pay_lo, pay_hi",
    [
        (3000, 1500, 500, 0, 2**20),  # duplicate builds
        (4000, 300, 60, 2**29, 2**30),  # psum past 2^31
        (2000, 5, 2, 0, 1),  # zero payloads, long runs
    ],
)
def test_merge_stats_i64_matches_jax_scan(n, m, dom, pay_lo, pay_hi):
    rng = np.random.default_rng(n + m)
    s, v = _stream(rng, n, m, dom, pay_lo, pay_hi)
    is_build = (s & 1) == 0
    tagged = np.where(is_build, v.astype(np.int64) * 2 + 1, 0)  # JAX's tag convention
    mult_e, psum_e = interpret(merge_scan_stats, jnp.asarray(s >> 1), jnp.asarray(tagged))
    want_mult = np.zeros(n, np.int32)
    want_psum = np.zeros(n, np.int64)
    want_mult[v[~is_build]] = np.asarray(mult_e)[~is_build]  # per element -> per row
    want_psum[v[~is_build]] = np.asarray(psum_e)[~is_build]
    mult, psum = merge_scan.merge_stats_i64(torch.from_numpy(s), torch.from_numpy(v), n)
    assert mult.dtype == torch.int32 and psum.dtype == torch.int64
    np.testing.assert_array_equal(mult.numpy(), want_mult)
    np.testing.assert_array_equal(psum.numpy(), want_psum)


def test_merge_stats_i64_negative_payloads_and_padding():
    """Negative payloads (numpy only: the JAX scan's cummax base needs
    non-negative ones) and INT64_MAX padding, never counted as a probe."""
    rng = np.random.default_rng(9)
    n = 5000
    s, v = _stream(rng, n, 2000, 400, -(2**31), 2**31 - 1, base=2**61)
    s = np.concatenate([s, np.full(33, I64_MAX)])
    v = np.concatenate([v, np.zeros(33, np.int32)])
    mult, psum = merge_scan.merge_stats_i64(torch.from_numpy(s), torch.from_numpy(v), n)
    want_mult, want_psum = _numpy_stats(s[:-33], v[:-33], n)
    np.testing.assert_array_equal(mult.numpy(), want_mult)
    np.testing.assert_array_equal(psum.numpy(), want_psum)


def _wide_setup(m=800, n=2500, span=2**40, seed=3):
    """The JAX package's wide fixture (tests/test_sort_merge.py), scaled
    down: keys over ±span with duplicates, payloads below 2^30, probes
    drawn from the keys plus 200 over ±2·span."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-span, span, m, dtype=np.int64)
    keys = np.concatenate([keys, keys[: m // 4]])
    payloads = rng.integers(0, 2**30, keys.shape[0], dtype=np.int64)
    probes = np.concatenate([
        rng.choice(keys, n - 200), rng.integers(-2 * span, 2 * span, 200, dtype=np.int64),
    ])
    rng.shuffle(probes)
    return keys, payloads, probes


def _numpy_probe_stats(keys, payloads, probes):
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    prefix = np.concatenate([[0], np.cumsum(payloads[order])])
    lo, hi = np.searchsorted(sk, probes, "left"), np.searchsorted(sk, probes, "right")
    return hi - lo, prefix[hi] - prefix[lo]


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_sorted_match_stats_wide_matches_jax_pallas(dtype):
    """Int32 probes against a wide table are widened, and clamp like int64
    ones (the keys here span past 2^31). Two 2^10 tiles of probes."""
    keys, payloads, probes = _wide_setup(m=500, n=1200)
    probes = probes.astype(dtype) if dtype == np.int64 else (probes >> 10).astype(np.int32)
    keys = keys if dtype == np.int64 else keys >> 10
    jax_table = jax_sm.build_sorted(keys, payloads)
    assert jax_table.pack32 is None and jax_table.wide_ok
    want = interpret(lambda p: jax_sm.sorted_match_stats(jax_table, p, use_kernel=True,
                                                         tile_log=10),
                     jnp.asarray(probes.astype(np.int64)))
    table = sm.build_sorted(keys, payloads, device="cpu")
    assert sm.stats_key_type(table) == torch.int64
    got = sm.sorted_match_stats(table, torch.from_numpy(probes), tile_log=10)
    np.testing.assert_array_equal(got.mult.numpy(), np.asarray(want.mult))
    np.testing.assert_array_equal(got.psum.numpy(), np.asarray(want.psum))
    generic = sm.sorted_match_stats(table, torch.from_numpy(probes), use_kernel=False)
    assert torch.equal(got.mult, generic.mult) and torch.equal(got.psum, generic.psum)
    mult, psum = _numpy_probe_stats(keys, payloads, probes.astype(np.int64))
    np.testing.assert_array_equal(got.mult.numpy(), mult)
    np.testing.assert_array_equal(got.psum.numpy(), psum)


def test_wide_merged_stream_is_int64():
    """The wide route's merged stream: int64 keys, builds even before the
    probes of their key, the int32 cargo plane beside it."""
    keys, payloads, probes = _wide_setup(m=200, n=500, seed=7)
    table = sm.build_sorted(keys, payloads, device="cpu")
    s, v = sm.merged_stream(table, torch.from_numpy(probes), tile_log=6)
    assert s.dtype == torch.int64 and v.dtype == torch.int32
    assert s.numel() == keys.size + probes.size
    assert torch.equal(s, s.sort().values)
    assert int((s & 1 == 0).sum()) == keys.size
    narrow = sm.build_sorted(np.arange(10), device="cpu")
    assert sm.stats_key_type(narrow) == torch.int32
    assert sm.stats_key_type(sm.build_sorted(np.array([0, 2**62]), device="cpu")) is None
    assert sm.stats_key_type(sm.build_sorted(np.array([0, 2**40]), [0, 2**40],
                                             device="cpu")) is None  # payload past int32
    with pytest.raises(ValueError, match="no kernel route"):
        sm.merged_stream(sm.build_sorted(np.array([0, 2**62]), device="cpu"), probes)


def test_merge_stats_i64_checks_operands():
    s = torch.zeros(8, dtype=torch.int64)
    v = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        merge_scan.merge_stats_i64(s.int(), v, 4)
    with pytest.raises(TypeError):
        merge_scan.merge_stats_i64(s, v.long(), 4)
    with pytest.raises(ValueError):
        merge_scan.merge_stats_i64(s, v[:3], 4)
    with pytest.raises(ValueError, match="device"):
        merge_scan.merge_stats_i64(s.to("meta"), v.to("meta"), 4)
