"""The port's totals on full-range int64 keys (a key span of 2^62 or more:
64-bit fingerprints, hashed ids), plain versions on the CPU, against the
JAX package on the same inputs: `merge_scan_stats` (#15's generic entry)
against JAX's (the limb scan, in Pallas interpret mode), and
`sorted_match_totals`, single-level `bulk_count` and `sorted_build_counts`
on full-range tables against JAX's (`use_kernel=True`: its generic branch,
a stable `lax.sort` plus the Pallas scan) and numpy. Tolerance 0: every
output is an integer.

JAX's scan takes its payload base as a prefix max, which needs
non-negative payloads, so the parity cases keep them non-negative; the
port's segmented scan is exact for any sign, which the last tests check
against numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.merge_scan import merge_scan_stats as jax_merge_scan_stats
from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch.exec.bulk import bulk_count
from ccve_tpu_torch.kernels import merge_scan
from ccve_tpu_torch.ops import sort_merge as sm
from torch_interpret import interpret

I64_MIN, I64_MAX = -(2**63), 2**63 - 1


def _full_range_keys(rng, m, dups):
    """m keys over the whole int64 range, both extremes among them, with
    `dups` of them repeated."""
    keys = rng.integers(I64_MIN, I64_MAX, m, dtype=np.int64, endpoint=True)
    keys[:2] = [I64_MIN, I64_MAX]
    if dups:
        keys[2 : 2 + dups] = rng.choice(keys[: m - dups], dups)
    return keys


def _probes(rng, keys, n):
    """Half drawn from the build keys, half uniform over the int64 range
    (outside every build key, almost surely), and both extremes."""
    probe = np.concatenate([
        rng.choice(keys, n // 2),
        rng.integers(I64_MIN, I64_MAX, n - n // 2, dtype=np.int64, endpoint=True),
    ])
    probe[:2] = [I64_MAX, I64_MIN]
    return probe


def _numpy_totals(keys, payloads, probe):
    order = np.argsort(keys, kind="stable")
    sk, sp = keys[order], payloads[order].astype(object)  # exact Python ints
    prefix = np.concatenate([[0], np.cumsum(sp)])
    lo = np.searchsorted(sk, probe, "left")
    hi = np.searchsorted(sk, probe, "right")
    return int((hi - lo).sum()), int((prefix[hi] - prefix[lo]).sum())


def _tagged_stream(keys, payloads, probe):
    """(sk, st) of the generic totals: build ∪ probe keys stably sorted,
    with the tagged payloads (pay * 2 + 1 builds, 0 probes)."""
    all_keys = np.concatenate([keys, probe]).astype(np.int64)
    st = np.concatenate([payloads * 2 + 1, np.zeros(probe.size, np.int64)])
    order = np.argsort(all_keys, kind="stable")
    return all_keys[order], st[order]


def _crossed(jax_table):
    arrays = {"keys": np.asarray(jax_table.keys), "payloads": np.asarray(jax_table.payloads)}
    return sm.table_from_arrays(arrays, {f: getattr(jax_table, f) for f in sm.META_FIELDS}, "cpu")


@pytest.mark.parametrize(
    "m, n, dups, pay_hi",
    [
        (300, 900, 40, 2**30),  # duplicate builds, extremes
        (2000, 700, 0, 2**40),  # psum past 2^32
        (5, 3000, 3, 1),  # zero payloads, long runs of one key
        (0, 1500, 0, 1),  # an all-probe stream
    ],
)
def test_merge_scan_stats_matches_jax(m, n, dups, pay_hi):
    rng = np.random.default_rng(m + n)
    keys = _full_range_keys(rng, m, dups) if m else np.zeros(0, np.int64)
    probe = _probes(rng, keys, n) if m else rng.integers(-9, 9, n)
    sk, st = _tagged_stream(keys, rng.integers(0, pay_hi, m), probe)
    want_mult, want_psum = interpret(jax_merge_scan_stats, jnp.asarray(sk), jnp.asarray(st))
    mult, psum = merge_scan.merge_scan_stats(torch.from_numpy(sk), torch.from_numpy(st))
    assert mult.dtype == torch.int32 and psum.dtype == torch.int64
    np.testing.assert_array_equal(mult.numpy(), np.asarray(want_mult))
    np.testing.assert_array_equal(psum.numpy(), np.asarray(want_psum))


def test_merge_scan_stats_all_builds_and_empty():
    sk = torch.tensor([I64_MIN, I64_MIN, 0, I64_MAX])
    st = torch.tensor([3, 5, 7, 9])
    mult, psum = merge_scan.merge_scan_stats(sk, st)
    assert mult.tolist() == [0] * 4 and psum.tolist() == [0] * 4
    mult, psum = merge_scan.merge_scan_stats(sk[:0], st[:0])
    assert mult.shape == (0,) and psum.shape == (0,)
    with pytest.raises(TypeError):
        merge_scan.merge_scan_stats(sk.to(torch.int32), st)


@pytest.mark.parametrize(
    "m, n, dups, probe_dtype",
    [(400, 1200, 50, np.int64), (3000, 2500, 0, np.int64), (700, 900, 200, np.int32)],
)
def test_sorted_match_totals_full_range_matches_jax(m, n, dups, probe_dtype):
    rng = np.random.default_rng(7 * m + n)
    keys = _full_range_keys(rng, m, dups)
    payloads = rng.integers(0, 2**30, m)
    if probe_dtype == np.int32:
        # an int32 probe column against a full-range table: every probe key
        # is near 0, so the table gets some there
        keys[-100:] = rng.integers(-(2**31), 2**31 - 1, 100)
        probe = np.concatenate([rng.choice(keys[-100:], n // 2),
                                rng.integers(-(2**31), 2**31 - 1, n - n // 2)]).astype(np.int32)
    else:
        probe = _probes(rng, keys, n)
    jax_table = jax_sm.build_sorted(keys, payloads)
    table = _crossed(jax_table)
    assert table.pack32 is None and not table.span62
    want = interpret(lambda p: jax_sm.sorted_match_totals(jax_table, p, use_kernel=True),
                     jnp.asarray(probe.astype(np.int64)))
    want = (int(want[0]), int(want[1]))
    assert want == _numpy_totals(keys, payloads, probe.astype(np.int64))
    count, checksum = sm.sorted_match_totals(table, torch.from_numpy(probe))
    assert (int(count), int(checksum)) == want
    res = bulk_count([table], probe[:, None])
    assert (int(res.count), res.payload_checksums.tolist()) == (want[0], [want[1]])
    built = sm.build_sorted(keys, payloads, device="cpu")
    assert all(getattr(built, f) == getattr(table, f) for f in sm.META_FIELDS)
    assert sm.sorted_match_totals(built, probe) == (count, checksum)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_sorted_build_counts_full_range_matches_jax(dtype):
    rng = np.random.default_rng(5)
    keys = _full_range_keys(rng, 600, 80)
    keys[-50:] = rng.integers(-1000, 1000, 50)
    probe = np.concatenate([rng.choice(keys, 800), rng.integers(-1000, 1000, 400)])
    if dtype == np.int32:
        probe = np.clip(probe, -(2**31), 2**31 - 1)
    probe = probe.astype(dtype)
    jax_table = jax_sm.build_sorted(keys, rng.integers(0, 2**30, keys.size))
    want = np.asarray(jax_sm.sorted_build_counts(jax_table, jnp.asarray(probe.astype(np.int64))))
    got = sm.sorted_build_counts(_crossed(jax_table), torch.from_numpy(probe))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    sk = np.sort(keys)
    np.testing.assert_array_equal(
        want, np.searchsorted(np.sort(probe.astype(np.int64)), sk, "right")
        - np.searchsorted(np.sort(probe.astype(np.int64)), sk, "left"))


def test_generic_totals_negative_payloads():
    """Port only, against numpy: payloads of either sign, up to 2^61 in
    magnitude, stay exact through the segmented scan."""
    rng = np.random.default_rng(11)
    keys = _full_range_keys(rng, 1500, 300)
    payloads = rng.integers(-(2**61), 2**61, keys.size)
    probe = _probes(rng, keys, 4000)
    table = sm.build_sorted(keys, payloads, device="cpu")
    count, checksum = sm.sorted_match_totals(table, probe)
    want_count, want_checksum = _numpy_totals(keys, payloads, probe)
    assert int(count) == want_count
    assert int(checksum) == (want_checksum + 2**63) % 2**64 - 2**63  # int64 wraps



def test_generic_totals_payload_limits_exact():
    """Payloads at both ends of [-2^62, 2^62), where the tag pay * 2 + 1
    still holds them, are exact against numpy (the sum wraps as int64)."""
    rng = np.random.default_rng(13)
    keys = _full_range_keys(rng, 600, 100)
    payloads = rng.choice(np.array([-(2**62), 2**62 - 1, -1, 0], dtype=np.int64), keys.size)
    probe = _probes(rng, keys, 2000)
    table = sm.build_sorted(keys, payloads, device="cpu")
    assert table.pay62
    count, checksum = sm.sorted_match_totals(table, probe)
    want_count, want_checksum = _numpy_totals(keys, payloads, probe)
    assert int(count) == want_count
    assert int(checksum) == (want_checksum + 2**63) % 2**64 - 2**63


@pytest.mark.parametrize("bad", [2**62, -(2**62) - 1, I64_MAX, I64_MIN])
def test_generic_totals_refuse_payloads_past_2_62(bad):
    """A payload outside [-2^62, 2^62) would wrap in its tag: the
    full-range totals raise, through build_sorted's table and a crossed
    one alike, and single-level bulk_count with them."""
    rng = np.random.default_rng(14)
    keys = _full_range_keys(rng, 50, 0)
    payloads = rng.integers(0, 100, keys.size)
    payloads[7] = bad
    probe = _probes(rng, keys, 80)
    table = sm.build_sorted(keys, payloads, device="cpu")
    crossed = _crossed(jax_sm.build_sorted(keys, payloads))
    for t in (table, crossed):
        assert not t.pay62
        with pytest.raises(ValueError, match=r"\[-2\^62, 2\^62\)"):
            sm.sorted_match_totals(t, probe)
        with pytest.raises(ValueError, match=r"\[-2\^62, 2\^62\)"):
            bulk_count([t], probe[:, None])
    # the counts need no tag, and the packed routes no limit
    np.testing.assert_array_equal(
        sm.sorted_build_counts(table, probe).numpy(),
        np.searchsorted(np.sort(probe), table.keys.numpy(), "right")
        - np.searchsorted(np.sort(probe), table.keys.numpy(), "left"))
    small = sm.build_sorted(np.arange(keys.size), payloads, device="cpu")
    assert not small.pay62
    assert int(sm.sorted_match_totals(small, np.arange(keys.size))[0]) == keys.size

def test_jax_generic_scan_is_wrong_on_negative_payloads():
    """The reference fault of ROADMAP Queue 3: JAX's generic totals under
    `use_kernel=True` take the matched-payload sum's base as a prefix max,
    so negative payloads give a wrong checksum where the port's, like
    numpy's, is exact. The counts agree."""
    rng = np.random.default_rng(12)
    keys = _full_range_keys(rng, 400, 60)
    payloads = rng.integers(-(2**20), 2**20, keys.size)
    probe = _probes(rng, keys, 1000)
    jax_table = jax_sm.build_sorted(keys, payloads)
    got = sm.sorted_match_totals(_crossed(jax_table), probe)
    jax_got = interpret(lambda p: jax_sm.sorted_match_totals(jax_table, p, use_kernel=True),
                        jnp.asarray(probe))
    want = _numpy_totals(keys, payloads, probe)
    assert (int(got[0]), int(got[1])) == want
    assert int(jax_got[0]) == want[0] and int(jax_got[1]) != want[1]


def test_config1_full_range_host_through_bulk_count():
    """chip_smoke.py's full-range cell at a small size: both extremes among
    the build keys, a key span past 2^62, and bulk_count equal to numpy."""
    from ccve_tpu_torch.bench.configs import config1_full_range_host, numpy_totals

    keys, payloads, probe = config1_full_range_host(4096, 1 << 13)
    assert keys.min() == I64_MIN and keys.max() == I64_MAX
    assert payloads.min() >= 0 and payloads.max() < 2**30
    table = sm.build_sorted(keys, payloads, device="cpu")
    assert table.pack32 is None and not table.span62
    res = bulk_count([table], probe[:, None])
    want = numpy_totals(keys, payloads, probe)
    assert want[0] >= probe.size // 2
    assert (int(res.count), int(res.payload_checksums[0])) == want
