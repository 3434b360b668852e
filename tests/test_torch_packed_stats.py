"""The port's packed stats scan (#16, `merge_scan_stats_packed`), its plain
version on the CPU, against the JAX package's (Pallas interpret mode) on
the same sorted packed streams, at several `pay_bits`; and the packed
totals, as the JAX package's `table.pack` builds them, against numpy.
Tolerance 0: every output is an integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.kernels.merge_scan import merge_scan_stats_packed as jax_packed
from ccve_tpu.ops import sort_merge as jax_sm
from ccve_tpu_torch.kernels import merge_scan
from torch_interpret import interpret


def _packed_stream(rng, m, n, dom, pay_bits, key_base=0):
    """A sorted packed stream `key' << pay_bits | field`: builds with even
    fields pay * 2 (pay < 2^(pay_bits - 1)), probes with the all-ones tag,
    some probes on keys no build has."""
    bkeys = rng.integers(0, dom, m) + key_base
    pkeys = rng.integers(0, dom + 5, n) + key_base
    pays = rng.integers(0, 2 ** (pay_bits - 1), m)
    tag = (1 << pay_bits) - 1
    s = np.concatenate([(bkeys << pay_bits) | (pays << 1), (pkeys << pay_bits) | tag])
    return np.sort(s.astype(np.int64)), bkeys, pays, pkeys


@pytest.mark.parametrize(
    "pay_bits, m, n, dom, key_base",
    [
        (2, 500, 3000, 40, 0),  # one-bit payloads
        (7, 2000, 1000, 300, 2**40),
        (25, 1500, 1500, 100, 2**30),
        (31, 800, 2500, 1000, 2**31 - 5),  # pay_bits 31 with key' 2^31: past the low limb
    ],
)
def test_merge_scan_stats_packed_matches_jax(pay_bits, m, n, dom, key_base):
    rng = np.random.default_rng(pay_bits * 100 + m)
    s, bkeys, pays, pkeys = _packed_stream(rng, m, n, dom, pay_bits, key_base)
    want_mult, want_psum = interpret(lambda x: jax_packed(x, pay_bits), jnp.asarray(s))
    mult, psum = merge_scan.merge_scan_stats_packed(torch.from_numpy(s), pay_bits)
    assert mult.dtype == torch.int32 and psum.dtype == torch.int64
    np.testing.assert_array_equal(mult.numpy(), np.asarray(want_mult))
    np.testing.assert_array_equal(psum.numpy(), np.asarray(want_psum))
    # and against numpy: per probe key, the builds on it and their payloads
    match = pkeys[:, None] == bkeys[None, :]
    assert int(mult.sum()) == int(match.sum())
    assert int(psum.sum()) == int((match * pays[None, :]).sum())


@pytest.mark.parametrize("pay_bits", [0, 1, 32, 40])
def test_merge_scan_stats_packed_refuses_pay_bits(pay_bits):
    with pytest.raises(ValueError, match="pay_bits"):
        merge_scan.merge_scan_stats_packed(torch.zeros(4, dtype=torch.int64), pay_bits)


def test_packed_totals_of_a_table_pack():
    """A table packed as the JAX package's `table.pack` packs it (clamped
    probe keys, `key' << pay_bits | pay << 1` builds, all-ones probes),
    sorted, then scanned: Σ mult and Σ psum are the join's count and
    checksum."""
    rng = np.random.default_rng(3)
    keys = rng.integers(100, 5000, 3000)
    payloads = rng.integers(0, 2**20, 3000)
    probe = rng.integers(0, 5200, 6000)
    table = jax_sm.build_sorted(keys, payloads)
    kmin, key_bits, pay_bits = table.pack
    key_lo, tag = kmin - 1, (1 << pay_bits) - 1
    built = ((keys - key_lo) << pay_bits) | (payloads << 1)
    probed = (np.clip(probe - key_lo, 0, (1 << key_bits) - 1) << pay_bits) | tag
    s = torch.from_numpy(np.concatenate([built, probed]).astype(np.int64)).sort().values
    mult, psum = merge_scan.merge_scan_stats_packed(s, pay_bits)
    want = jax_sm.sorted_match_totals(table, jnp.asarray(probe), use_kernel=False)
    assert (int(mult.to(torch.int64).sum()), int(psum.sum())) == (int(want[0]), int(want[1]))
