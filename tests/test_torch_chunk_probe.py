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


@pytest.mark.parametrize("m", [0, 1, 63, 64, 65, 64 * 4096 - 1, 64 * 4096, 64 * 4096 + 1,
                               1 << 21, 1 << 24, (1 << 24) + 1, 2**31 - 1])
def test_index_stride_fits_and_covers(m):
    """The kernel's index: within INDEX_MAX keys, covering all m rows, at
    the least stride that does both (never below 2^MIN_STRIDE_LOG)."""
    log = chunk_probe.index_stride_log(m)
    n_index = -(-m // (1 << log))
    assert log >= chunk_probe.MIN_STRIDE_LOG
    assert n_index <= chunk_probe.INDEX_MAX and n_index << log >= m
    assert log == chunk_probe.MIN_STRIDE_LOG or -(-m // (1 << (log - 1))) > chunk_probe.INDEX_MAX


def _bound_in(table, lo, hi, k, upper, loads):
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        loads[0] += 1
        if (table[mid] <= k) if upper else (table[mid] < k):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _kernel_model(table, keys, valid):
    """csrc/chunk_rank.cu's search, lane by lane: (mult, start, the most
    device-memory loads of a lane whose key is absent or unique, the most
    of any lane)."""
    m = table.size
    log = chunk_probe.index_stride_log(m)
    index = table[::1 << log]
    mult, start = np.zeros(keys.size, np.int32), np.zeros(keys.size, np.int32)
    few = most = 0
    for lane, k in enumerate(keys.tolist()):
        loads = [0]
        j = int(np.searchsorted(index, k, "left"))  # the index, in shared memory
        first = 0
        if j:
            first = _bound_in(table, ((j - 1) << log) + 1, min(j << log, m), k, False, loads)
        count = 0
        if valid[lane] and first < m:
            loads[0] += 1
            if table[first] == k:
                last = first + 1
                if last < m:
                    loads[0] += 1
                if last < m and table[last] == k:
                    j2 = int(np.searchsorted(index, k, "right"))
                    last = _bound_in(table, max(((j2 - 1) << log) + 1, last + 1),
                                     min(j2 << log, m), k, True, loads)
                count = last - first
        mult[lane], start[lane] = count, first
        most = max(most, loads[0])
        if count <= 1:
            few = max(few, loads[0])
    return mult, start, few, most


def test_kernel_search_model_at_the_edges():
    """The kernel's index, leaf and gallop searches, modelled lane by lane,
    give numpy's ranks on every edge case of `bench.edge_cases` (tables of
    stride·k ± 1 rows, sampled keys, runs across leaf boundaries, a hot
    key, the int64 extremes, m = 0): at most log2(stride) + 2 loads from
    device memory for an absent or unique key and 2 log2(stride) + 2 for
    any key. The plain version gives the same ranks."""
    from ccve_tpu_torch.bench.edge_cases import HOT_RUN, chunk_rank_cases

    cases = chunk_rank_cases(np.random.default_rng(30), big=False)
    hot_seen = False
    for what, table, keys, valid in cases:
        want_mult, want_start = _numpy(table, keys, valid)
        mult, start, few, most = _kernel_model(table, keys, valid)
        np.testing.assert_array_equal(mult, want_mult, err_msg=what)
        np.testing.assert_array_equal(start, want_start, err_msg=what)
        log = chunk_probe.index_stride_log(table.size)
        assert few <= log + 2 and most <= 2 * log + 2, what
        hot_seen |= int(want_mult.max(initial=0)) >= HOT_RUN
        t = torch.from_numpy
        p_mult, p_start = chunk_probe.chunk_rank_plain(t(table), t(keys), t(valid))
        np.testing.assert_array_equal(p_mult.numpy(), want_mult, err_msg=what)
        np.testing.assert_array_equal(p_start.numpy(), want_start, err_msg=what)
    assert hot_seen
