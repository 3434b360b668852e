"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips without them. This
file imports neither JAX nor `ccve_tpu`, so on a machine without JAX run it
without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ccve_tpu_torch.bench.edge_cases import (
    CANDIDATE_KINDS,
    MERGE_COUNTS_KINDS,
    NARROW_TABLES,
    NARROW_WIDE_TABLES,
    candidates_case,
    merge_counts_case,
    narrow_case,
    probe_runs,
)
from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.exec import bulk
from ccve_tpu_torch.kernels import bigsort, compact, emit, merge_scan, pairsort
from ccve_tpu_torch.ops import sort_merge as sm
from ccve_tpu_torch.ops.hash_table import build_csr, build_lp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _i32(a, device):
    return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(device)


@pytest.mark.parametrize("tile_log", [1, 4, 11, bigsort.TILE_LOG])
@pytest.mark.parametrize("nt", [1, 3, 13])
def test_sort_tiles_kernel(cuda, tile_log, nt):
    rng = np.random.default_rng(nt * 100 + tile_log)
    x = _i32(rng.integers(-(2**31), 2**31 - 1, nt << tile_log), cuda)
    got = bigsort.sort_tiles_i32(x, tile_log)
    assert torch.equal(got, bigsort.sort_tiles_plain(x, tile_log))


@pytest.mark.parametrize("n", [1, 5, 2049, 10_000, 5 << 13])
@pytest.mark.parametrize("dom", [3, 2**31 - 1])
def test_merge_level_kernel(cuda, n, dom):
    rng = np.random.default_rng(n)
    runs = _i32(rng.integers(0, dom, n), cuda)
    for run_log in range(16):
        got = bigsort.merge_level_i32(runs, run_log)
        runs = bigsort.merge_level_plain(runs, run_log)
        assert torch.equal(got, runs), run_log


@pytest.mark.parametrize("nt", [1, 2, 3, 5, 13])
def test_sort_runs_kernel(cuda, nt):
    rng = np.random.default_rng(nt)
    x = _i32(rng.integers(-(2**31), 2**31 - 1, nt << bigsort.TILE_LOG), cuda)
    for run_log in range(bigsort.TILE_LOG, bigsort.TILE_LOG + 5):
        got = bigsort.sort_runs(x, run_log)
        assert torch.equal(got, bigsort.sort_runs_plain(x, run_log)), run_log


@pytest.mark.parametrize(
    "n, m, dup",
    [(100_000, 30_000, False), (40_000, 70_000, True), (33_333, 100, True), (0, 10, False)],
)
def test_merge_counts_kernel(cuda, n, m, dup):
    rng = np.random.default_rng(n + m)
    dom = max(m, 1000)
    probes = rng.integers(0, dom + 8, n) * 2
    n_pad = n + (-n) % 2048
    p = _i32(np.concatenate([probes, np.full(n_pad - n, 2**31 - 1)]), cuda)
    runs = bigsort.sort_runs_plain(p, 11, 11)
    builds = rng.integers(0, dom, m) if dup else rng.choice(dom, m, replace=False)
    b32 = _i32(np.sort(builds) * 2 + 3, cuda)
    got = merge_scan.merge_counts_i32(runs, 2048, n, b32, m)
    assert torch.equal(got, merge_scan.merge_counts_plain(runs, 2048, n, b32, m))


@pytest.mark.parametrize("chunk_factor", [1, 4])
def test_totals_on_card_match_cpu(cuda, chunk_factor):
    from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table

    keys, pays = gen_rhs_table(50_000, chunk_factor)
    probe = gen_probe_table(300_000, 1, 50_000)[:, 0]
    for device in (cuda, "cpu"):
        launches = merge_scan.merge_counts_i32.launches
        c, s = sm.sorted_match_totals(sm.build_sorted(keys, pays, device), probe)
        if device == cuda:
            assert merge_scan.merge_counts_i32.launches == launches + 1
            got = (int(c), int(s))
        else:
            assert (int(c), int(s)) == got


def _planes(rng, n, count, device):
    return [_i32(rng.integers(-(2**31), 2**31 - 1, n), device) for _ in range(count)]


def _same(got, want):
    got_keys, got_vals = got
    want_keys, want_vals = want
    assert torch.equal(got_keys, want_keys)
    assert len(got_vals) == len(want_vals)
    for g, w in zip(got_vals, want_vals):
        assert torch.equal(g, w)


@pytest.mark.parametrize("tile_log", [1, 4, 11, pairsort.TILE_LOG])
@pytest.mark.parametrize("n_planes", [1, 2, 3])
@pytest.mark.parametrize("dom", [3, 2**31 - 1])
def test_sort_tiles_multi_kernel(cuda, tile_log, n_planes, dom):
    rng = np.random.default_rng(tile_log * 10 + n_planes)
    n = 5 << tile_log
    keys = _i32(rng.integers(-dom, dom, n), cuda)
    vals = _planes(rng, n, n_planes, cuda)
    _same(pairsort.sort_tiles_multi_i32(keys, vals, tile_log),
          pairsort.sort_tiles_multi_plain(keys, vals, tile_log))


@pytest.mark.parametrize("n", [1, 5, 2049, 10_000, 3 << 13])
@pytest.mark.parametrize("n_planes", [1, 3])
def test_merge_level_multi_kernel(cuda, n, n_planes):
    rng = np.random.default_rng(n)
    keys = _i32(rng.integers(0, 7, n), cuda)
    vals = _planes(rng, n, n_planes, cuda)
    for run_log in range(16):
        got = pairsort.merge_level_multi_i32(keys, vals, run_log)
        keys, vals = pairsort.merge_level_multi_plain(keys, vals, run_log)
        _same(got, (keys, vals))


@pytest.mark.parametrize(
    "na, nb", [(0, 0), (0, 9), (9, 0), (3000, 2100), (1, 70_000), (100_003, 17)]
)
@pytest.mark.parametrize("n_planes", [1, 2, 3])
def test_merge_two_multi_kernel(cuda, na, nb, n_planes):
    rng = np.random.default_rng(na + nb + n_planes)
    ak = _i32(np.sort(rng.integers(0, 50, na)), cuda)
    bk = _i32(np.sort(rng.integers(0, 50, nb)), cuda)
    avs = _planes(rng, na, n_planes, cuda)
    bvs = _planes(rng, nb, n_planes, cuda)
    _same(pairsort.merge_two_multi_i32(ak, avs, bk, bvs),
          pairsort.merge_two_multi_plain(ak, avs, bk, bvs))


@pytest.mark.parametrize("n", [0, 1, 8191, 8193, 100_000])
def test_sort_multi_kernel_path(cuda, n):
    rng = np.random.default_rng(n)
    keys = _i32(rng.integers(-(2**31), 2**31 - 1, n), cuda)
    vals = _planes(rng, n, 2, cuda)
    _same(pairsort.sort_multi_i32(keys, vals), pairsort.sort_multi_plain(keys, vals))
    for run_log in (13, 14, 20):
        _same(pairsort.sort_multi_i32_runs(keys, vals, run_log),
              pairsort.sort_multi_runs_plain(keys, vals, run_log))


def _stats_stream(rng, n, m, dom, pay_lo, pay_hi, device):
    builds = np.sort(rng.integers(0, dom, m))
    probes = rng.integers(0, dom + 3, n)  # some above every build
    s = np.concatenate([builds * 2, probes * 2 + 1])
    v = np.concatenate([rng.integers(pay_lo, pay_hi, m), np.arange(n)])
    order = np.argsort(s, kind="stable")
    return _i32(s[order], device), _i32(v[order], device)


@pytest.mark.parametrize(
    "n, m, dom, pay_lo, pay_hi",
    [
        (0, 10, 5, 0, 9),
        (10, 0, 5, 0, 9),
        (50_000, 30_000, 5000, 0, 2**20),
        (70_000, 2000, 300, 2**29, 2**30),  # psum past 2^31
        (40_000, 15_000, 700, -(2**31), 2**31 - 1),  # negative payloads
        (300_000, 5, 2, 0, 1),  # zero payloads, long runs
    ],
)
def test_merge_stats_kernel(cuda, n, m, dom, pay_lo, pay_hi):
    rng = np.random.default_rng(n + m)
    s, v = _stats_stream(rng, n, m, dom, pay_lo, pay_hi, cuda)
    got = merge_scan.merge_stats_i32(s, v, n)
    want = merge_scan.merge_stats_plain(s, v, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n_planes", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 2047, 2049, 1_000_003])
@pytest.mark.parametrize("kind", ["all", "none", "random"])
def test_compact_kernel(cuda, n_planes, n, kind):
    rng = np.random.default_rng(n + n_planes)
    planes = torch.from_numpy(
        rng.integers(-(2**31), 2**31 - 1, (n_planes, n)).astype(np.int32)
    ).to(cuda)
    mask = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
            "random": rng.random(n) < 0.4}[kind]
    mask = torch.from_numpy(mask).to(cuda)
    got, count = compact.compact_i32(planes, mask)
    want, want_count = compact.compact_plain(planes, mask)
    assert int(count) == int(want_count)
    assert torch.equal(got, want)


def test_slice_two_reaches_the_kernels(cuda):
    """On CUDA tensors the stats and expand paths launch the kernels, never
    the plain versions."""
    from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table

    keys, pays = gen_rhs_table(20_000, 2)
    probe = torch.from_numpy(gen_probe_table(100_000, 1, 20_000)[:, 0]).to(cuda)
    counters = [pairsort.sort_tiles_multi_i32, pairsort.merge_level_multi_i32,
                pairsort.merge_two_multi_i32, merge_scan.merge_stats_i32,
                merge_scan.expand_candidates_i32, compact.compact_i32]
    before = [fn.launches for fn in counters]
    table = sm.build_sorted(keys, pays, cuda)
    stats = sm.sorted_match_stats(table, probe)
    rows, _, _, total = sm.sorted_expand(table, probe, 2 * probe.numel())
    after = [fn.launches for fn in counters]
    assert all(a > b for a, b in zip(after, before)), (before, after)
    cpu = sm.sorted_match_stats(sm.build_sorted(keys, pays, device="cpu"), probe.cpu())
    assert torch.equal(stats.mult.cpu(), cpu.mult)
    assert torch.equal(stats.psum.cpu(), cpu.psum)
    assert int(total) == int(cpu.mult.sum())


# ---- the int64 builds (slice 3) -------------------------------------------

I64_MAX = 2**63 - 1


def _i64(a, device):
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)


def _wide(rng, n, dom=None):
    """int64 keys: near ±2^62 and over the whole range, or in [0, dom)."""
    if dom is not None:
        return rng.integers(0, dom, n, dtype=np.int64)
    keys = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    near = rng.random(n) < 0.5
    k = int(near.sum())
    keys[near] = rng.integers(2**62 - 50, 2**62 + 50, k) * rng.choice([-1, 1], k)
    keys[rng.random(n) < 0.05] = I64_MAX
    return keys


@pytest.mark.parametrize("tile_log", [1, 4, 11, bigsort.TILE_LOG])
@pytest.mark.parametrize("nt", [1, 3, 13])
def test_sort_tiles_i64_kernel(cuda, tile_log, nt):
    rng = np.random.default_rng(nt * 100 + tile_log)
    x = _i64(_wide(rng, nt << tile_log), cuda)
    got = bigsort.sort_tiles_i64(x, tile_log)
    assert torch.equal(got, bigsort.sort_tiles_plain(x, tile_log))


@pytest.mark.parametrize("n", [1, 5, 2049, 10_000, 5 << 13])
@pytest.mark.parametrize("dom", [3, None])
def test_merge_level_i64_kernel(cuda, n, dom):
    rng = np.random.default_rng(n)
    runs = _i64(_wide(rng, n, dom), cuda)  # runs of one value are sorted
    for run_log in range(16):
        got = bigsort.merge_level_i64(runs, run_log)
        runs = bigsort.merge_level_plain(runs, run_log)
        assert torch.equal(got, runs), run_log


@pytest.mark.parametrize("nt", [1, 2, 3, 5, 13])
def test_sort_runs_i64_kernel(cuda, nt):
    rng = np.random.default_rng(nt)
    x = _i64(_wide(rng, nt << bigsort.TILE_LOG), cuda)
    for run_log in range(bigsort.TILE_LOG, bigsort.TILE_LOG + 5):
        got = bigsort.sort_runs(x, run_log)
        assert torch.equal(got, bigsort.sort_runs_plain(x, run_log)), run_log


@pytest.mark.parametrize(
    "n, m, dup",
    [(100_000, 30_000, False), (40_000, 70_000, True), (33_333, 100, True), (0, 10, False)],
)
def test_merge_counts_i64_kernel(cuda, n, m, dup):
    rng = np.random.default_rng(n + m)
    dom = max(m, 1000)
    base = 2**61 - 5 * dom  # packed keys near the top of the int64 range
    probes = (base + rng.integers(0, dom + 8, n)) * 2
    n_pad = n + (-n) % 2048
    p = _i64(np.concatenate([probes, np.full(n_pad - n, I64_MAX)]), cuda)
    runs = bigsort.sort_runs_plain(p, 11, 11)
    builds = rng.integers(0, dom, m) if dup else rng.choice(dom, m, replace=False)
    b64 = _i64((base + np.sort(builds)) * 2 + 1, cuda)
    got = merge_scan.merge_counts_i64(runs, 2048, n, b64, m)
    assert torch.equal(got, merge_scan.merge_counts_plain(runs, 2048, n, b64, m))


def _counts_on(runs, run_len, n_real, b, device, offset=0):
    """(runs, b) on the card; with `offset`, each a view that starts
    `offset` elements into its allocation (so that the staging's 16-byte
    copies start past a misaligned head)."""
    def put(a):
        t = torch.from_numpy(np.concatenate([np.zeros(offset, a.dtype), a])).to(device)
        return t[offset:]
    return put(runs), put(b)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", MERGE_COUNTS_KINDS)
@pytest.mark.parametrize("offset", [0, 1])
def test_merge_counts_edge_cases(cuda, dtype, kind, offset):
    """#3 and #14 on `bench.edge_cases.merge_counts_case`: repeated keys,
    one across a tile boundary and two tiles of one key, one key holding
    most probes (slices past the stage, counted in device memory), n_real
    inside a run and runs past it, 256 runs of 2^11 and a single run, m > n,
    m = 1, n = 0 and the key type's extremes; exact."""
    rng = np.random.default_rng(MERGE_COUNTS_KINDS.index(kind))
    runs_np, run_len, n_real, b_np = merge_counts_case(rng, dtype, kind)
    runs, b = _counts_on(runs_np, run_len, n_real, b_np, cuda, offset)
    wrapper = merge_scan.MERGE_COUNTS[runs.dtype]
    launches = wrapper.launches
    got = wrapper(runs, run_len, n_real, b, b.numel())
    assert wrapper.launches == launches + 1
    assert torch.equal(got, merge_scan.merge_counts_plain(runs, run_len, n_real, b, b.numel()))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("run_log", [11, 14, 17, 20])
def test_merge_counts_at_config_1_density(cuda, dtype, run_log):
    """2^20 probes against 2^16 builds (config 1's 16 probes a build row)
    in runs of 2^11 to 2^20: from 512 runs (four run batches) to one, a
    few slices of each tile past the stage where a key's probes bunch."""
    rng = np.random.default_rng(run_log)
    keys = np.sort(rng.choice(1 << 22, 1 << 16, replace=False))
    probes = rng.choice(keys, (1 << 20) - 77)
    probes[:3000] = keys[5000]
    runs_np = probe_runs(probes * 2, run_log, dtype)
    runs, b = _counts_on(runs_np, 1 << run_log, probes.size, (keys * 2 + 1).astype(dtype), cuda)
    got = merge_scan.MERGE_COUNTS[runs.dtype](runs, 1 << run_log, probes.size, b, b.numel())
    want = merge_scan.merge_counts_plain(runs, 1 << run_log, probes.size, b, b.numel())
    assert torch.equal(got, want) and int(want.sum()) == probes.size


def test_merge_counts_again_and_again(cuda):
    """Twenty calls of each entry on each of four streams at once (uniform
    and one-heavy-key inputs of both key types), each equal to the plain
    version: no block depends on another's work or on launch order."""
    rng = np.random.default_rng(14)
    inputs = []
    for dtype in (np.int32, np.int64):
        for kind in ("repeated", "one key holds most probes"):
            runs_np, run_len, n_real, b_np = merge_counts_case(rng, dtype, kind)
            inputs.append((*_counts_on(runs_np, run_len, n_real, b_np, cuda), run_len, n_real))
    wants = [merge_scan.merge_counts_plain(r, rl, nr, b, b.numel()) for r, b, rl, nr in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    results = [[] for _ in inputs]
    for _ in range(20):
        for s, (r, b, rl, nr), out in zip(streams, inputs, results):
            with torch.cuda.stream(s):
                out.append(merge_scan.MERGE_COUNTS[r.dtype](r, rl, nr, b, b.numel()))
    torch.cuda.synchronize()
    for want, out in zip(wants, results):
        for got in out:
            assert torch.equal(got, want)


@pytest.mark.parametrize("tile_log", [1, 4, 11, pairsort.TILE_LOG])
@pytest.mark.parametrize("n_planes", [1, 2, 3])
@pytest.mark.parametrize("dom", [3, None])
def test_sort_tiles_multi_i64_kernel(cuda, tile_log, n_planes, dom):
    rng = np.random.default_rng(tile_log * 10 + n_planes)
    n = 5 << tile_log
    keys = _i64(_wide(rng, n, dom), cuda)
    vals = _planes(rng, n, n_planes, cuda)
    _same(pairsort.sort_tiles_multi_i64(keys, vals, tile_log),
          pairsort.sort_tiles_multi_plain(keys, vals, tile_log))


@pytest.mark.parametrize("n", [1, 5, 2049, 10_000, 3 << 13])
@pytest.mark.parametrize("n_planes", [1, 3])
def test_merge_level_multi_i64_kernel(cuda, n, n_planes):
    rng = np.random.default_rng(n)
    keys = _i64(rng.integers(0, 7, n) + 2**62, cuda)
    vals = _planes(rng, n, n_planes, cuda)
    for run_log in range(16):
        got = pairsort.merge_level_multi_i64(keys, vals, run_log)
        keys, vals = pairsort.merge_level_multi_plain(keys, vals, run_log)
        _same(got, (keys, vals))


@pytest.mark.parametrize(
    "na, nb", [(0, 0), (0, 9), (9, 0), (3000, 2100), (1, 70_000), (100_003, 17)]
)
@pytest.mark.parametrize("n_planes", [1, 2, 3])
def test_merge_two_multi_i64_kernel(cuda, na, nb, n_planes):
    rng = np.random.default_rng(na + nb + n_planes)
    ak = _i64(np.sort(rng.integers(-50, 50, na) * 2**56), cuda)
    bk = _i64(np.sort(rng.integers(-50, 50, nb) * 2**56), cuda)
    avs = _planes(rng, na, n_planes, cuda)
    bvs = _planes(rng, nb, n_planes, cuda)
    _same(pairsort.merge_two_multi_i64(ak, avs, bk, bvs),
          pairsort.merge_two_multi_plain(ak, avs, bk, bvs))


@pytest.mark.parametrize("n", [0, 1, 8191, 8193, 100_000])
def test_sort_multi_i64_kernel_path(cuda, n):
    rng = np.random.default_rng(n)
    keys = _i64(_wide(rng, n), cuda)
    vals = _planes(rng, n, 2, cuda)
    _same(pairsort.sort_multi_i64(keys, vals), pairsort.sort_multi_plain(keys, vals))


@pytest.mark.parametrize(
    "n, m, dom, pay_lo, pay_hi",
    [
        (0, 10, 5, 0, 9),
        (10, 0, 5, 0, 9),
        (50_000, 30_000, 5000, 0, 2**20),
        (70_000, 2000, 300, 2**29, 2**30),  # psum past 2^31
        (40_000, 15_000, 700, -(2**31), 2**31 - 1),  # negative payloads
        (300_000, 5, 2, 0, 1),  # zero payloads, long runs
    ],
)
def test_merge_stats_i64_kernel(cuda, n, m, dom, pay_lo, pay_hi):
    rng = np.random.default_rng(n + m)
    s, v = _stats_stream(rng, n, m, dom, pay_lo, pay_hi, "cpu")
    s = s.long()
    s = ((((s >> 1) + 2**61) << 1) | (s & 1)).to(cuda)  # key' near 2^61
    v = v.to(cuda)
    got = merge_scan.merge_stats_i64(s, v, n)
    want = merge_scan.merge_stats_plain(s, v, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wide_paths_reach_the_kernels(cuda):
    """On CUDA tensors a wide table's count side and stats side launch the
    int64 kernels (the count side's tile sort as #13's narrowing load,
    `sort_runs_narrowed_i64`, never as the key-only `sort_tiles_i64`), and
    agree with the CPU's plain versions; the key-only `sort_tiles_i64`
    still serves `_count_side_bc` on packed int64 streams."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**40, 20_000, dtype=np.int64)
    pays = rng.integers(-(2**30), 2**30, keys.size)
    probe_np = np.concatenate([rng.choice(keys, 60_000), rng.integers(0, 2**40, 40_000)])
    probe = torch.from_numpy(probe_np).to(cuda)
    counters = [bigsort.sort_runs_narrowed_i64, bigsort.merge_level_i64,
                merge_scan.merge_counts_i64, pairsort.sort_tiles_multi_i64,
                pairsort.merge_level_multi_i64, pairsort.merge_two_multi_i64,
                merge_scan.merge_stats_i64]
    before = [fn.launches for fn in counters]
    key_only = bigsort.sort_tiles_i64.launches
    table = sm.build_sorted(keys, pays)
    assert table.device.type == "cuda" and table.pack32 is None
    count, checksum = sm.sorted_match_totals(table, probe)
    stats = sm.sorted_match_stats(table, probe)
    after = [fn.launches for fn in counters]
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert bigsort.sort_tiles_i64.launches == key_only
    p, b = sm.pack64_streams(table, probe)
    bc = sm._count_side_bc(p, b, keys.size)
    assert bigsort.sort_tiles_i64.launches == key_only + 1
    assert torch.equal(bc, sm.sorted_build_counts(table, probe))
    cpu_table = sm.build_sorted(keys, pays, device="cpu")
    want = sm.sorted_match_totals(cpu_table, probe_np)
    assert (int(count), int(checksum)) == (int(want[0]), int(want[1]))
    cpu = sm.sorted_match_stats(cpu_table, probe_np)
    assert torch.equal(stats.mult.cpu(), cpu.mult)
    assert torch.equal(stats.psum.cpu(), cpu.psum)


# ---- the hash engines (slice 4): kernel #12 and the LP ladder --------------

MURMUR_EXTREMES = [0, 1, -1, -(2**63), I64_MAX, 2**32 - 1, 2**32, -(2**32)]


@pytest.mark.parametrize("n", [0, 1, 1001, (1 << 20) + 3])
def test_murmurhash64_kernel(cuda, n):
    from ccve_tpu_torch.kernels import murmur

    rng = np.random.default_rng(n)
    x_np = rng.integers(-(2**63), I64_MAX, n, dtype=np.int64, endpoint=True)
    x_np[: min(n, len(MURMUR_EXTREMES))] = MURMUR_EXTREMES[: min(n, len(MURMUR_EXTREMES))]
    x = _i64(x_np, cuda)
    got = murmur.murmurhash64_i64(x)
    assert torch.equal(got, murmur.murmurhash64_plain(x))
    assert torch.equal(got.cpu(), murmur.murmurhash64_plain(x.cpu()))


def _hash_data(n_build, chunk_factor, n_probe):
    from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table

    keys, pays = gen_rhs_table(n_build, chunk_factor)
    return keys, pays, gen_probe_table(n_probe, 2, n_build + n_build // 4)


@pytest.mark.parametrize("n_build, chunk_factor, probe_dom, recomputes", [
    (2048, 3, 40_000, False),  # about 2 % of probes hit: the ladder holds
    (20_000, 2, 20_000, True),  # about half hit: stage 1 overflows
])
def test_lp_ladder_on_card(cuda, monkeypatch, n_build, chunk_factor, probe_dom, recomputes):
    """At n >= 2^16 the LP drain takes the compacted ladder on the card:
    the hash and the compaction launch, the ladder's own answer is kept
    when its stages hold (no full-width recompute) and replaced when one
    overflows, and the stats equal the CPU's."""
    from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table
    from ccve_tpu_torch.exec import bulk
    from ccve_tpu_torch.kernels import murmur
    from ccve_tpu_torch.ops import hash_table as ht

    keys, pays = gen_rhs_table(n_build, chunk_factor)
    col = gen_probe_table(70_000, 1, probe_dom)[:, 0]
    inner = bulk.lp_match_stats
    full_width_calls = []

    def spy(tbl, k, compact_lanes=None, **route):
        full_width_calls.append(compact_lanes)
        return inner(tbl, k, compact_lanes, **route)

    monkeypatch.setattr(bulk, "lp_match_stats", spy)
    before = (murmur.murmurhash64_i64.launches, compact.compact_i32.launches)
    got = inner(ht.build_lp(keys, pays, device=cuda), _i64(col, cuda))
    after = (murmur.murmurhash64_i64.launches, compact.compact_i32.launches)
    assert after[1] - before[1] == 3, (before, after)  # 70,000 -> 35,000 -> 17,500 -> 16,384
    assert after[0] - before[0] == (2 if recomputes else 1), (before, after)
    assert full_width_calls == ([False] if recomputes else [])
    want = inner(ht.build_lp(keys, pays, device="cpu"), torch.from_numpy(col))
    assert torch.equal(got.mult.cpu(), want.mult) and torch.equal(got.psum.cpu(), want.psum)
    assert int(want.mult.max()) == chunk_factor


@pytest.mark.parametrize("kinds", [("lp",), ("csr",), ("lp", "csr"), ("sorted", "lp")])
def test_hash_bulk_count_on_card_matches_cpu(cuda, kinds):
    from ccve_tpu_torch.exec import bulk
    from ccve_tpu_torch.ops import hash_table as ht

    builders = {"lp": ht.build_lp, "csr": ht.build_csr, "sorted": sm.build_sorted}
    keys, pays, probe = _hash_data(30_000, 3, 200_000)
    probe = probe[:, : len(kinds)]
    got = bulk.bulk_count([builders[k](keys, pays, device=cuda) for k in kinds], probe)
    want = bulk.bulk_count([builders[k](keys, pays, device="cpu") for k in kinds], probe)
    assert int(got.count) == int(want.count) > 0
    assert torch.equal(got.payload_checksums.cpu(), want.payload_checksums)


@pytest.mark.parametrize("kind", ["lp", "csr"])
def test_hash_bulk_materialize_on_card_matches_cpu(cuda, kind):
    from ccve_tpu_torch.config import PayloadMode
    from ccve_tpu_torch.exec import bulk
    from ccve_tpu_torch.ops import hash_table as ht

    build = ht.build_lp if kind == "lp" else ht.build_csr
    keys, pays, probe = _hash_data(5_000, 3, 20_000)
    before = compact.compact_i32.launches
    got = bulk.bulk_materialize([build(keys, pays, device=cuda)] * 2, probe, PayloadMode.FULL)
    assert compact.compact_i32.launches > before
    want = bulk.bulk_materialize([build(keys, pays, device="cpu")] * 2, probe, PayloadMode.FULL)
    assert torch.equal(got.cpu(), want)  # the compaction keeps the grid's order


# ---- the expansion's candidates (csrc/candidates.cu) ------------------------


def _candidates_same(got, want):
    """The kernel's candidates against the plain version's, exactly: the
    mask and the total, and the planes on the valid slots (the contract:
    elsewhere the payload plane is the kernel's 0)."""
    planes, valid, total = got
    assert planes.shape == want[0].shape and planes.dtype == torch.int32
    assert valid.dtype == torch.bool and torch.equal(valid, want[1])
    assert torch.equal(planes[:, valid], want[0][:, valid])
    assert total.dtype == torch.int64 and int(total) == int(want[2])


@pytest.mark.parametrize("kind", CANDIDATE_KINDS)
def test_expand_candidates_kernel(cuda, kind):
    s, v, fan_out = candidates_case(np.random.default_rng(26), kind)
    s, v = _i32(s, cuda), _i32(v, cuda)
    before = merge_scan.expand_candidates_i32.launches
    got = merge_scan.expand_candidates_i32(s, v, fan_out)
    assert merge_scan.expand_candidates_i32.launches == before + (s.numel() > 0)
    _candidates_same(got, merge_scan.expand_candidates_plain(s, v, fan_out))


def test_expand_candidates_at_the_cells_shape(cuda):
    """Config 1's merged stream (1M unique build keys, 16M probes in
    [0, 1M]: L = 17,000,000, F = 1), twenty calls: the look-back across
    blocks that run at once."""
    g = torch.Generator(device=cuda).manual_seed(7)
    m, n = 1_000_000, 16_000_000
    s = torch.cat([torch.randperm(m, device=cuda, generator=g) * 2,
                   torch.randint(0, m + 1, (n,), device=cuda, generator=g) * 2 + 1])
    v = torch.cat([torch.randint(-(2**31), 2**31, (m,), device=cuda, generator=g),
                   torch.randperm(n, device=cuda, generator=g)])
    s, order = s.to(torch.int32).sort(stable=True)
    v = v[order].to(torch.int32)
    want = merge_scan.expand_candidates_plain(s, v, 1)
    assert int(want[2]) > 15_000_000
    for _ in range(20):
        _candidates_same(merge_scan.expand_candidates_i32(s, v, 1), want)


@pytest.mark.parametrize("dup", [1, 4])
def test_materialize_launches_the_candidates_a_level(cuda, dup):
    """`bulk_materialize` over two levels launches the kernel once a level
    and gives the CPU's rows as a multiset; `sorted_expand` gives the
    all-plain route's output bit for bit."""
    from ccve_tpu_torch.config import PayloadMode
    from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table
    from ccve_tpu_torch.exec import bulk

    keys, pays = gen_rhs_table(20_000, dup)
    probe = gen_probe_table(100_000, 2, 20_000)
    table = sm.build_sorted(keys, pays, cuda)
    assert table.max_mult == dup
    before = merge_scan.expand_candidates_i32.launches
    got = bulk.bulk_materialize([table] * 2, probe, PayloadMode.FULL)
    assert merge_scan.expand_candidates_i32.launches == before + 2
    want = bulk.bulk_materialize([sm.build_sorted(keys, pays, device="cpu")] * 2, probe,
                                 PayloadMode.FULL)
    got, want = got.cpu().numpy(), want.numpy()
    assert got.shape == want.shape and got.shape[0] > 0
    assert np.array_equal(got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])])
    col = torch.from_numpy(probe[:, 0]).to(cuda)
    cap = col.numel() * dup
    for g, w in zip(sm.sorted_expand(table, col, cap), sm.sorted_expand(table, col, cap,
                                                                         route=sm.PLAIN)):
        assert torch.equal(g, w)


# ---- the sorted-chunk executor (slice 7): kernel #10 ------------------------


def _drain_inputs(rng, S, L, block, fanouts, thresholds, device, occupancy=False):
    """int32 inputs of `drain_segment`: mults in [0, fanout] (the last
    level's up to 5), counts with empty, partial and full chunks, caches
    with a random live prefix (with `occupancy`, L cache counts: the last
    level's count-only cache)."""
    highs = list(fanouts[:-1]) + [5]
    mults = np.stack([rng.integers(0, h + 1, (S, block)) for h in highs], axis=1)
    counts = rng.choice([0, block, int(rng.integers(1, block))], S)
    CL = max(L - 1, 1)
    cache_m = rng.integers(0, max(highs) + 1, (CL, L, block))
    if occupancy:
        cache_cnt = rng.integers(0, block, L)
    else:
        cache_cnt = rng.integers(0, block, CL) if L > 1 else np.zeros(1, np.int64)
    return [_i32(a, device) for a in (mults, counts, thresholds, cache_m, cache_cnt)]


def _same_drain(got, want, L):
    total, cache, ccnt, work, rows = got[:5]
    assert int(total) == int(want[0])
    for g, w in zip((ccnt, work, rows) + tuple(got[5:]), tuple(want[2:])):
        assert torch.equal(g.cpu(), w.cpu())
    for level in range(L - 1):
        live = int(ccnt[level])
        assert torch.equal(cache[level, level + 1 :, :live].cpu(),
                           want[1][level, level + 1 :, :live].cpu()), level


@pytest.mark.parametrize("seed", range(16))
def test_drain_kernel(cuda, seed):
    """#10 against its plain version on the card and on the CPU, at random
    (L, block, fanouts, thresholds), S up to 40 chunks."""
    from ccve_tpu_torch.kernels import drain

    rng = np.random.default_rng(seed)
    L = int(rng.integers(1, 6))
    block = int(rng.choice([128, 384, 1024, 2048] + ([4096] if L <= 4 else [])))
    fanouts = tuple(int(f) for f in rng.integers(1, 4, L))
    while np.prod(fanouts[:-1]) > drain.MAX_PATHS:
        fanouts = tuple(max(f - 1, 1) for f in fanouts)
    thresholds = [int(rng.choice([0, block // 2, block, int(rng.integers(1, block))]))
                  for _ in range(L)]
    S = int(rng.integers(0, 41))
    args = _drain_inputs(rng, S, L, block, fanouts, thresholds, cuda)
    before = drain.drain_segment.launches
    got = drain.drain_segment(*args, block=block, fanouts=fanouts)
    assert drain.drain_segment.launches == before + 1
    _same_drain(got, drain.drain_segment_plain(*args, block=block, fanouts=fanouts), L)
    cpu = drain.drain_segment(*(a.cpu() for a in args), block=block, fanouts=fanouts)
    _same_drain(got, cpu, L)


@pytest.mark.parametrize("seed", range(12))
def test_drain_occupancy_kernel(cuda, seed):
    """#10's occupancy variant against its plain version: histograms,
    total, cache counts, work, rows and caches, branchy on and off."""
    from ccve_tpu_torch.kernels import drain

    rng = np.random.default_rng(100 + seed)
    L = int(rng.integers(1, 6))
    block = int(rng.choice([128, 384, 1024, 2048]))
    fanouts = tuple(int(f) for f in rng.integers(1, 4, L))
    while np.prod(fanouts[:-1]) > drain.MAX_PATHS:
        fanouts = tuple(max(f - 1, 1) for f in fanouts)
    thresholds = [int(rng.choice([0, block // 2, block, int(rng.integers(1, block))]))
                  for _ in range(L)]
    args = _drain_inputs(rng, int(rng.integers(0, 41)), L, block, fanouts, thresholds, cuda,
                         occupancy=True)
    kw = dict(block=block, fanouts=fanouts, record_occupancy=True, branchy=bool(seed % 2))
    before = (drain.drain_segment.launches, drain.occupancy_variant.launches)
    got = drain.drain_segment(*args, **kw)
    assert (drain.drain_segment.launches, drain.occupancy_variant.launches) == \
        (before[0], before[1] + 1)
    _same_drain(got, drain.drain_segment_plain(*args, **kw), L)


def test_drain_kernel_refuses_what_does_not_fit(cuda):
    """The shapes the kernel refused before its repair (more than 8
    levels, blocks over 4096, caches past shared memory) run, with and
    without the histograms, and equal the plain version; more than 64 drain
    paths still raise, before any launch."""
    from ccve_tpu_torch.kernels import drain

    rng = np.random.default_rng(7)
    for L, block, fanouts in ((6, 2048, (1, 2, 1, 1, 2, 1)), (5, 4096, (1,) * 5),
                              (9, 2048, (1,) * 9), (2, 8192, (2, 1))):
        thresholds = [int(rng.choice([0, block // 2, block])) for _ in range(L)]
        for occupancy in (False, True):
            args = _drain_inputs(rng, 12, L, block, fanouts, thresholds, cuda,
                                 occupancy=occupancy)
            kw = dict(block=block, fanouts=fanouts, record_occupancy=occupancy)
            _same_drain(drain.drain_segment(*args, **kw), drain.drain_segment_plain(*args, **kw),
                        L)
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=cuda)  # noqa: E731
    before = drain.drain_segment.launches
    with pytest.raises(ValueError, match="drain paths"):
        drain.drain_segment(z(2, 3, 128), z(2), z(3), z(2, 3, 128), z(2), block=128,
                            fanouts=(8, 9, 1))
    assert drain.drain_segment.launches == before


DRAIN_EDGES = [
    # (S, block, fanouts): no chunk; one level; blocks that are no multiple
    # of 32; phase 28's shapes; 64 paths of 8192 lanes over 40 chunks, which
    # the kernel walks in windows of 16
    (0, 128, (1, 2, 1)),
    (7, 100, (3,)),
    (9, 100, (2, 1, 3)),
    (8, 2048, (1, 2, 1, 1, 2, 1)),
    (8, 4096, (1,) * 5),
    (8, 2048, (1,) * 9),
    (8, 8192, (2, 1)),
    (40, 8192, (2,) * 6 + (1,)),
]


@pytest.mark.parametrize("case", range(len(DRAIN_EDGES)))
@pytest.mark.parametrize("occupancy", [False, True])
def test_drain_kernel_edge_shapes(cuda, case, occupancy):
    """#10 and its variant at the edges of the level-by-level design, with
    incoming caches, against the plain version: one launch a call, on a
    grid of more than one block."""
    from ccve_tpu_torch.kernels import drain

    S, block, fanouts = DRAIN_EDGES[case]
    L = len(fanouts)
    rng = np.random.default_rng(40 + case)
    thresholds = [int(rng.choice([0, block // 2, block, block + 1])) for _ in range(L)]
    args = _drain_inputs(rng, S, L, block, fanouts, thresholds, cuda, occupancy=occupancy)
    kw = dict(block=block, fanouts=fanouts, record_occupancy=occupancy, branchy=case % 2 == 0)
    counter = drain.occupancy_variant if occupancy else drain.drain_segment
    before = counter.launches
    got = drain.drain_segment(*args, **kw)
    assert counter.launches == before + 1
    _same_drain(got, drain.drain_segment_plain(*args, **kw), L)
    assert drain.grid(S, fanouts, occupancy) > 1


@pytest.mark.parametrize("m, dom, n", [(0, 50, 128), (1, 3, 2048), (500, 400, 256),
                                       (50_000, 100_000, 2048), (4000, 100, 4096),
                                       (1 << 20, 1 << 40, 2048)])
def test_chunk_rank_kernel(cuda, m, dom, n):
    """#11 against its plain version: mult everywhere, start where mult > 0
    (and, as the kernel defines it, the lower bound everywhere)."""
    from ccve_tpu_torch.kernels import chunk_probe

    rng = np.random.default_rng(m + n)
    table = np.sort(rng.integers(-dom, dom, m, dtype=np.int64))
    keys = rng.integers(-dom - 3, dom + 3, n, dtype=np.int64)
    if m:
        keys[: n // 2] = table[rng.integers(0, m, n // 2)]
    valid = rng.random(n) < 0.9
    args = [torch.from_numpy(a).to(cuda) for a in (table, keys, valid)]
    before = chunk_probe.chunk_rank.launches
    mult, start = chunk_probe.chunk_rank(*args)
    assert chunk_probe.chunk_rank.launches == before + 1
    want_mult, want_start = chunk_probe.chunk_rank_plain(*args)
    assert torch.equal(mult, want_mult) and torch.equal(start, want_start)


def test_chunk_rank_kernel_edges(cuda):
    """#11 against its plain version on every case of
    `bench.edge_cases.chunk_rank_cases` (tables of stride·k ± 1 rows, the
    index's sampled keys, runs across leaf boundaries, a hot key of 12,000
    rows, the int64 extremes, m = 0 and 1, m = 2^21 and 2^24): mult and
    start everywhere, exactly."""
    from ccve_tpu_torch.bench.edge_cases import chunk_rank_cases
    from ccve_tpu_torch.kernels import chunk_probe

    for what, table, keys, valid in chunk_rank_cases(np.random.default_rng(30)):
        args = [torch.from_numpy(a).to(cuda) for a in (table, keys, valid)]
        mult, start = chunk_probe.chunk_rank(*args)
        want_mult, want_start = chunk_probe.chunk_rank_plain(*args)
        assert torch.equal(mult, want_mult) and torch.equal(start, want_start), what


def test_chunk_rank_kernel_allocates_once(cuda):
    """One call of #11 makes one device allocation: mult and start are the
    rows of one int32[2, n]."""
    from ccve_tpu_torch.kernels import chunk_probe

    table = torch.arange(0, 100_000, 2, dtype=torch.int64, device=cuda)
    keys = torch.arange(2048, dtype=torch.int64, device=cuda) * 3
    valid = torch.ones(2048, dtype=torch.bool, device=cuda)
    chunk_probe.chunk_rank(table, keys, valid)
    before = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    mult, start = chunk_probe.chunk_rank(table, keys, valid)
    assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] == before + 1
    assert mult.untyped_storage().data_ptr() == start.untyped_storage().data_ptr()
    assert torch.equal(mult, (keys % 2 == 0).int()) and torch.equal(start, ((keys + 1) // 2).int())


def _sorted_setup(device, strategy, n_joins=3, lhs=20_000, rhs=3000, chunk_factor=2,
                  block=256, collect=False):
    from ccve_tpu_torch.config import CompactionStrategy, EngineConfig
    from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table
    from ccve_tpu_torch.exec.oracle import OracleBuildTable, oracle_pipeline

    keys, pays = gen_rhs_table(rhs, chunk_factor)
    probe = gen_probe_table(lhs, n_joins, rhs + rhs // 3)
    cfg = EngineConfig(block_size=block, n_joins=n_joins, lhs_size=lhs, rhs_size=rhs,
                       chunk_factor=chunk_factor, strategy=CompactionStrategy(strategy),
                       collect_tuples=collect)
    want = oracle_pipeline(probe, [OracleBuildTable(keys, pays)] * n_joins).shape[0]
    return cfg, probe, sm.build_sorted(keys, pays, device=device), want


@pytest.mark.parametrize("strategy", ["no_compaction", "full_compaction", "binary_compaction"])
@pytest.mark.parametrize("preload", [False, True])
def test_sorted_pipeline_on_card_matches_cpu(cuda, strategy, preload):
    """Count-only SortedPipeline on the card launches #10 (once a segment)
    and the stats kernels, and counts what the CPU and the oracle count;
    so does the torch drain route."""
    from ccve_tpu_torch.exec.sorted_pipeline import SortedPipeline
    from ccve_tpu_torch.kernels import drain

    cfg, probe, table, want = _sorted_setup(cuda, strategy)
    pipe = SortedPipeline([table] * cfg.n_joins, cfg)
    assert pipe._fused_drain_ok
    before = (drain.drain_segment.launches, merge_scan.merge_stats_i32.launches)
    got = pipe.run(probe, segment_chunks=None if preload else 16, preload=preload)
    after = (drain.drain_segment.launches, merge_scan.merge_stats_i32.launches)
    n_chunks = -(-probe.shape[0] // cfg.block_size)
    assert after[0] - before[0] == (1 if preload else -(-n_chunks // 16))
    assert after[1] > before[1]
    cpu_table = sm.build_sorted(table.keys.cpu().numpy(), table.payloads.cpu().numpy(),
                                device="cpu")
    cpu = SortedPipeline([cpu_table] * cfg.n_joins, cfg).run(probe, preload=preload)
    torch_drain = SortedPipeline([table] * cfg.n_joins, cfg, use_kernel=False).run(probe)
    assert got["count"] == cpu["count"] == torch_drain["count"] == want > 0


def test_sorted_pipeline_full_flush_on_card(cuda):
    """FULL on the card: the caches the kernel leaves (mult planes written
    back as rank columns) equal the CPU twin's on their live prefix, and
    the flush through the torch drain counts what the oracle counts."""
    from ccve_tpu_torch.exec.sorted_pipeline import SortedPipeline

    cfg, probe, table, want = _sorted_setup(cuda, "full_compaction", n_joins=4, lhs=9000)
    cpu_table = sm.build_sorted(table.keys.cpu().numpy(), table.payloads.cpu().numpy(),
                                device="cpu")
    states = {}
    for name, tbl in (("card", table), ("cpu", cpu_table)):
        pipe = SortedPipeline([tbl] * cfg.n_joins, cfg)
        n_chunks = -(-probe.shape[0] // cfg.block_size)
        cols = np.zeros((n_chunks * cfg.block_size, cfg.n_joins), np.int64)
        cols[: probe.shape[0]] = probe
        chunk_cols = torch.from_numpy(np.ascontiguousarray(
            cols.reshape(n_chunks, cfg.block_size, cfg.n_joins).transpose(0, 2, 1)))
        counts = torch.full((n_chunks,), cfg.block_size, dtype=torch.int32)
        counts[-1] -= n_chunks * cfg.block_size - probe.shape[0]
        ps = pipe._process_chunks(pipe.fresh_state(), chunk_cols.to(tbl.device),
                                  counts.to(tbl.device), pipe.static_thresholds())
        states[name] = (ps, pipe)
    card, cpu = states["card"][0], states["cpu"][0]
    assert int(card.result_count) == int(cpu.result_count)
    assert torch.equal(card.cache_count.cpu(), cpu.cache_count)
    assert int(cpu.cache_count[:-1].sum()) > 0  # the flush has rows to move
    c0 = states["card"][1]._rank_col0
    for level in range(cfg.n_joins - 1):
        live = int(cpu.cache_count[level])
        got = card.cache_cols[level, c0 + level + 1 :, :live].cpu()
        assert torch.equal(got, cpu.cache_cols[level, c0 + level + 1 :, :live])
    pipe = states["card"][1]
    flushed = pipe._flush_all(card, pipe.static_thresholds())
    assert int(flushed.result_count) == want


def test_device_tuner_on_card_matches_cpu(cuda):
    """A device-tuner run (DYNAMIC, preloaded and streamed, with the
    histograms) on the card equals the same run on the CPU: count, bandit
    state, greedy thresholds and occupancy; the chunk rank mode launches
    #11 and counts the same."""
    import dataclasses

    from ccve_tpu_torch.config import CompactionStrategy
    from ccve_tpu_torch.exec.sorted_pipeline import SortedPipeline
    from ccve_tpu_torch.kernels import chunk_probe, drain

    cfg, probe, table, want = _sorted_setup(cuda, "full_compaction", n_joins=3, lhs=30_000)
    cfg = dataclasses.replace(cfg, strategy=CompactionStrategy.DYNAMIC, device_tuner=True,
                              record_occupancy=True, tuner_segment_chunks=4,
                              threshold_arms=(0, cfg.block_size // 2, cfg.block_size))
    cpu_table = sm.build_sorted(table.keys.cpu().numpy(), table.payloads.cpu().numpy(),
                                device="cpu")
    for preload in (True, False):
        before = drain.occupancy_variant.launches
        got = SortedPipeline([table] * 3, cfg).run(probe, preload=preload)
        assert drain.occupancy_variant.launches > before
        ref = SortedPipeline([cpu_table] * 3, cfg).run(probe, preload=preload)
        assert got["count"] == ref["count"] == want
        np.testing.assert_allclose(got["bandit_est"], ref["bandit_est"], rtol=1e-6)
        for key in ("bandit_n_sel", "bandit_committed", "bandit_commit_t",
                    "greedy_thresholds", "occupancy"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    static = dataclasses.replace(cfg, strategy=CompactionStrategy.FULL, device_tuner=False)
    before = chunk_probe.chunk_rank.launches
    chunk = SortedPipeline([table] * 3, static, rank_mode="chunk").run(probe)
    assert chunk_probe.chunk_rank.launches > before and chunk["count"] == want


# ---- slice 3b: #15's generic entry, #16, #4 and #5 ------------------------

I64_MIN = -(2**63)


def _generic_stream(rng, m, n, pay_lo, pay_hi, device):
    """(sk, st) of the generic totals over the whole int64 range: build ∪
    probe keys stably sorted (builds first at equal keys), with tagged
    payloads (pay * 2 + 1 builds, 0 probes)."""
    bk = rng.integers(I64_MIN, I64_MAX, m, dtype=np.int64, endpoint=True)
    bk[: min(m, 2)] = [I64_MIN, I64_MAX][: min(m, 2)]
    pk = np.concatenate([rng.choice(bk, n // 2) if m else np.zeros(n // 2, np.int64),
                         rng.integers(I64_MIN, I64_MAX, n - n // 2, dtype=np.int64)])
    keys = np.concatenate([bk, pk])
    st = np.concatenate([rng.integers(pay_lo, pay_hi, m) * 2 + 1, np.zeros(n, np.int64)])
    order = np.argsort(keys, kind="stable")
    return _i64(keys[order], device), _i64(st[order], device)


@pytest.mark.parametrize(
    "m, n, pay_lo, pay_hi",
    [(0, 5000, 0, 1), (7000, 0, 0, 9), (1, 1, 0, 9), (30_000, 90_000, 0, 2**30),
     (50_000, 20_000, -(2**40), 2**40), (2000, 400_000, -5, 5)],
)
def test_merge_scan_stats_kernel(cuda, m, n, pay_lo, pay_hi):
    rng = np.random.default_rng(m + n)
    sk, st = _generic_stream(rng, m, n, pay_lo, pay_hi, cuda)
    got = merge_scan.merge_scan_stats(sk, st)
    want = merge_scan.merge_scan_stats_plain(sk, st)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # runs of one extreme key straddling the 2048-element blocks
    sk = _i64(np.repeat([I64_MIN, 0, I64_MAX], [3000, 5000, 4000]), cuda)
    st = _i64(np.where(np.arange(12_000) % 7 == 0, 11, 0), cuda)
    got = merge_scan.merge_scan_stats(sk, st)
    want = merge_scan.merge_scan_stats_plain(sk, st)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("pay_bits", [2, 25, 31])
def test_merge_scan_stats_packed_kernel(cuda, pay_bits):
    rng = np.random.default_rng(pay_bits)
    m, n = 40_000, 200_000
    bk, pk = rng.integers(0, 50_000, m), rng.integers(0, 50_100, n)
    pays = rng.integers(0, 2 ** (pay_bits - 1), m)
    s = np.concatenate([(bk << pay_bits) | (pays << 1), (pk << pay_bits) | ((1 << pay_bits) - 1)])
    s = _i64(np.sort(s), cuda)
    got = merge_scan.merge_scan_stats_packed(s, pay_bits)
    want = merge_scan.merge_scan_stats_packed_plain(s, pay_bits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize(
    "m, n, dom, phantoms",
    [(0, 10, 5, 0), (10, 0, 5, 3), (30_000, 100_000, 20_000, 0),
     (200_000, 50_000, 2**29, 5000), (5, 300_000, 2, 10)],
)
def test_merge_scan_build_counts_kernel(cuda, m, n, dom, phantoms):
    rng = np.random.default_rng(m + n)
    s = np.concatenate([np.sort(rng.integers(0, dom, m)) * 2 + 1,
                        rng.integers(0, dom + 4, n) * 2, np.full(phantoms, 2**31 - 1)])
    s = _i32(np.sort(s), cuda)
    # the last m has more ranks than the stream has builds: they stay 0
    for mm in (m, m + phantoms // 2, m + phantoms + 3000):
        got = merge_scan.merge_scan_build_counts(s, mm, extra=phantoms)
        assert torch.equal(got, merge_scan.merge_scan_build_counts_plain(s, mm, phantoms))


def test_merge_scan_build_counts_kernel_edges(cuda):
    """#4 against its plain version on every case of
    `bench.edge_cases.dense_counts_cases` (lengths at the tile multiple and
    one off, builds only, probes only, a 100K-probe hot key, phantoms, m
    below and past the builds, L = 1 and 0, more tiles than the grid),
    each into memory the caching allocator last filled with garbage (the
    kernel writes every rank: bc has no memset), and from a view 4 bytes
    past a 16-byte boundary (the kernel's scalar loads)."""
    from ccve_tpu_torch.bench.edge_cases import dense_counts_cases

    for what, s, m in dense_counts_cases(np.random.default_rng(37)):
        s_dev = _i32(s, cuda)
        for view, x in (("", s_dev), (" from element 1", s_dev[1:])):
            torch.full((m + 4096,), -7, dtype=torch.int32, device=cuda)  # freed at once
            got = merge_scan.merge_scan_build_counts(x, m)
            assert torch.equal(got, merge_scan.merge_scan_build_counts_plain(x, m)), what + view


@pytest.mark.parametrize("na, nb", [(1, 1), (0, 9), (9, 0), (1, 100_000), (100_000, 1),
                                    (100_000, 100_000), (4097, 123_457)])
def test_merge_sorted_i32_kernel(cuda, na, nb):
    rng = np.random.default_rng(na * 3 + nb)
    for lo, hi in ((-(2**31), 2**31), (0, 5)):
        a = _i32(np.sort(rng.integers(lo, hi, na)), cuda)
        b = _i32(np.sort(rng.integers(lo, hi, nb)), cuda)
        assert torch.equal(bigsort.merge_sorted_i32(a, b), bigsort.merge_sorted_i32_plain(a, b))


def test_slice_3b_reaches_the_kernels(cuda):
    """On CUDA tensors the full-range totals launch #15's generic entry
    once, and the small-probe route #5 and #4 once each; both agree with
    the CPU's plain versions."""
    rng = np.random.default_rng(4)
    keys = rng.integers(I64_MIN, I64_MAX, 50_000, dtype=np.int64)
    keys[:2] = [I64_MIN, I64_MAX]
    pays = rng.integers(0, 2**30, keys.size)
    probe = np.concatenate([rng.choice(keys, 100_000), rng.integers(I64_MIN, I64_MAX, 100_000)])
    before = merge_scan.merge_scan_stats.launches
    got = sm.sorted_match_totals(sm.build_sorted(keys, pays), _i64(probe, cuda))
    assert merge_scan.merge_scan_stats.launches == before + 1
    want = sm.sorted_match_totals(sm.build_sorted(keys, pays, device="cpu"), probe)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))

    keys, pays = rng.integers(0, 100_000, 60_000), rng.integers(0, 2**30, 60_000)
    probe = rng.integers(0, 100_000, 8192).astype(np.int32)
    before = (bigsort.merge_sorted_i32.launches, merge_scan.merge_scan_build_counts.launches)
    got = sm.sorted_match_totals(sm.build_sorted(keys, pays), _i32(probe, cuda))
    after = (bigsort.merge_sorted_i32.launches, merge_scan.merge_scan_build_counts.launches)
    assert after == (before[0] + 1, before[1] + 1)
    want = sm.sorted_match_totals(sm.build_sorted(keys, pays, device="cpu"), probe)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))


@pytest.mark.parametrize("n_tiles", [1, 3, 64, 1 << 11])
@pytest.mark.parametrize("n_stages", [0, 1, 2, 3, 7, 16, 64])
def test_ce_stages_kernel(cuda, n_tiles, n_stages):
    from ccve_tpu_torch.kernels.ce_stages import TILE_LOG, ce_stages_i32, ce_stages_plain

    rng = np.random.default_rng(n_tiles * 100 + n_stages)
    x = _i32(rng.integers(-(2**31), 2**31 - 1, n_tiles << TILE_LOG), cuda)
    before = ce_stages_i32.launches
    got = ce_stages_i32(x, n_stages)
    assert ce_stages_i32.launches == before + 1
    assert torch.equal(got, ce_stages_plain(x, n_stages))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_ce_stages_kernel_on_a_view_not_16_byte_aligned(cuda, offset):
    """A contiguous view that starts 4, 8 or 12 bytes into its storage: the
    kernel's copies then move a key a thread (the stages are the same)."""
    from ccve_tpu_torch.kernels.ce_stages import TILE_LOG, ce_stages_i32, ce_stages_plain

    rng = np.random.default_rng(offset)
    x = _i32(rng.integers(-(2**31), 2**31 - 1, (3 << TILE_LOG) + 8), cuda)[offset:]
    x = x[:3 << TILE_LOG]
    for n_stages in (0, 3, 16):
        assert torch.equal(ce_stages_i32(x, n_stages), ce_stages_plain(x, n_stages))


def test_ce_stages_kernel_refuses_a_ragged_length(cuda):
    from ccve_tpu_torch.kernels.ce_stages import ce_stages_i32

    with pytest.raises(ValueError, match="multiple"):
        ce_stages_i32(torch.zeros(8191, dtype=torch.int32, device=cuda), 3)


def test_smem_rate_on_card(cuda):
    """The card's SMs and largest SM clock, as #17's floor reads them."""
    from ccve_tpu_torch.bench.roofline import smem_floor_ms, smem_rate

    sms, clock_hz = smem_rate()
    assert sms == torch.cuda.get_device_properties(0).multi_processor_count
    assert 5e8 < clock_hz < 5e9
    assert smem_floor_ms(1 << 24, 16, sms, clock_hz) > 0


def test_measure_anchors_on_card(cuda):
    """Both anchors measured on the card through the kernel (it launches
    2 x (1 + ANCHOR_REPEATS) x niter times)."""
    from ccve_tpu_torch.bench.roofline import ANCHOR_REPEATS, measure_anchors
    from ccve_tpu_torch.kernels.ce_stages import ce_stages_i32

    before = ce_stages_i32.launches
    text = measure_anchors(n=1 << 20, niter=2)
    assert ce_stages_i32.launches == before + 2 * (1 + ANCHOR_REPEATS) * 2
    assert "CUDA events" in text
    assert " A. CE-stage kernel K-slope" in text and " B. library sort" in text


def test_data_collection_round_trip_on_card(cuda):
    from ccve_tpu_torch.core import chunk as chunklib
    from ccve_tpu_torch.core.collection import DataCollection

    rng = np.random.default_rng(5)
    cols = rng.integers(-(2**62), 2**62, (3, 5000))
    dc, out = DataCollection.from_columns(cols), DataCollection(3, 16)
    for start in range(0, 5000, 2048):
        chunk = dc.fetch_chunk(start, min(start + 2048, 5000), 2048)
        assert chunk.cols.device.type == "cuda"
        out.append_chunk(chunk)
    assert np.array_equal(out.columns(), cols)
    chunk = dc.fetch_chunk(0, 100, 128)
    picked = torch.zeros(128, dtype=torch.int32, device=cuda)
    picked[:34] = torch.arange(0, 100, 3, dtype=torch.int32, device=cuda)
    out.append_chunk(chunklib.slice_compose(chunk, picked, 34))
    assert np.array_equal(out.rows()[5000:], cols[:, 0:100:3].T)


# ---- #6 and #7 redesigned: register sort and merge-path rounds; partition,
# staged merge and the ladder in one host call ------------------------------

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
EDGE_KEYS = ["random", "all equal", "extremes"]


def _edge_keys(rng, n, dtype, kind):
    """Keys of `kind`: uniform over the type, all one value (with arange
    planes this checks stability), or heavy at the type's minimum and
    maximum (the maximum is also the padding)."""
    lo, hi = (I32_MIN, I32_MAX) if dtype == torch.int32 else (I64_MIN, I64_MAX)
    if kind == "all equal":
        keys = np.full(n, 7)
    else:
        keys = rng.integers(lo, hi, n, dtype=np.int64, endpoint=True)
        if kind == "extremes":
            keys[rng.random(n) < 0.3] = hi
            keys[rng.random(n) < 0.3] = lo
    return torch.from_numpy(keys).to(dtype)


def _edge_planes(rng, n, count, kind, device):
    if kind == "all equal":
        return [torch.arange(n, dtype=torch.int32, device=device) * (p + 1)
                for p in range(count)]
    return _planes(rng, n, count, device)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("tile_log", list(range(1, pairsort.MAX_TILE_LOG + 1)))
@pytest.mark.parametrize("kind", EDGE_KEYS)
def test_sort_tiles_multi_edges(cuda, dtype, tile_log, kind):
    """Every tile size, from tiles smaller than one thread's 16 elements
    (padded in registers) to 2^13; 0, 1 and 3 tiles; P = 1..3."""
    sort_tiles = pairsort._MULTI_WRAPPERS[dtype][0]
    rng = np.random.default_rng(tile_log)
    for n_tiles, n_planes in ((0, 1), (1, 2), (3, 3)):
        n = n_tiles << tile_log
        keys = _edge_keys(rng, n, dtype, kind).to(cuda)
        vals = _edge_planes(rng, n, n_planes, kind, cuda)
        _same(sort_tiles(keys, vals, tile_log),
              pairsort.sort_tiles_multi_plain(keys, vals, tile_log))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 8191, 8193, 3 * 8192 + 5])
@pytest.mark.parametrize("kind", EDGE_KEYS)
def test_merge_level_multi_edges(cuda, dtype, n, kind):
    """run_log 0..20 (tiles of min(4096, 2L) outputs, the ragged last pair,
    an empty B), inputs 4 bytes past an aligned address, P = 1..3."""
    merge_level = pairsort._MULTI_WRAPPERS[dtype][1]
    rng = np.random.default_rng(n)
    n_planes = 1 + n % 3
    keys = _edge_keys(rng, n + 1, dtype, kind).to(cuda)[1:]  # a misaligned view
    vals = [v[1:] for v in _edge_planes(rng, n + 1, n_planes, kind, cuda)]
    for run_log in range(21):
        got = merge_level(keys, vals, run_log)
        keys, vals = pairsort.merge_level_multi_plain(keys, vals, run_log)
        _same(got, (keys, vals))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("na, nb", [(0, 0), (0, 1), (1, 0), (1, 1), (4095, 1), (4096, 0),
                                    (1, 4096), (2048, 2049), (70_001, 3), (5, 90_000)])
@pytest.mark.parametrize("kind", EDGE_KEYS)
def test_merge_two_multi_edges(cuda, dtype, na, nb, kind):
    merge_two = {torch.int32: pairsort.merge_two_multi_i32,
                 torch.int64: pairsort.merge_two_multi_i64}[dtype]
    rng = np.random.default_rng(na * 7 + nb)
    n_planes = 1 + (na + nb) % 3
    ak = _edge_keys(rng, na + 1, dtype, kind).to(cuda)[1:].sort().values
    bk = _edge_keys(rng, nb, dtype, kind).to(cuda).sort().values
    avs = [v[1:] for v in _edge_planes(rng, na + 1, n_planes, kind, cuda)]
    bvs = _edge_planes(rng, nb, n_planes, kind, cuda)
    _same(merge_two(ak, avs, bk, bvs), pairsort.merge_two_multi_plain(ak, avs, bk, bvs))


@pytest.mark.parametrize("na, nb", [(0, 1), (1, 0), (4095, 1), (4096, 4096), (3, 8190)])
@pytest.mark.parametrize("kind", EDGE_KEYS)
def test_merge_sorted_i32_edges(cuda, na, nb, kind):
    """#5, the key-only merge on #7's template, from misaligned views."""
    rng = np.random.default_rng(na + 3 * nb)
    a = _edge_keys(rng, na + 3, torch.int32, kind).to(cuda)[3:].sort().values
    b = _edge_keys(rng, nb + 1, torch.int32, kind).to(cuda)[1:].sort().values
    assert torch.equal(bigsort.merge_sorted_i32(a, b), bigsort.merge_sorted_i32_plain(a, b))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("tile_log, n", [(pairsort.TILE_LOG, 100_000), (pairsort.TILE_LOG, 8192),
                                         (4, 1000), (1, 37), (11, 5 * 2048 + 1)])
def test_sort_ladder_one_call_equals_levels(cuda, dtype, tile_log, n):
    """The ladder's one host call equals the tile sort and the merge levels
    called one by one, at either parity of the level count, and counts one
    launch a level (and a partition a level)."""
    sort_tiles, merge_level = pairsort._MULTI_WRAPPERS[dtype]
    rng = np.random.default_rng(n)
    keys = _edge_keys(rng, n, dtype, "extremes").to(cuda)
    vals = _planes(rng, n, 2, cuda)
    pk, pv = pairsort.pad_to_tile(keys, vals, tile_log)
    n_tiles = pk.numel() >> tile_log
    for run_log in sorted({tile_log, tile_log + 1, tile_log + 3, tile_log + 20}):
        n_levels = min(max(n_tiles - 1, 0).bit_length(), run_log - tile_log)
        want = sort_tiles(pk, pv, tile_log)
        for level in range(n_levels):
            want = merge_level(*want, tile_log + level)
        before = (sort_tiles.launches, merge_level.launches, pairsort.merge_partition.launches)
        if dtype == torch.int32:
            got = pairsort.sort_multi_i32_runs(keys, vals, run_log, tile_log)
        else:
            got = pairsort._sort_runs(keys, vals, run_log, tile_log, pairsort._ladder_kernels,
                                      dtype)
        after = (sort_tiles.launches, merge_level.launches, pairsort.merge_partition.launches)
        assert after == (before[0] + 1, before[1] + n_levels, before[2] + n_levels)
        _same(got, want)
        _same(got, pairsort.sort_multi_runs_plain(keys, vals, run_log, tile_log))
    sort = pairsort.sort_multi_i32 if dtype == torch.int32 else pairsort.sort_multi_i64
    _same(sort(keys, vals, tile_log), pairsort.sort_multi_plain(keys, vals, tile_log))


def test_probe_sort_bad_shapes_raise(cuda):
    k = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="cargo planes"):
        pairsort.sort_multi_i32(k, [k, k, k, k])
    with pytest.raises(ValueError, match="cargo planes"):
        pairsort.merge_level_multi_i32(k, [k] * 4, 3)
    with pytest.raises(ValueError, match="tile_log"):
        pairsort.sort_multi_i32(k, [k], 14)
    with pytest.raises(ValueError, match="run_log"):
        pairsort.merge_level_multi_i32(k, [k], 31)
    with pytest.raises(TypeError):
        pairsort.sort_multi_i32(k.long(), [k])
    with pytest.raises(ValueError, match="multiple"):
        pairsort.sort_tiles_multi_i64(k[:10].long(), [k[:10]], 4)
    # the C entries refuse what the wrappers would not pass, and check raises
    from ccve_tpu_torch.kernels import _build

    lib = _build.load()
    out = torch.empty_like(k)
    code = lib.ccve_sort_multi_i32(k.data_ptr(), k.data_ptr(), None, None, out.data_ptr(),
                                   out.data_ptr(), None, None, out.data_ptr(), out.data_ptr(),
                                   None, None, out.data_ptr(), 4, 64, 4, 1, _build.stream(k))
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(code, "ccve_sort_multi_i32 with 4 planes")


# ---- #15 and #8 (csrc/merge_stats.cu): the single-pass scan, the staged rows

def _row_stream(rng, n, m, dom, pay_lo, pay_hi, dtype, n_rows, device):
    """A row-form stream of `dtype` keys: builds even, probes odd with
    distinct rows in [0, n_rows) but two outside it, and 5 paddings."""
    builds = np.sort(rng.integers(0, dom, m))
    probes = rng.integers(0, dom + 3, n)
    s = np.concatenate([builds * 2, probes * 2 + 1])
    rows = rng.permutation(n_rows)[:n]
    if n > 4:
        rows[:2] = [-7, n_rows + 3]
    v = np.concatenate([rng.integers(pay_lo, pay_hi, m, endpoint=True), rows])
    order = np.argsort(s, kind="stable")
    info = np.iinfo(dtype)
    s = np.concatenate([s[order].astype(dtype), np.full(5, info.max, dtype)])
    v = np.concatenate([v[order], np.arange(5)]).astype(np.int32)
    return (torch.from_numpy(s).to(device), torch.from_numpy(v).to(device))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n, m, dom, n_rows", [
    (3, 1, 2, 3),  # below one tile of 4096
    (4091, 2, 3, 4091),  # one tile and a bit (with the builds and padding)
    (12_345, 0, 50, 20_000),  # all probes, rows no probe names
    (0, 9000, 50, 10),  # all builds
    (200_000, 7, 2, 200_000),  # one key run across dozens of tiles
    (40_000, 40_000, 900, 70_000),  # five buckets of 16384 rows
])
def test_merge_stats_edges(cuda, dtype, n, m, dom, n_rows):
    """The row form against its plain version: lengths off the tile, long
    runs, all builds, all probes, rows outside [0, n), payload extremes."""
    rng = np.random.default_rng(n + m)
    s, v = _row_stream(rng, n, m, dom, -(2**31), 2**31 - 1, dtype, n_rows, cuda)
    wrapper = merge_scan.merge_stats_i32 if dtype == np.int32 else merge_scan.merge_stats_i64
    got = wrapper(s, v, n_rows)
    want = merge_scan.merge_stats_plain(s, v, n_rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_merge_stats_keeps_unnamed_rows(cuda):
    """Through the C entry, rows that no probe names keep what they held."""
    from ccve_tpu_torch.kernels import _build

    rng = np.random.default_rng(5)
    n_rows = 50_000
    s, v = _row_stream(rng, 30_000, 3000, 700, -9, 9, np.int64, n_rows, cuda)
    lib = _build.load()
    scratch = torch.empty(lib.ccve_merge_stats_scratch_bytes(s.numel(), n_rows),
                          dtype=torch.uint8, device=cuda)
    mult = torch.full((n_rows,), -1, dtype=torch.int32, device=cuda)
    psum = torch.full((n_rows,), -1, dtype=torch.int64, device=cuda)
    _build.check(lib.ccve_merge_stats_i64(s.data_ptr(), v.data_ptr(), s.numel(), n_rows,
                                          scratch.data_ptr(), mult.data_ptr(), psum.data_ptr(),
                                          _build.stream(s)), "merge_stats_i64")
    want = merge_scan.merge_stats_plain(s, v, n_rows)
    named = torch.zeros(n_rows, dtype=torch.bool, device=cuda)
    probe = ((s & 1) == 1) & (s != 2**63 - 1) & (v >= 0) & (v < n_rows)
    named[v[probe].long()] = True
    assert torch.equal(mult, torch.where(named, want[0], -1))
    assert torch.equal(psum, torch.where(named, want[1], -1))


def test_merge_stats_again_and_again(cuda):
    """The look-back across blocks that run at once: twenty calls on a
    stream of 300 tiles, each equal to the plain version."""
    rng = np.random.default_rng(11)
    s, v = _row_stream(rng, 1_000_000, 200_000, 50_000, 0, 2**30, np.int64, 1_000_000, cuda)
    want = merge_scan.merge_stats_plain(s, v, 1_000_000)
    for _ in range(20):
        got = merge_scan.merge_stats_i64(s, v, 1_000_000)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_merge_stats_past_the_block_bins(cuda):
    """More than 1024 buckets (n > 2^24 rows): each probe takes its own
    staging slot; equal to the plain version."""
    n = (1 << 24) + 5000
    g = torch.Generator(device=cuda).manual_seed(3)
    keys = torch.randint(0, 1 << 20, (n,), device=cuda, generator=g)
    builds = torch.randint(0, 1 << 20, (4000,), device=cuda, generator=g).sort().values
    s = torch.cat([builds * 2, keys * 2 + 1])
    v = torch.cat([torch.randint(-9, 9, (4000,), device=cuda, generator=g),
                   torch.randperm(n, device=cuda, generator=g)]).to(torch.int32)
    s, order = s.sort(stable=True)
    v = v[order].contiguous()
    got = merge_scan.merge_stats_i64(s, v, n)
    want = merge_scan.merge_stats_plain(s, v, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("L", [1, 7, 4095, 4097, 123_457])
def test_merge_scan_stats_edges(cuda, L):
    """The generic form at lengths off the tile, INT64_MIN and INT64_MAX
    among the keys, payloads at the tag's extremes."""
    rng = np.random.default_rng(L)
    sk = np.sort(rng.choice(np.array([I64_MIN, -1, 0, 5, I64_MAX], np.int64), L))
    is_build = rng.random(L) < 0.5
    order = np.lexsort((~is_build, sk))
    sk, is_build = sk[order], is_build[order]
    pay = rng.choice(np.array([-(2**62), -1, 0, 2**62 - 1], np.int64), L)
    st = np.where(is_build, pay * 2 + 1, 0)
    sk, st = _i64(sk, cuda), _i64(st, cuda)
    got = merge_scan.merge_scan_stats(sk, st)
    want = merge_scan.merge_scan_stats_plain(sk, st)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("pay_bits", [2, 31])
@pytest.mark.parametrize("L", [3, 4097, 70_000])
def test_merge_scan_stats_packed_edges(cuda, pay_bits, L):
    rng = np.random.default_rng(L + pay_bits)
    key = rng.integers(0, 40, L)
    is_build = rng.random(L) < 0.5
    field = np.where(is_build, rng.integers(0, 2 ** (pay_bits - 1), L) * 2, (1 << pay_bits) - 1)
    s = _i64(np.sort((key << pay_bits) | field), cuda)
    got = merge_scan.merge_scan_stats_packed(s, pay_bits)
    want = merge_scan.merge_scan_stats_packed_plain(s, pay_bits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---- #1 and #13's count-side tile sort (csrc/sort_tiles.cu), key only

@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("tile_log", list(range(1, bigsort.MAX_TILE_LOG + 1)))
@pytest.mark.parametrize("kind", ["random", "equal", "extremes"])
def test_sort_tiles_key_only_edges(cuda, dtype, tile_log, kind):
    """tile_log 1..13 (below one thread's 16 keys, the tile padded in
    registers), all-equal tiles, the key type's extremes among the keys."""
    info = torch.iinfo(dtype)
    g = torch.Generator(device=cuda).manual_seed(tile_log)
    n = 5 << tile_log
    if kind == "equal":
        x = torch.full((n,), 12345, dtype=dtype, device=cuda)
    else:
        x = torch.randint(info.min, info.max, (n,), dtype=dtype, device=cuda, generator=g)
        if kind == "extremes":
            x[::3] = info.max
            x[1::5] = info.min
    wrapper = bigsort.sort_tiles_i32 if dtype == torch.int32 else bigsort.sort_tiles_i64
    assert torch.equal(wrapper(x, tile_log), bigsort.sort_tiles_plain(x, tile_log))


# ---- #2 and #13's count-side merge level on merge_multi.cu's key-only build

@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 8191, 8193, 3 * 8192 + 5])
@pytest.mark.parametrize("kind", EDGE_KEYS)
def test_merge_level_key_only_edges(cuda, dtype, n, kind):
    """run_log 0..20 (tiles of min(4096, 2L) outputs, the ragged last pair,
    an empty B), from a view 4 bytes past an aligned address, the key
    type's extremes and all-equal keys; each level is one launch on the
    wrapper and one partition."""
    merge_level = bigsort.KERNELS[dtype][1]
    rng = np.random.default_rng(n + 11)
    runs = _edge_keys(rng, n + 1, dtype, kind).to(cuda)[1:]  # a misaligned view
    for run_log in range(21):
        before = (merge_level.launches, pairsort.merge_partition.launches)
        got = merge_level(runs, run_log)
        after = (merge_level.launches, pairsort.merge_partition.launches)
        runs = bigsort.merge_level_plain(runs, run_log)
        assert torch.equal(got, runs), run_log
        assert after == tuple(b + (n > 0) for b in before)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("tile_log, n_tiles", [(bigsort.TILE_LOG, 13), (bigsort.TILE_LOG, 1),
                                               (11, 5), (4, 70), (1, 9)])
def test_sort_runs_one_call_equals_levels(cuda, dtype, tile_log, n_tiles):
    """The ladder's one host call (`ccve_sort_runs`) equals the tile sort
    and the levels called one by one, at either parity of the level count
    and capped by run_log, and counts one tile sort, and a launch and a
    partition a level."""
    sort_tiles, merge_level = bigsort.KERNELS[dtype]
    rng = np.random.default_rng(n_tiles * 31 + tile_log)
    x = _edge_keys(rng, n_tiles << tile_log, dtype, "extremes").to(cuda)
    for run_log in sorted({tile_log, tile_log + 1, tile_log + 2, tile_log + 3, tile_log + 20}):
        n_levels = min(max(n_tiles - 1, 0).bit_length(), run_log - tile_log)
        want = sort_tiles(x, tile_log)
        for level in range(n_levels):
            want = merge_level(want, tile_log + level)
        counters = (sort_tiles, merge_level, pairsort.merge_partition)
        before = tuple(c.launches for c in counters)
        got = bigsort.sort_runs(x, run_log, tile_log)
        after = tuple(c.launches for c in counters)
        assert after == (before[0] + 1, before[1] + n_levels, before[2] + n_levels)
        assert torch.equal(got, want), run_log
        assert torch.equal(got, bigsort.sort_runs_plain(x, run_log, tile_log)), run_log


def test_count_side_reaches_the_key_only_levels(cuda):
    """config 1's count side at a small size: the tile sort once (the
    narrowing one, `sort_runs_narrowed`; the key-only `sort_tiles_i32`
    not), every level once with its partition, the totals equal to the
    CPU's."""
    from ccve_tpu_torch.bench.configs import config1_host

    keys, pays, probe = config1_host(20_000, 300_000)
    col = torch.from_numpy(probe[:, 0].astype(np.int32))
    counters = (bigsort.sort_runs_narrowed, bigsort.merge_level_i32, pairsort.merge_partition,
                bigsort.sort_tiles_i32)
    before = tuple(c.launches for c in counters)
    got = sm.sorted_match_totals(sm.build_sorted(keys, pays, cuda), col.to(cuda))
    after = tuple(c.launches for c in counters)
    n_pad, run_log = sm.count_side_plan(col.numel(), keys.size, bigsort.TILE_LOG)
    n_levels = run_log - bigsort.TILE_LOG
    assert n_levels > 0
    assert after == (before[0] + 1, before[1] + n_levels, before[2] + n_levels, before[3])
    want = sm.sorted_match_totals(sm.build_sorted(keys, pays, device="cpu"), col)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))


# ---- #1's and #13's narrowing loads: the count side's ladder read from the raw probe column

NARROW_LENGTHS = {"a tile multiple": 5 << bigsort.TILE_LOG,
                  "one above": (5 << bigsort.TILE_LOG) + 1,
                  "small-route boundary + 1": (1 << sm.SMALL_PROBE_LOG) + 1}


def _narrow_form(table):
    """(key type, clamp bounds, narrowing, narrowing load, counters: the
    load, the key-only tile sort it replaces, the levels, the partitions)
    of a table's count side."""
    if table.pack32 is None:
        return (torch.int64, sm._wide_bounds(table), sm._probe_key64,
                bigsort.sort_runs_narrowed_i64,
                (bigsort.sort_runs_narrowed_i64, bigsort.sort_tiles_i64,
                 bigsort.merge_level_i64, pairsort.merge_partition))
    return (torch.int32, sm._narrow_bounds(table), sm._probe_key32, bigsort.sort_runs_narrowed,
            (bigsort.sort_runs_narrowed, bigsort.sort_tiles_i32, bigsort.merge_level_i32,
             pairsort.merge_partition))


@pytest.mark.parametrize("length", NARROW_LENGTHS)
@pytest.mark.parametrize("table_kind", [*NARROW_TABLES, *NARROW_WIDE_TABLES])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_sort_runs_narrowed_equals_the_composition(cuda, dtype, table_kind, length):
    """The narrowing tile sort and its ladder from one host call
    (`ccve_sort_runs_narrow_i32` on a `pack32` table, `_i64` on a wide
    one) equal, bit for bit, the composition they replace on the card (the
    column narrowed by `_probe_key32` or `_probe_key64`, padded with the
    key type's maximum by `_padded`, then `sort_runs`) and the plain
    route, at either parity of the level count, with whole tiles of
    padding past the column, and at a small tile, and read in place from
    a strided view; each call counts once, and a launch and a partition a
    level, and never on the key-only tile sort it replaces."""
    n = NARROW_LENGTHS[length]
    keys, col = narrow_case(np.random.default_rng(n), table_kind, n, dtype)
    table = sm.build_sorted(keys, device=cuda)
    key_type, bounds, probe_key, load, counters = _narrow_form(table)
    col = torch.from_numpy(col).to(cuda)
    p = probe_key(table, col)
    assert p.dtype == key_type
    for tile_log in (4, bigsort.TILE_LOG):
        for extra_tiles in (0, 2):
            n_pad = n + (-n) % (1 << tile_log) + (extra_tiles << tile_log)
            padded = sm._padded(p, (n_pad,))
            for run_log in (tile_log, tile_log + 1, tile_log + 2, tile_log + 20):
                n_levels = bigsort._n_levels(n_pad, run_log, tile_log)
                before = [c.launches for c in counters]
                got = load(col, *bounds, n_pad, run_log, tile_log)
                after = [c.launches for c in counters]
                what = (tile_log, extra_tiles, run_log)
                assert [a - b for a, b in zip(after, before)] == [1, 0, n_levels, n_levels], what
                assert got.dtype == key_type
                assert torch.equal(got, bigsort.sort_runs(padded, run_log, tile_log)), what
                assert torch.equal(got, bigsort.sort_runs_narrowed_plain(
                    col, *bounds, n_pad, run_log, tile_log, key_type)), what
    for strided in (torch.stack([col.flip(0), col], 1)[:, 1], col.repeat_interleave(2)[::2]):
        assert not strided.is_contiguous()
        n_pad = n + (-n) % (1 << bigsort.TILE_LOG)
        run_log = bigsort.TILE_LOG + 1
        assert torch.equal(load(strided, *bounds, n_pad, run_log),
                           load(col, *bounds, n_pad, run_log))


@pytest.mark.parametrize("route", ["tile route", "small probe", "wide", "full range",
                                   "stats side"])
def test_narrowing_load_launches_only_on_the_tile_route(cuda, route):
    """`sort_runs_narrowed` launches once a call of the count side on a
    `pack32` table above 2^SMALL_PROBE_LOG probes, `sort_runs_narrowed_i64`
    once a call on a wide table, and neither on the small-probe,
    full-range or stats routes; every answer is the CPU's."""
    rng = np.random.default_rng(len(route))
    stride = {"wide": 1 << 22, "full range": 1 << 50}.get(route, 1)
    keys = (rng.permutation(3000) - 1500).astype(np.int64) * stride
    if route == "full range":
        keys[0] = -(2**63) + 5
    n = 8192 if route == "small probe" else 300_000
    probe = torch.from_numpy(rng.choice(keys, n) + rng.integers(0, 2, n))
    payloads = rng.integers(0, 10**6, keys.size)
    tables = {dev: sm.build_sorted(keys, payloads, device=dev) for dev in (cuda, "cpu")}
    loads = (bigsort.sort_runs_narrowed, bigsort.sort_runs_narrowed_i64)
    before = [load.launches for load in loads]
    if route == "stats side":
        got, want = (sm.sorted_match_stats(tables[dev], probe.to(dev)) for dev in (cuda, "cpu"))
        assert torch.equal(got.mult.cpu(), want.mult) and torch.equal(got.psum.cpu(), want.psum)
    else:
        got, want = (sm.sorted_match_totals(tables[dev], probe.to(dev)) for dev in (cuda, "cpu"))
        assert [int(t) for t in got] == [int(t) for t in want]
        got, want = (sm.sorted_build_counts(tables[dev], probe.to(dev)) for dev in (cuda, "cpu"))
        assert torch.equal(got.cpu(), want)
    launched = [load.launches - b for load, b in zip(loads, before)]
    assert launched == [2 if route == "tile route" else 0, 2 if route == "wide" else 0]


# ---- #9, the compaction: one launch, look-back across tiles, zeros from the kernel

COMPACT_MASKS = ["all", "none", "alternating", "random", "first", "last", "runs"]


def _compact_mask(rng, n, kind):
    if kind == "runs":  # long kept and dropped stretches across tiles
        return np.repeat(rng.random(n // 5000 + 1) < 0.5, 5000)[:n]
    return {"all": np.ones(n, bool), "none": np.zeros(n, bool),
            "alternating": np.arange(n) % 2 == 0, "random": rng.random(n) < 0.3,
            "first": np.arange(n) == 0, "last": np.arange(n) == n - 1}[kind]


@pytest.mark.parametrize("n", [1, 15, 16, 17, 4095, 4096, 4097, 8192, 3 * 4096 + 7, 200_003])
@pytest.mark.parametrize("kind", COMPACT_MASKS)
def test_compact_kernel_edges(cuda, n, kind):
    """n under a tile, at and off the tile, C = 1..3 by n; the mask and the
    planes also from views 1 byte / 4 bytes past an aligned address (the
    mask's byte-by-byte path); output garbage before the call is
    overwritten; one launch a call."""
    rng = np.random.default_rng(n)
    n_planes = 1 + n % 3
    mask_np = _compact_mask(rng, n, kind)
    planes = torch.from_numpy(
        rng.integers(-(2**31), 2**31 - 1, (n_planes, n)).astype(np.int32)).to(cuda)
    want, want_count = compact.compact_plain(planes, torch.from_numpy(mask_np).to(cuda))
    mask = torch.from_numpy(mask_np).to(cuda)
    odd_mask = torch.from_numpy(np.concatenate([[True], mask_np])).to(cuda)[1:]
    odd_planes = torch.cat([planes.new_zeros(1), planes.reshape(-1)])[1:].view(n_planes, n)
    for p, m in ((planes, mask), (odd_planes, odd_mask)):
        del_me = torch.full_like(p, -7)  # garbage where the output will be allocated
        del del_me
        before = compact.compact_i32.launches
        got, count = compact.compact_i32(p, m)
        assert compact.compact_i32.launches == before + 1
        assert int(count) == int(want_count) == int(mask_np.sum())
        assert torch.equal(got, want)


def test_compact_again_and_again(cuda):
    """The look-back across blocks that run at once: twenty calls on each
    of four streams at once, over 1,500 tiles, each equal to the plain
    version."""
    rng = np.random.default_rng(21)
    n = 6_000_001
    planes = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (3, n)).astype(np.int32)).to(cuda)
    masks = [torch.from_numpy(_compact_mask(rng, n, kind)).to(cuda)
             for kind in ("random", "runs", "alternating", "all")]
    wants = [compact.compact_plain(planes, m) for m in masks]
    streams = [torch.cuda.Stream() for _ in masks]
    torch.cuda.synchronize()
    results = [[] for _ in masks]
    for _ in range(20):
        for s, mask, out in zip(streams, masks, results):
            with torch.cuda.stream(s):
                out.append(compact.compact_i32(planes, mask))
    torch.cuda.synchronize()
    for (want, want_count), out in zip(wants, results):
        for got, count in out:
            assert int(count) == int(want_count)
            assert torch.equal(got, want)


@pytest.mark.parametrize("full", [True, False], ids=["full", "reference"])
@pytest.mark.parametrize("width", [1, 2, 3, 40])
@pytest.mark.parametrize("n_keep", [1, 1023, 1025, 3 * 1024 + 7, 200_001])
def test_emit_rows_kernel(cuda, n_keep, width, full):
    """The emission kernel bit for bit against its plain version, at row
    counts off its tile (1024 rows at W <= 3, 128 at W = 40), over planes
    longer than n_keep, at the int64 ends of the key offset."""
    rng = np.random.default_rng(n_keep + width)
    rows, length = 5_000, n_keep + 13
    planes = torch.from_numpy(np.stack([
        rng.integers(0, rows, length), rng.integers(1, 2**29, length),
        rng.integers(-(2**31), 2**31 - 1, length)]).astype(np.int32)).to(cuda)
    state = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, (rows, width))).to(cuda)
    for kmin in (0, -(2**62) + 3, 2**62, -(2**63)):
        for level in sorted({0, width // 2, width - 1}):
            before = emit.emit_rows_i32.launches
            got = emit.emit_rows_i32(planes, n_keep, kmin, state, level, full)
            assert emit.emit_rows_i32.launches == before + 1
            want = emit.emit_rows_plain(planes, n_keep, kmin, state, level, full)
            assert got.shape == (n_keep, width + 2) and torch.equal(got, want), (kmin, level)


def test_emit_rows_kernel_no_match_launches_nothing(cuda):
    planes = torch.zeros((3, 64), dtype=torch.int32, device=cuda)
    state = torch.zeros((64, 2), dtype=torch.int64, device=cuda)
    before = emit.emit_rows_i32.launches
    assert emit.emit_rows_i32(planes, 0, 5, state, 1, True).shape == (0, 4)
    assert emit.emit_rows_i32.launches == before


def test_bulk_materialize_emits_each_sorted_int32_level_once(cuda):
    """Over sorted int32, LP, sorted int32, CSR and wide int64 levels the
    emission kernel launches once a sorted int32 level and never for the
    others; the rows equal the CPU path's as a multiset."""
    rng = np.random.default_rng(27)
    kinds = ["sorted", "lp", "sorted", "csr", "wide"]
    build = {"sorted": sm.build_sorted, "wide": sm.build_sorted, "lp": build_lp,
             "csr": build_csr}
    tables = {"cpu": [], "cuda": []}
    cols = []
    for kind in kinds:
        keys = np.repeat(rng.permutation(3000).astype(np.int64) * 3, rng.integers(1, 3, 3000))
        if kind == "wide":
            keys = keys * 2**40
        pays = rng.integers(-(2**31), 2**31 - 1, keys.size)
        for dev in tables:
            tables[dev].append(build[kind](keys, pays, device=dev))
        cols.append(rng.choice(keys, 4000) + rng.integers(0, 2, 4000))
    probe = np.stack(cols, axis=1)
    emit.emit_rows_i32.launches = 0
    got = bulk.bulk_materialize(tables["cuda"], torch.from_numpy(probe).to(cuda), PayloadMode.FULL)
    torch.cuda.synchronize()
    assert emit.emit_rows_i32.launches == 2
    want = bulk.bulk_materialize(tables["cpu"], probe, PayloadMode.FULL)
    assert got.shape == want.shape and want.shape[0] > 0
    assert sorted(map(tuple, got.cpu().tolist())) == sorted(map(tuple, want.tolist()))
