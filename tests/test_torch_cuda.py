"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips without them. This
file imports neither JAX nor `ccve_tpu`, so on a machine without JAX run it
without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ccve_tpu_torch.kernels import bigsort, compact, merge_scan, pairsort
from ccve_tpu_torch.ops import sort_merge as sm

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
                compact.compact_i32]
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
    int64 kernels, and agree with the CPU's plain versions."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**40, 20_000, dtype=np.int64)
    pays = rng.integers(-(2**30), 2**30, keys.size)
    probe_np = np.concatenate([rng.choice(keys, 60_000), rng.integers(0, 2**40, 40_000)])
    probe = torch.from_numpy(probe_np).to(cuda)
    counters = [bigsort.sort_tiles_i64, bigsort.merge_level_i64, merge_scan.merge_counts_i64,
                pairsort.sort_tiles_multi_i64, pairsort.merge_level_multi_i64,
                pairsort.merge_two_multi_i64, merge_scan.merge_stats_i64]
    before = [fn.launches for fn in counters]
    table = sm.build_sorted(keys, pays)
    assert table.device.type == "cuda" and table.pack32 is None
    count, checksum = sm.sorted_match_totals(table, probe)
    stats = sm.sorted_match_stats(table, probe)
    after = [fn.launches for fn in counters]
    assert all(a > b for a, b in zip(after, before)), (before, after)
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
