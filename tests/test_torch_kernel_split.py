"""`bench.kernel_split.device_split`'s reading of torch.profiler windows
that lost device events, on synthetic windows (the profiler's device
events exist only on the card)."""

import pytest

from ccve_tpu_torch.bench import kernel_split


def _fake_windows(monkeypatch, windows):
    it = iter(windows)
    monkeypatch.setattr(kernel_split, "_window", lambda fn, calls: next(it))
    monkeypatch.setattr(kernel_split.torch.cuda, "synchronize", lambda: None)


def test_device_split_reads_through_lost_events(monkeypatch):
    """A kernel's launches a call are the most any window saw, its time a
    launch the mean of every recorded event; a window that lost events is
    not complete."""
    calls = 4
    full = ({"k": 8, "m": 4}, {"k": 8 * 2.0 / calls, "m": 4 * 5.0 / calls}, 9.0)
    lossy = ({"k": 3}, {"k": 3 * 4.0 / calls}, 3.0)
    _fake_windows(monkeypatch, [lossy, full] + [lossy] * (kernel_split.TRACE_WINDOWS - 2))
    d = kernel_split.device_split(lambda: None, calls)
    assert d["events"] == 3 and d["complete"] == 1 and d["busy"] == 9.0
    # k: 2 a call at the mean of 8 events of 2 us and the lossy windows' of 4 us
    n_lossy = kernel_split.TRACE_WINDOWS - 1
    mean_k = (8 * 2.0 + n_lossy * 3 * 4.0) / (8 + n_lossy * 3)
    assert d["kernels"] == {"k": round(2 * mean_k, 3), "m": 5.0}
    assert d["us"] == pytest.approx(2 * mean_k + 5.0)


def test_device_split_raises_without_device_events(monkeypatch):
    _fake_windows(monkeypatch, [({}, {}, 0.0)] * kernel_split.TRACE_WINDOWS)
    with pytest.raises(RuntimeError, match="no device events"):
        kernel_split.device_split(lambda: None, 5)


def test_probe_sort_cases_hold_kernels_and_yardsticks(monkeypatch):
    """#6 and #7's cases on small streams of both key types (on the CPU the
    wrappers run their plain versions): each kernel is held against its
    plain version, the packed-word `torch.sort` yardstick gives what
    `sort_multi_i32` gives, and each case runs and names its counters."""
    import numpy as np
    import torch

    from ccve_tpu_torch.kernels import pairsort

    rng = np.random.default_rng(5)

    def streams(device):
        out = {}
        for shape, dtype, n, lo, hi in (("small i32", torch.int32, 20_000, 0, 3000),
                                        ("small i64", torch.int64, 9_000, -2**62, 2**62)):
            p = torch.from_numpy(rng.integers(lo, hi, n)).to(dtype)
            b = torch.from_numpy(np.sort(rng.integers(lo, hi, 700))).to(dtype)
            out[shape] = (p, b, torch.from_numpy(rng.integers(0, 2**30, 700)).to(torch.int32))
        return out

    monkeypatch.setattr(kernel_split, "stats_streams", streams)
    cases = kernel_split.probe_sort_cases(torch.device("cpu"))
    assert len(cases) == 8
    for name, fn, counters, lib_name, lib in cases:
        fn()
        if lib is not None:
            lib()
            assert lib_name.startswith("torch.sort")
        want = {"sort_tiles_multi", "merge_level_multi", "merge_two_multi"}
        assert counters and all(any(w in c for w in want) or c == "merge_partition"
                                for c in counters), name
    assert any(c == "merge_partition" for _, _, cs, _, _ in cases for c in cs) == hasattr(
        pairsort, "merge_partition")


def _stats_streams(device):
    """Small stand-ins for `kernel_split.stats_streams`: packed probes,
    builds and payloads of both key types."""
    import numpy as np
    import torch

    rng = np.random.default_rng(8)
    out = {}
    for shape, dtype, n, span in (("wide stats 2^24 i64", torch.int64, 9000, 2**40),
                                  ("config 3 1M", torch.int32, 20_000, 3000)):
        p = (torch.from_numpy(rng.integers(0, span, n)) << 1 | 1).to(dtype)
        b = (torch.from_numpy(np.sort(rng.integers(0, span, 700))) << 1).to(dtype)
        out[shape] = (p, b, torch.from_numpy(rng.integers(-2**30, 2**30, 700)).to(torch.int32))
    return out


def test_stats_cases_hold_kernels_and_run(monkeypatch):
    """#15 and #8's cases on small streams (on the CPU the wrappers run
    their plain versions): the merged streams are the probe sort and the
    merge of two, each kernel is held against its plain version, the
    generic entry gets the same stream untagged, and every case runs and
    names its counter (the zeroing alone has none)."""
    import torch

    from ccve_tpu_torch.kernels import merge_scan

    monkeypatch.setattr(kernel_split, "stats_streams", _stats_streams)
    kernel_split.stats_scan_inputs.cache_clear()
    try:
        inputs = kernel_split.stats_scan_inputs(torch.device("cpu"))
        cases = kernel_split.stats_cases(torch.device("cpu"))
    finally:
        kernel_split.stats_scan_inputs.cache_clear()
    s, v, n = inputs["wide stats 2^24 i64"]
    assert s.dtype == torch.int64 and s.numel() == n + 700 and bool((s[1:] >= s[:-1]).all())
    sk, st = kernel_split._generic(s, v)
    mult, psum = merge_scan.merge_stats_plain(s, v, n)
    probe = (st & 1) == 0
    gm, gp = merge_scan.merge_scan_stats_plain(sk, st)
    assert torch.equal(gm[probe], mult[v[probe].long()])
    assert torch.equal(gp[probe], psum[v[probe].long()])
    assert [c is None for _, _, c in cases] == [False, True, False, False, True]
    for name, fn, counter in cases:
        fn()
        assert counter is None or counter.__name__ in {"merge_stats_i64", "merge_stats_i32",
                                                       "merge_scan_stats"}, name


def test_tile_sort_cases_hold_kernels_and_yardsticks(monkeypatch):
    """#1 and #13's count-side cases on small padded streams: each kernel
    is held against its plain version, and the yardstick's values equal
    the kernel's."""
    import numpy as np
    import torch

    from ccve_tpu_torch.kernels import bigsort

    rng = np.random.default_rng(2)
    T = 1 << bigsort.TILE_LOG
    tiles = {"i32": torch.from_numpy(rng.integers(0, 99, 3 * T).astype(np.int32)),
             "i64": torch.from_numpy(rng.integers(-2**62, 2**62, 2 * T))}
    monkeypatch.setattr(kernel_split, "count_tiles", lambda device: tiles)
    cases = kernel_split.tile_sort_cases(torch.device("cpu"))
    assert [c.__name__ for _, _, c, _, _ in cases] == ["sort_tiles_i32", "sort_tiles_i64"]
    for _, fn, _, lib_name, lib in cases:
        assert torch.equal(fn().view(-1, T), lib().values)
        assert lib_name.startswith("torch.sort(dim=1)")


def test_stats_sweep_variants_apply_to_the_sources():
    """Every rewrite of `bench.stats_sweep` for the design the sources hold
    finds its text exactly once, so a sweep on the card builds what it
    names."""
    from ccve_tpu_torch.bench import stats_sweep
    from ccve_tpu_torch.kernels import _build

    name, variants = stats_sweep.design()
    assert name == "single-pass"
    sources = {f: (_build.CSRC / f).read_text() for f in ("seg_scan.cuh", "merge_stats.cu")}
    for copy, subs in variants.items():
        for target, old, _ in subs:
            assert sources[target].count(old) == 1, (copy, old)
    assert stats_sweep.INEXACT <= set(variants)


def _count_tiles():
    """Small stand-ins for `kernel_split.count_tiles`: padded probe streams
    of both key types, whole tiles of 2^TILE_LOG."""
    import numpy as np
    import torch

    from ccve_tpu_torch.kernels import bigsort

    rng = np.random.default_rng(6)
    T = 1 << bigsort.TILE_LOG
    return {"small i32": torch.from_numpy(rng.integers(0, 500, 5 * T).astype(np.int32)),
            "small i64": torch.from_numpy(rng.integers(-2**62, 2**62, 3 * T))}


def test_count_level_cases_hold_kernels_and_yardsticks(monkeypatch):
    """#2 and #13's count-side cases on small streams (on the CPU the
    wrappers run their plain versions): the first level and the ladder at
    `count_side_plan`'s run_log, each held against its plain version and
    its yardstick (a row sort of the padded run pairs or runs), name the
    level's wrapper and the partition counter."""
    import torch

    from ccve_tpu_torch.kernels import bigsort

    tiles = _count_tiles()
    monkeypatch.setattr(kernel_split, "count_tiles", lambda device: tiles)
    cases = kernel_split.count_level_cases(torch.device("cpu"))
    assert len(cases) == 4
    for (name, fn, counters, lib_name, lib), x in zip(cases, [t for t in tiles.values()
                                                             for _ in range(2)]):
        got = fn()
        assert torch.equal(lib().values.reshape(-1)[:x.numel()], got), name
        assert lib_name.startswith("torch.sort(dim=1)")
        assert "merge_partition" in counters
        assert any(c.startswith("merge_level_i") for c in counters), name
        if name.startswith("sort_runs"):
            assert any(c.startswith("sort_tiles_i") for c in counters)
        else:
            assert torch.equal(got, bigsort.merge_level_plain(
                bigsort.sort_tiles_plain(x, bigsort.TILE_LOG), bigsort.TILE_LOG))


def test_merge_counts_cases_hold_kernels_and_yardsticks(monkeypatch):
    """#3 and #14's cases on small count streams of both key types (on the
    CPU the wrappers run their plain versions): the runs the ladder leaves,
    the kernel held against its plain version and the searchsorted
    yardstick over the padded [R, run_len] runs, which gives the same
    counts; each case names its wrapper."""
    import numpy as np
    import torch

    from ccve_tpu_torch.kernels import bigsort

    rng = np.random.default_rng(12)
    T = 1 << bigsort.TILE_LOG
    streams = {}
    for shape, dtype, n, hi in (("small i32", torch.int32, 5 * T - 100, 3000),
                                ("small i64", torch.int64, 3 * T - 7, 2**61)):
        keys = np.sort(rng.choice(hi, 700, replace=False))
        p = torch.from_numpy(rng.choice(keys, n) * 2).to(dtype)
        x = torch.cat([p, p.new_full((-n % T,), bigsort.PAD[dtype])])
        streams[shape] = (x, n, torch.from_numpy(keys * 2 + 1).to(dtype))
    monkeypatch.setattr(kernel_split, "count_streams", lambda device: streams)
    cases = kernel_split.merge_counts_cases(torch.device("cpu"))
    assert [c.__name__ for _, _, c, _, _ in cases] == ["merge_counts_i32", "merge_counts_i64"]
    for (name, fn, _, lib_name, lib), (x, n, b) in zip(cases, streams.values()):
        got = fn()
        assert got.dtype == torch.int32 and got.numel() == b.numel()
        assert int(got.sum()) == n and torch.equal(lib(), got.long()), name
        assert lib_name.startswith("torch.searchsorted")


def test_compact_cases_hold_kernels_and_yardsticks(monkeypatch):
    """#9's cases on small planes: the kernel (here its plain version)
    against its yardstick `planes[:, mask]`, which gives the kept rows
    alone."""
    import numpy as np
    import torch

    from ccve_tpu_torch.kernels import compact

    rng = np.random.default_rng(9)
    inputs = {f"C={c}": (torch.from_numpy(rng.integers(-9, 9, (c, 30_001)).astype(np.int32)),
                         torch.from_numpy(rng.random(30_001) < 0.6)) for c in (2, 3)}
    monkeypatch.setattr(kernel_split, "compact_inputs", lambda device: inputs)
    cases = kernel_split.compact_cases(torch.device("cpu"))
    assert [c for _, _, c, _, _ in cases] == [compact.compact_i32] * 2
    for (name, fn, _, lib_name, lib), (planes, mask) in zip(cases, inputs.values()):
        out, count = fn()
        kept = lib()
        assert kept.shape == (planes.shape[0], int(mask.sum())) == (planes.shape[0], int(count))
        assert torch.equal(out[:, :int(count)], kept) and not out[:, int(count):].any()
        assert lib_name.startswith("planes[:, mask]")


def test_kernel_split_refuses_unknown_groups():
    with pytest.raises(SystemExit):
        kernel_split.main(["--only", "tile_sort,nonesuch"])


def test_tile_sweep_copies_apply_to_the_sources():
    """Every copy of `bench.tile_sweep` finds each text it rewrites exactly
    once, and ptxas' lines of the kernels it reads parse into resources."""
    from ccve_tpu_torch.bench import tile_sweep

    for copy in tile_sweep.COPIES:
        tile_sweep.sources(copy)
    assert tile_sweep.INEXACT <= set(tile_sweep.COPIES)
    lines = [
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__x_14_merge_multi_cu_y12"
        "merge_kernelIiLi0ENS_5LevelEEEvPKT_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN47",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__x_10_compact_cu_y14"
        "compact_kernelEPKi' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 2160 bytes smem",
        "ptxas info    : Compiling entry function '_ZN47_other_kernelEv' for 'sm_90a'",
        "ptxas info    : Used 200 registers",
        "ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__x_15_merge_counts_cu_y19"
        "merge_counts_kernelIxEEvPKT_xiS3_iPi' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 1024 bytes smem",
    ]
    got = tile_sweep.resources(lines, tile_sweep._block_threads("counts 512 x 4"))
    assert len(got) == 3
    assert got[0].startswith("merge_kernel<int, 0, Level>: Used 32 registers")
    assert got[0].endswith("8 blocks of 256 an SM by registers and static smem")
    assert got[1].startswith("compact_kernel: Used 128 registers")
    assert "2 blocks of 256" in got[1]
    assert got[2].startswith("merge_counts_kernel<long long>: Used 64 registers")
    assert "2 blocks of 512" in got[2]


def test_tile_sweep_copies_build_their_own_sources():
    """Each copy builds the sources of the kernel it rewrites (with
    status.cu), `source` all of them, and every source a copy rewrites is
    among those it builds."""
    from ccve_tpu_torch.bench import tile_sweep
    from ccve_tpu_torch.kernels import _build

    every = {f.name for f in _build.CSRC.glob("*.cu")}
    assert set(tile_sweep.units("source")) <= every
    assert {"merge_multi.cu", "compact.cu", "merge_counts.cu"} <= set(tile_sweep.units("source"))
    for copy, subs in tile_sweep.COPIES.items():
        assert tile_sweep.group(copy) in (None, "merge", "compact", "counts"), copy
        assert {target for target, _, _ in subs} <= set(tile_sweep.units(copy)), copy
    assert tile_sweep.units("counts stage x2") == ["merge_counts.cu", "status.cu"]
