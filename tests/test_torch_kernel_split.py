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
