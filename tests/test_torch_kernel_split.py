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
