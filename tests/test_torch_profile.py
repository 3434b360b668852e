"""The config-1 profiling script of the port, at a small size on the CPU:
its skip sweep, its busy/idle arithmetic and its refusal without a GPU."""

import pytest
import torch

from ccve_tpu_torch.bench import profile_config1 as prof
from ccve_tpu_torch.bench.configs import config1_data
from ccve_tpu_torch.kernels import bigsort
from ccve_tpu_torch.ops import sort_merge


@pytest.mark.parametrize(
    "intervals, want",
    [
        ([], (0.0, 0.0)),
        ([(2.0, 5.0)], (3.0, 3.0)),
        ([(0.0, 1.0), (3.0, 4.0)], (2.0, 4.0)),  # a gap of 2
        ([(0.0, 4.0), (1.0, 2.0), (3.0, 6.0)], (6.0, 6.0)),  # nested, overlapping
        ([(5.0, 6.0), (0.0, 1.0), (1.0, 2.0)], (3.0, 6.0)),  # unsorted, touching
    ],
)
def test_busy_window(intervals, want):
    assert prof.busy_window(intervals) == want


def test_sweep_small_cpu(monkeypatch):
    monkeypatch.setattr(bigsort, "TILE_LOG", 9)
    monkeypatch.setattr(prof, "REPS", 1)
    monkeypatch.setattr(sort_merge, "SKIP_LEVELS_OVERRIDE", None)
    table, probe, expected, _ = config1_data(512, 8192, "cpu")
    rows = prof.sweep(table, probe, expected, probe.device)
    assert [skip for skip, _, _ in rows] == list(prof.SKIPS)
    # 16 tiles of 2^9: four merge levels at most, so a skip s leaves
    # 2^min(s, 4) runs; the rule's own choice (0.8 * 8192 / 512 = 12.8
    # runs) skips 3 levels
    runs = {skip: n_runs for skip, n_runs, _ in rows}
    assert runs[None] == 8
    assert [runs[s] for s in prof.SKIPS[1:]] == [2 ** min(s, 4) for s in prof.SKIPS[1:]]
    assert all(len(ts) == 1 and ts[0] > 0 for _, _, ts in rows)
    assert sort_merge.SKIP_LEVELS_OVERRIDE is None


def test_main_small_cpu(monkeypatch, capsys):
    monkeypatch.setattr(prof, "REPS", 1)
    assert prof.main(["--device", "cpu", "--n-build", "256", "--n-probe", "4096"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("SWEEP ") for line in out) == 1 + len(prof.SKIPS)
    assert any(line.startswith("HOST wall ms") for line in out)
    assert not any(line.startswith("TRACE") for line in out)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_main_refuses_without_gpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prof.main(["--n-build", "256", "--n-probe", "4096"])
