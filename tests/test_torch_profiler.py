"""The port's profilers (`utils.profiler`) against the JAX package's: the
same records give the same Bee stats and table, the same Zebra histograms
and byte-identical CSV files, and the same phase report; the executors'
occupancy exports (`export_occupancy`, `export_occupancy_segments`) feed
the Zebra profiler as the JAX driver's do."""

import io

import numpy as np
import pytest

from ccve_tpu.config import CompactionStrategy as JStrategy
from ccve_tpu.config import EngineConfig as JConfig
from ccve_tpu.exec.sorted_pipeline import SortedPipeline as JSortedPipeline
from ccve_tpu.ops.sort_merge import build_sorted as jax_build_sorted
from ccve_tpu.utils import profiler as jax_profiler
from ccve_tpu_torch.config import CompactionStrategy, EngineConfig
from ccve_tpu_torch.exec.sorted_pipeline import SortedPipeline
from ccve_tpu_torch.ops.sort_merge import build_sorted
from ccve_tpu_torch.utils import profiler


@pytest.fixture
def zebras():
    """Both packages' Zebra singletons, empty before and after."""
    pair = (profiler.ZebraProfiler.get(), jax_profiler.ZebraProfiler.get())
    for z in pair:
        z.clear()
    yield pair
    for z in pair:
        z.clear()


def test_bee_matches_jax():
    ours, theirs = profiler.BeeProfiler(), jax_profiler.BeeProfiler()
    rng = np.random.default_rng(0)
    for _ in range(50):
        name = f"[{rng.choice(['Probe', 'Build', 'Generate Data'])}]"
        seconds = float(rng.uniform(0, 0.1))
        ours.insert_stat_record(name, seconds)
        theirs.insert_stat_record(name, seconds)
    assert ours.stats() == theirs.stats()
    out_ours, out_theirs = io.StringIO(), io.StringIO()
    ours.end_profiling(out_ours)
    theirs.end_profiling(out_theirs)
    assert out_ours.getvalue() == out_theirs.getvalue() and out_ours.getvalue()
    with ours.time("[Scope]"):
        pass
    assert ours.stats()["[Scope]"][1] == 1
    ours.clear()
    assert ours.stats() == {}
    assert isinstance(profiler.BeeProfiler.get(), profiler.BeeProfiler)


def test_zebra_matches_jax(tmp_path, zebras):
    ours, theirs = zebras
    rng = np.random.default_rng(1)
    for _ in range(300):
        name = f"level{rng.integers(0, 3)}_full compaction/x"  # unsafe file characters
        occ, seconds = int(rng.integers(0, 257)), float(rng.uniform(0, 1e-3))
        ours.insert_record(name, occ, seconds)
        theirs.insert_record(name, occ, seconds)
    names = {f"level{i}_full compaction/x" for i in range(3)}
    for name in names:
        assert ours.histogram(name) == theirs.histogram(name)
    ours.to_csv(str(tmp_path / "ours"))
    theirs.to_csv(str(tmp_path / "theirs"))
    files = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "theirs").iterdir())
    assert len(files) == 3
    for name in files:
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "theirs" / name).read_bytes()


def test_phase_profiler_matches_jax():
    ours, theirs = profiler.PhaseProfiler(), jax_profiler.PhaseProfiler()
    for phase, seconds, items, nbytes in (("hash", 0.002, 4096, 32768), ("match", 0.01, 4096, 0),
                                          ("gather", 0.004, 1000, 8000), ("hash", 0.001, 10, 80)):
        ours.record(phase, seconds, items, nbytes)
        theirs.record(phase, seconds, items, nbytes)
    assert ours.report(total_items=9106) == theirs.report(total_items=9106)
    assert ours.report() == theirs.report()
    assert ours.stats()["hash"].gb_per_s == theirs.stats()["hash"].gb_per_s
    ours.clear()
    assert ours.stats()["hash"].items == 0


@pytest.mark.parametrize("strategy", [CompactionStrategy.FULL, CompactionStrategy.DYNAMIC])
def test_occupancy_exports_match_jax(tmp_path, zebras, strategy):
    """The same histograms through both packages' exports (the run-total
    spread and the per-segment one) give identical Zebra CSVs."""
    ours, theirs = zebras
    keys = np.arange(64, dtype=np.int64)
    cfg = EngineConfig(block_size=128, n_joins=3, lhs_size=10, rhs_size=64, strategy=strategy)
    jcfg = JConfig(block_size=128, n_joins=3, lhs_size=10, rhs_size=64,
                   strategy=JStrategy(strategy.value))
    pipe = SortedPipeline([build_sorted(keys, device="cpu")] * 3, cfg)
    jpipe = JSortedPipeline([jax_build_sorted(keys)] * 3, jcfg, use_kernel=False)
    rng = np.random.default_rng(2)
    hist = rng.integers(0, 4, (3, 129)) * (rng.random((3, 129)) < 0.2)
    segments = [(float(rng.uniform(0, 0.01)), rng.integers(0, 3, (3, 129))) for _ in range(6)]
    segments.append((0.5, np.zeros((3, 129), np.int64)))  # a segment that recorded nothing
    for p in (pipe, jpipe):
        p.export_occupancy(hist, total_seconds=0.25)
        p.export_occupancy_segments(segments)
    ours.to_csv(str(tmp_path / "ours"))
    theirs.to_csv(str(tmp_path / "theirs"))
    files = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert files == [f"level{i}_{strategy.value}.csv" for i in range(3)]
    for name in files:
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "theirs" / name).read_bytes()
