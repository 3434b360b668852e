"""The span recorder (`utils.profiler.span`, `Spans`) on
`bulk_materialize`: a call is the root `bulk.materialize`; a level on the
stats side's int32 kernel route records `expand_compacted`'s steps as its
children, in order, each after the first starting at the previous one's
end stamp (`follows`), then the emission, once; other routes record the root
alone; the expansion called outside a root records nothing; `bulk_count`'s
spans stay as they were; the answers are the same recording or not. The
`cuda` case holds the device stamps on the card. The JAX package has no
spans: nothing here imports it."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.exec import bulk
from ccve_tpu_torch.kernels import bigsort, pairsort
from ccve_tpu_torch.ops import sort_merge as sm
from ccve_tpu_torch.ops.hash_table import build_csr, build_lp
from ccve_tpu_torch.utils import profiler

LEVEL = ["expand.narrow", "expand.merge", "expand.candidates", "expand.compact",
         "expand.emit"]
COUNT = ["count.build_stream", "count.narrow", "count.sort_runs", "count.merge_counts"]


@pytest.fixture
def rec(monkeypatch):
    monkeypatch.setattr(pairsort, "TILE_LOG", 6)  # several tiles and merge levels
    monkeypatch.setattr(bigsort, "TILE_LOG", 6)
    r = profiler.Spans.get()
    r.clear()
    yield r
    r.clear()


@pytest.fixture
def opened(monkeypatch):
    """(name, follows) of every span opened, recorded or not."""
    calls = []
    real = profiler.span

    def spy(name, device=None, follows=False):
        calls.append((name, follows))
        return real(name, device=device, follows=follows)

    monkeypatch.setattr(profiler, "span", spy)
    return calls


def _case(n_build=1000, n_probe=5000, levels=1, wide=False, seed=3, device="cpu"):
    """Config 1's shape: unique keys in a seeded order (`wide`: spread over
    2^40, beyond the int32 kernel route), probes of their keys and misses."""
    rng = np.random.default_rng(seed)
    stride = (1 << 30) if wide else 1
    keys = rng.permutation(n_build).astype(np.int64) * stride
    pays = np.arange(n_build, dtype=np.int64) + 10**7
    table = sm.build_sorted(keys, pays, device=device)
    probe = np.stack([rng.choice(keys, n_probe) + rng.integers(0, 2, n_probe)
                      for _ in range(levels)], axis=1)
    return [table] * levels, torch.from_numpy(probe).to(device), (keys, pays)


def _rows(out):
    return sorted(map(tuple, out.tolist()))


def _materialize(tables, probe):
    return bulk.bulk_materialize(tables, probe, PayloadMode.FULL)


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_root_and_its_children_in_order(rec, opened, how, monkeypatch):
    monkeypatch.setattr(profiler.Spans, "EVERY", 1)
    tables, probe, _ = _case()
    if how == "recording":
        with profiler.Spans.recording():
            for _ in range(2):
                _materialize(tables, probe)
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                _materialize(tables, probe)
        # no span became a profiler annotation
        assert not [e.name for e in prof.events() if e.name.startswith(("bulk.", "expand."))]
    queries = rec.snapshot()
    assert len(queries) == 2 and queries[0][0].query != queries[1][0].query
    for root, *children in queries:
        assert root.name == "bulk.materialize" and root.parent is None
        assert [s.name for s in children] == LEVEL
        assert all(s.parent == root.id and s.query == root.query for s in children)
        assert all(s.device_ms is None for s in [root] + children)  # the CPU: host stamps only
        ends = [s.host_ns for s in children]
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
        assert root.host_ns[0] <= ends[0][0] and ends[-1][1] <= root.host_ns[1]
        assert 0 < profiler.self_host_ms([root] + children) < root.host_ms
    # the first step of a level starts on its own stamp, each later one at
    # the previous one's end
    one = [("bulk.materialize", False), (LEVEL[0], False)] + [(name, True) for name in LEVEL[1:]]
    assert opened == one * 2


def test_each_level_records_its_steps(rec, opened):
    tables, probe, _ = _case(n_probe=2000, levels=2)
    with profiler.Spans.recording():
        _materialize(tables, probe)
    (q,) = rec.snapshot()
    assert [s.name for s in q] == ["bulk.materialize"] + LEVEL * 2
    assert {s.parent for s in q[1:]} == {q[0].id}
    assert [f for _, f in opened] == [False] + ([False] + [True] * 4) * 2


@pytest.mark.parametrize("route", ["wide", "lp", "csr", "empty"])
def test_other_routes_record_the_root_alone(rec, route):
    tables, probe, (keys, pays) = _case(n_build=300, n_probe=1000, wide=route == "wide")
    if route in ("lp", "csr"):
        tables = [(build_lp if route == "lp" else build_csr)(keys, pays, device="cpu")]
    elif route == "empty":
        empty = np.zeros(0, np.int64)
        tables = [sm.build_sorted(empty, empty, device="cpu")]
    off = _rows(_materialize(tables, probe))
    with profiler.Spans.recording():
        on = _rows(_materialize(tables, probe))
    assert on == off
    (q,) = rec.snapshot()
    assert [s.name for s in q] == ["bulk.materialize"]


def test_the_expansion_outside_a_root_records_nothing(rec):
    tables, probe, _ = _case(n_probe=2000)
    table, col = tables[0], probe[:, 0]
    with profiler.Spans.recording():
        sm.sorted_expand(table, col, col.numel())
        sm.sorted_expand_tiled(table, col, tile_rows=700)
        sm.expand_candidates(table, col)
        sm.expand_compacted(table, col)
        sm.merged_stream(table, col, spans=True)
    assert rec.snapshot() == [] and rec.queries == 0


def test_bulk_counts_spans_are_unchanged(rec):
    """The count side keeps its four steps; the stats side, which shares
    `merged_stream` with the expansion, records none under `bulk.count`."""
    tables, probe, _ = _case(n_probe=20000)
    with profiler.Spans.recording():
        bulk.bulk_count(tables, probe)
        _materialize(tables, probe)
        bulk.bulk_count(tables * 2, torch.cat([probe, probe], dim=1))
    names = [[s.name for s in q] for q in rec.snapshot()]
    assert names == [["bulk.count"] + COUNT, ["bulk.materialize"] + LEVEL, ["bulk.count"]]


@pytest.mark.parametrize("levels", [1, 2])
def test_answers_are_the_same_recording_or_not(rec, levels):
    tables, probe, _ = _case(n_probe=3000, levels=levels)
    off = _rows(_materialize(tables, probe))
    with profiler.Spans.recording():
        on = _rows(_materialize(tables, probe))
    assert on == off and len(on) > 0


@pytest.mark.cuda
def test_device_intervals_follow_in_order_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the device stamps are CUDA events)")
    rec = profiler.Spans.get()
    rec.clear()
    tables, probe, _ = _case(n_build=100_000, n_probe=1_000_000, device="cuda")
    off = _rows(_materialize(tables, probe[:20_000]))
    with profiler.Spans.recording():
        on = _rows(_materialize(tables, probe[:20_000]))
        for _ in range(3):
            _materialize(tables, probe)
    assert on == off
    queries = rec.snapshot()
    rec.clear()
    assert len(queries) == 4
    for root, *children in queries:
        assert [s.name for s in children] == LEVEL
        assert root.device_ms[0] == 0.0
        for s in children:
            assert s.device_ms[1] >= s.device_ms[0] >= 0.0
        # each step after the first starts at the previous one's end stamp
        assert [s.device_ms[0] for s in children[1:]] == [s.device_ms[1] for s in children[:-1]]
        assert root.device_ms[1] == children[-1].device_ms[1]
    for _, *children in queries[1:]:
        assert all(s.device_interval_ms > 0 for s in children)
