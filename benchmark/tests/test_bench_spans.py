"""The `program_span` readers (`benchmark/spans.py` and the metrics that
read the port's spans) on hand-made snapshots lined up with a run's
phases by the queries' ids, with nothing recorded, and in the tiny traced
rehearsal on the CPU, where the spans have no device stamps."""

import time

import pytest

from benchmark import spans
from benchmark.harness import Run, run_cell
from benchmark.manifest import reader
from benchmark.tests.tiny import tiny
from ccve_tpu_torch.utils import profiler
from ccve_tpu_torch.utils.profiler import SpanRecord

DEVICE = ["build_stream_host_paced_ms", "narrow_ms", "sort_runs_ms", "merge_counts_ms"]
STEPS = ["count.build_stream", "count.narrow", "count.sort_runs", "count.merge_counts"]


def _run(phase):
    return Run(setup_s=1.0, window_s=1.0, rows=1, latency_ms=[1.0] * len(phase),
               phase=phase, entry_ms=[0.5] * len(phase), syncs=[], least_bytes=1,
               peak_bytes_per_s=None, trace=None)


def _query(qid, scale, device=True):
    """A root of 1 ms on the host and four children of scale * (1, 2, 3,
    4) ms, each as long on the device, back to back."""
    root = SpanRecord("bulk.count", qid * 10, None, qid, (0, 10**6),
                      (0.0, 11.0 * scale) if device else None)
    out, t = [root], 0.0
    for k, name in enumerate(STEPS, 1):
        out.append(SpanRecord(name, qid * 10 + k, root.id, qid,
                              (int(t * 1e6), int((t + 0.1 * k * scale) * 1e6)),
                              (t, t + k * scale) if device else None))
        t += k * scale
    return out


@pytest.fixture
def recorded(monkeypatch):
    """Hands the readers a snapshot: set `recorded.queries`, and
    `recorded.opened`, the roots opened (by default the last query's id
    plus one)."""
    rec = profiler.Spans.get()
    rec.clear()

    class Box:
        queries = []
        opened = None

    def snapshot():
        rec.queries = (Box.opened if Box.opened is not None
                       else Box.queries[-1][0].query + 1 if Box.queries else 0)
        return list(Box.queries)

    monkeypatch.setattr(rec, "snapshot", snapshot)
    yield Box
    rec.clear()


def test_readers_take_the_device_stretch_alone(recorded):
    # an earlier run's query, then 3 of the device's stretch, 2 of the host's
    recorded.queries = ([_query(0, 100.0)] + [_query(q, 1.0 + q) for q in (1, 2, 3)]
                        + [_query(q, 50.0) for q in (4, 5)])
    run = _run(["plain"] * 4 + ["trace"] * 3 + ["spans"] * 2 + ["sync"])
    got = {name: reader(name).read(run) for name in DEVICE + ["entry_self_host_ms"]}
    mean_scale = (2.0 + 3.0 + 4.0) / 3
    for k, name in enumerate(DEVICE, 1):
        assert got[name] == pytest.approx(k * mean_scale)
    assert got["entry_self_host_ms"] == pytest.approx(1.0 - 1.0 * mean_scale)
    recorded.queries = []  # read once a run: the recorder was cleared
    assert reader("narrow_ms").read(run) == pytest.approx(2 * mean_scale)


def test_readers_take_the_sampled_queries_by_id(recorded):
    # 8 roots of the device's stretch (ids 2-9), 4 of the host's (10-13),
    # one in three recorded: ids 3, 6 and 9 are the device's stretch's
    recorded.queries = [_query(q, float(q)) for q in (0, 3, 6, 9, 12)]
    recorded.opened = 14
    run = _run(["plain"] * 2 + ["trace"] * 8 + ["spans"] * 4)
    assert [q[0].query for q in spans.trace_queries(run)] == [3, 6, 9]
    assert reader("sort_runs_ms").read(run) == pytest.approx(3 * 6.0)


def test_readers_find_nothing_to_read(recorded):
    run = _run(["plain"] * 4 + ["trace"] * 3 + ["spans"] * 2)
    assert all(reader(n).read(run) is None for n in DEVICE + ["entry_self_host_ms"])
    run = _run(["plain"] * 4 + ["trace"] * 3 + ["spans"] * 2)
    recorded.queries = [_query(q, 1.0) for q in range(4)]  # fewer than the stretches
    assert reader("entry_self_host_ms").read(run) is None
    run = _run(["plain"] * 4 + ["trace"] * 3 + ["spans"] * 2)
    recorded.queries = [_query(q, 1.0) for q in (0, 1, 7, 8)]  # none of the device's
    assert reader("entry_self_host_ms").read(run) is None
    run = _run(["plain"] * 4 + ["trace"] * 3 + ["spans"] * 2)
    recorded.queries = [_query(q, 1.0, device=False) for q in range(5)]  # the CPU
    assert all(reader(n).read(run) is None for n in DEVICE)
    assert reader("entry_self_host_ms").read(run) == pytest.approx(0.0)
    run = _run(["plain"] * 4)  # an untraced run
    recorded.queries = [_query(q, 1.0) for q in range(5)]
    assert spans.trace_queries(run) is None


def test_a_dropped_query_spoils_the_line_up(recorded):
    profiler.Spans.get().dropped = 1
    recorded.queries = [_query(q, 1.0) for q in range(5)]
    assert spans.trace_queries(_run(["trace"] * 3 + ["spans"] * 2)) is None


@pytest.mark.parametrize("name", ["config1", "config3"])
def test_traced_rehearsal_reads_the_host_self_time_alone(name):
    r = run_cell(tiny(name), 2**31 + 3, 0.2, True, "cpu", time.perf_counter(),
                 log=lambda msg: None)
    assert r["correct"] is True
    assert r["metrics"]["entry_self_host_ms"]["value"] > 0
    assert not set(DEVICE) & set(r["metrics"])
    assert profiler.Spans.get().snapshot() == []  # the readers cleared the recorder
