"""The port's span recorder (`utils.profiler.span`, `Spans`) on the count
side of `bulk_count`: off, it hands back one shared object and records
nothing; on (`Spans.recording()`, or one query in `Spans.EVERY` in a
torch.profiler session), it records one root a call with the count
side's four steps as children (on int32 and int64 streams alike: the
tile sort narrows and pads the probe column as it loads it, so there is
no padding step), a root's self time free of the recorder's own work, the
store's cap, and the same answers as with it off; the stream packers
enqueue the count side's first steps in its order where it packs the
probe column itself, and on the tile route it tags the build stream and
hands the column to `sort_runs_narrowed` or `sort_runs_narrowed_i64`. The
`cuda` case holds the device stamps on the card. The JAX package has no
spans: nothing here imports it."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from ccve_tpu_torch.exec import bulk
from ccve_tpu_torch.kernels import bigsort, merge_scan
from ccve_tpu_torch.ops import sort_merge as sm
from ccve_tpu_torch.utils import profiler

STEPS = ["count.build_stream", "count.narrow", "count.sort_runs", "count.merge_counts"]
TILE_LOG = 6  # so that a few thousand probes take the tile route's ladder


@pytest.fixture
def rec():
    r = profiler.Spans.get()
    r.clear()
    yield r
    r.clear()


@pytest.fixture
def tiles(monkeypatch):
    monkeypatch.setattr(bigsort, "TILE_LOG", TILE_LOG)


def _case(n_build=1000, n_probe=20000, wide=False, levels=1, seed=3, device="cpu"):
    """`levels` tables of `n_build` unique keys (`wide`: spread over 2^32,
    so the count side takes int64 streams) and probes of their keys and
    their keys + 1."""
    rng = np.random.default_rng(seed)
    stride, base = ((1 << 22), 2**40) if wide else (1, 0)
    tables = []
    for _ in range(levels):
        keys = rng.permutation(n_build).astype(np.int64) * stride + base
        tables.append(sm.build_sorted(keys, keys % 1009 + 10**7, device=device))
    probe = torch.from_numpy(np.stack(
        [rng.choice(t.keys.cpu().numpy(), n_probe) + rng.integers(0, 2, n_probe)
         for t in tables], axis=1))
    return tables, probe.to(device)


def _answer(r):
    return int(r.count), r.payload_checksums.tolist()


def test_off_hands_back_one_shared_object(rec, tiles):
    assert profiler.span("count.narrow") is profiler.NO_SPAN
    assert profiler.span("bulk.count", device="cpu") is profiler.NO_SPAN
    with profiler.span("bulk.count", device="cpu", follows=True) as s:
        pass
    assert s is profiler.NO_SPAN
    tables, probe = _case()
    bulk.bulk_count(tables, probe)
    assert rec.snapshot() == [] and rec.queries == 0 and rec.dropped == 0


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_one_root_a_call_and_four_children_in_order(rec, tiles, how, monkeypatch):
    monkeypatch.setattr(profiler.Spans, "EVERY", 1)
    tables, probe = _case()
    if how == "recording":
        with profiler.Spans.recording():
            for _ in range(2):
                bulk.bulk_count(tables, probe)
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                bulk.bulk_count(tables, probe)
        # no span became a profiler annotation
        assert not [e.name for e in prof.events() if e.name.startswith(("bulk.", "count."))]
    queries = rec.snapshot()
    assert len(queries) == 2 and queries[0][0].query != queries[1][0].query
    for q in queries:
        root, *children = q
        assert root.name == "bulk.count" and root.parent is None
        assert [s.name for s in children] == STEPS
        assert all(s.parent == root.id and s.query == root.query for s in children)
        assert all(s.device_ms is None for s in q)  # the CPU: host stamps only
        ends = [s.host_ns for s in children]
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
        assert root.host_ns[0] <= ends[0][0] and ends[-1][1] <= root.host_ns[1]


def test_tile_rows_slices_nest_under_one_root(rec, tiles):
    tables, probe = _case(n_probe=20000)
    with profiler.Spans.recording():
        got = bulk.bulk_count(tables, probe, tile_rows=10000)
    (q,) = rec.snapshot()
    assert [s.name for s in q] == ["bulk.count"] + STEPS * 2
    assert {s.parent for s in q[1:]} == {q[0].id}
    assert _answer(got) == _answer(bulk.bulk_count(tables, probe))


@pytest.mark.parametrize("recording", [False, True], ids=["profiler", "profiler and recording"])
def test_a_profiler_session_records_one_query_in_every(rec, tiles, monkeypatch, recording):
    monkeypatch.setattr(profiler.Spans, "EVERY", 3)
    tables, probe = _case(n_probe=9000)
    with profile(activities=[ProfilerActivity.CPU]):
        if recording:
            with profiler.Spans.recording():
                answers = [_answer(bulk.bulk_count(tables, probe)) for _ in range(7)]
        else:
            answers = [_answer(bulk.bulk_count(tables, probe)) for _ in range(7)]
    assert answers == [_answer(bulk.bulk_count(tables, probe))] * 7
    queries = rec.snapshot()
    assert [q[0].query for q in queries] == (list(range(7)) if recording else [1, 4])
    assert all([s.name for s in q] == ["bulk.count"] + STEPS for q in queries)
    assert rec.queries == 7 and rec.dropped == 0


def test_self_time_is_the_root_less_its_children(rec, tiles):
    tables, probe = _case()
    with profiler.Spans.recording():
        bulk.bulk_count(tables, probe, tile_rows=12000)
    (q,) = rec.snapshot()
    children = sum(s.host_ns[1] - s.host_ns[0] for s in q[1:])
    want = (q[0].host_ns[1] - q[0].host_ns[0] - children) * 1e-6
    assert profiler.self_host_ms(q) == pytest.approx(want)
    assert 0 < profiler.self_host_ms(q) < q[0].host_ms


def test_self_time_leaves_out_the_recorders_own_work(rec, tiles, monkeypatch):
    """The recorder's work to open a span, slowed by SLOW_S, lands in the
    child's host interval or before its root's start, never in the root's
    self time."""
    SLOW_S = 0.05
    real = profiler._RECORDER._open

    def slow_open(*args):
        s = real(*args)
        time.sleep(SLOW_S)
        return s

    monkeypatch.setattr(profiler._RECORDER, "_open", slow_open)
    tables, probe = _case()
    with profiler.Spans.recording():
        bulk.bulk_count(tables, probe)
    (q,) = rec.snapshot()
    assert all(s.host_ms >= SLOW_S * 1e3 for s in q[1:])
    assert profiler.self_host_ms(q) < SLOW_S * 1e3


def test_the_cap_drops_whole_queries_and_counts_them(rec, tiles, monkeypatch):
    monkeypatch.setattr(profiler.Spans, "CAP", 2)
    tables, probe = _case(n_probe=9000)
    with profiler.Spans.recording():
        for _ in range(5):
            bulk.bulk_count(tables, probe)
    queries = rec.snapshot()
    assert len(queries) == 2 and rec.dropped == 3 and rec.queries == 5
    assert [len(q) for q in queries] == [5, 5]
    rec.clear()
    assert rec.snapshot() == [] and rec.dropped == 0 and rec.queries == 0


def test_spans_outside_a_query_are_not_recorded(rec, tiles):
    tables, probe = _case(n_probe=9000)
    with profiler.Spans.recording():
        assert profiler.span("count.narrow") is profiler.NO_SPAN
        p, b = sm.pack32_streams(tables[0], probe[:, 0])
        sm._count_side(tables[0], probe[:, 0])
        sm.sorted_build_counts(tables[0], probe[:, 0])
    assert rec.snapshot() == []


@pytest.mark.parametrize("case", ["int32 streams", "int64 streams", "two levels",
                                  "small probe"])
def test_answers_are_the_same_recording_or_not(rec, tiles, case):
    kw = {"int32 streams": {}, "int64 streams": {"wide": True}, "two levels": {"levels": 2},
          "small probe": {"n_probe": 300}}[case]
    tables, probe = _case(**kw)
    assert (tables[0].pack32 is None) == (case == "int64 streams")
    off = _answer(bulk.bulk_count(tables, probe))
    with profiler.Spans.recording():
        on = _answer(bulk.bulk_count(tables, probe))
    assert on == off
    (q,) = rec.snapshot()
    names = [s.name for s in q]
    if case in ("int32 streams", "int64 streams"):  # no padding step on either
        assert names == ["bulk.count"] + STEPS
    elif case == "two levels":  # the multi-level path records its root alone
        assert names == ["bulk.count"]
    else:
        assert names == ["bulk.count", "count.build_stream", "count.narrow"]


@pytest.mark.parametrize("n_probe", [19968, 20000], ids=["whole tiles", "a part tile"])
def test_int64_streams_pad_in_a_step_of_their_own(rec, tiles, n_probe):
    """On int64 streams the narrowing and the padding to whole tiles are
    no steps of their own: `count.sort_runs`, whose tile sort narrows and
    pads the probe column as it loads it, comes right after `count.narrow`
    (the build stream's `| 1`), on whole tiles and on a part tile, and no
    `count.pad` is recorded; the answer is the plain `searchsorted` count
    and checksum's."""
    tables, probe = _case(n_probe=n_probe, wide=True)
    assert tables[0].pack32 is None
    with profiler.Spans.recording():
        got = _answer(bulk.bulk_count(tables, probe))
    (q,) = rec.snapshot()
    names = [s.name for s in q]
    assert "count.pad" not in names
    assert names.index("count.sort_runs") == names.index("count.narrow") + 1
    keys, pays = tables[0].keys, tables[0].payloads
    col = probe[:, 0]
    lo = torch.searchsorted(keys, col, right=False)
    hi = torch.searchsorted(keys, col, right=True)
    prefix = torch.cat([pays.new_zeros(1), pays.cumsum(0)])
    assert got == (int((hi - lo).sum()), [int((prefix[hi] - prefix[lo]).sum())])


class _Ops(TorchDispatchMode):
    """The aten ops called inside, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("wide", [False, True], ids=["int32 streams", "int64 streams"])
def test_stream_packers_are_the_count_sides_first_steps(rec, tiles, wide):
    """Where the count side packs the probe column itself (int32 streams
    on the small-probe route), the packers are its first steps, in its
    order. On the tile route (int64 streams at any length, int32 streams
    above 2^SMALL_PROBE_LOG) it tags the build stream alone and hands the
    raw column to `sort_runs_narrowed` or `sort_runs_narrowed_i64`, which
    narrows it in its load. Every answer is the packers' composition's:
    through `_count_side_bc` on the small-probe route, else through
    `sort_runs` of the padded packed stream and the merge counts."""
    tables, probe = _case(wide=wide)
    table, col = tables[0], probe[:, 0].contiguous()
    m = table.keys.numel()
    pack = sm.pack64_streams if wide else sm.pack32_streams
    for c in (col, col[: 1 << sm.SMALL_PROBE_LOG]):
        with _Ops() as packed:
            p, b = pack(table, c)
        with _Ops() as whole:
            got = sm._count_side(table, c)
        if not wide and c.numel() <= 1 << sm.SMALL_PROBE_LOG:
            assert torch.equal(got, sm._count_side_bc(p, b, m))
            assert len(packed.names) >= 5 and whole.names[: len(packed.names)] == packed.names
            continue
        n_pad, run_log = sm.count_side_plan(c.numel(), m, TILE_LOG)
        pad = p.new_full((n_pad - p.numel(),), bigsort.PAD[p.dtype])
        runs = bigsort.sort_runs(torch.cat([p, pad]), run_log, TILE_LOG)
        assert torch.equal(got, merge_scan.merge_counts_plain(runs, 1 << run_log, c.numel(), b, m))
        if wide:
            assert torch.equal(got, sm._count_side_bc(p, b, m))
        with _Ops() as steps:
            if wide:
                (sm._build_key64(table) | 1).contiguous()
                bigsort.sort_runs_narrowed_i64(c, *sm._wide_bounds(table), n_pad, run_log,
                                               TILE_LOG)
            else:
                (sm._build_key32(table) | 1).contiguous()
                bigsort.sort_runs_narrowed(c, *sm._narrow_bounds(table), n_pad, run_log,
                                           TILE_LOG)
        assert len(steps.names) >= 5 and whole.names[: len(steps.names)] == steps.names


@pytest.mark.cuda
def test_device_intervals_nest_in_order_on_the_card(rec):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the device stamps are CUDA events)")
    tables, probe = _case(n_build=100_000, n_probe=1_000_000, device="cuda")
    off = _answer(bulk.bulk_count(tables, probe))
    with profiler.Spans.recording():
        on = [_answer(bulk.bulk_count(tables, probe)) for _ in range(3)]
    assert on == [off] * 3
    queries = rec.snapshot()
    assert len(queries) == 3
    for root, *children in queries:
        assert [s.name for s in children] == STEPS
        assert root.device_ms[0] == 0.0
        edges = [root.device_ms[0]]
        for s in children:
            assert s.device_ms[0] >= edges[-1] and s.device_ms[1] >= s.device_ms[0]
            edges.append(s.device_ms[1])
        assert edges[-1] <= root.device_ms[1]
        # the three steps that follow start at the previous one's end stamp
        assert [s.device_ms[0] for s in children[1:]] == [s.device_ms[1] for s in children[:-1]]
        assert children[2].device_interval_ms > 0 and children[3].device_interval_ms > 0
