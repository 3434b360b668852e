"""The LP ladder's spans and counters (`exec.bulk.lp_match_stats`,
`utils.profiler.count`): a one-level `bulk_count` over an `LPTable`
records `lp.first`, `lp.ladder` and `lp.tail` under its root, the ladder's
stages count their widths and live lanes, the root counts the fallbacks,
and a full-hits probe that overflows the first stage records
`lp.fallback`; the answers equal the benchmark's plain reference
(`benchmark/reference/count_lp.py`) and the full-width drain's, recording
or not. `count` off is the same two-flag check as `span`. The `cuda` case
holds the device stamps on the card. The JAX package has no spans:
nothing here imports it."""

import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.manifest import plugin
from ccve_tpu_torch.exec import bulk
from ccve_tpu_torch.ops.hash_table import build_lp
from ccve_tpu_torch.utils import profiler

reference = plugin("reference", "count_lp")

STEPS = ["lp.first", "lp.ladder", "lp.tail"]
# a ladder-sized case: 2^18 probes take the four stages the card's 2^27 do
# (caps n/2 .. n/16), 1 in 16 of them hits, as in the benchmark's cell
N_BUILD, N_PROBE, PROBE_SPAN = 1 << 12, 1 << 18, 1 << 16
WIDTHS = [N_PROBE >> k for k in (1, 2, 3, 4)]


@pytest.fixture
def rec():
    r = profiler.Spans.get()
    r.clear()
    yield r
    r.clear()


def _case(seed=5, full_hits=False, device="cpu"):
    """A table of N_BUILD keys 0 .. N_BUILD - 1 in a seeded order,
    payloads row + 10^7, and N_PROBE probes uniform in [0, PROBE_SPAN)
    (`full_hits`: in [0, N_BUILD))."""
    gen = torch.Generator().manual_seed(seed)
    keys = torch.randperm(N_BUILD, generator=gen)
    payloads = torch.arange(N_BUILD) + 10_000_000
    hi = N_BUILD if full_hits else PROBE_SPAN
    probe = torch.randint(0, hi, (N_PROBE, 1), generator=gen)
    table = build_lp(keys.numpy(), payloads.numpy(), device=device)
    return table, [(keys, payloads)], probe.to(device)


def _answer(r):
    return int(r["count"]), [int(v) for v in r["payload_checksums"].reshape(-1).tolist()]


def _port(table, probe):
    r = bulk.bulk_count([table], probe)
    return _answer({"count": r.count, "payload_checksums": r.payload_checksums})


@pytest.mark.parametrize("seed", [5, 2**31 + 11, 2**33 + 3])
def test_ladder_answer_equals_the_reference_and_the_full_width_drain(seed):
    table, build, probe = _case(seed)
    got = _port(table, probe)
    assert got == _answer(reference.answer(build, probe))
    full = bulk.combine_levels(
        [bulk.lp_match_stats(table, probe[:, 0], compact_lanes=False)])
    assert got == _answer({"count": full.count, "payload_checksums": full.payload_checksums})
    # about 1 in 16 probes hit
    assert 0.055 * N_PROBE < got[0] < 0.07 * N_PROBE


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_the_ladders_steps_are_children_of_the_root_in_order(rec, how, monkeypatch):
    monkeypatch.setattr(profiler.Spans, "EVERY", 1)
    table, build, probe = _case()
    if how == "recording":
        with profiler.Spans.recording():
            answers = [_port(table, probe) for _ in range(2)]
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            answers = [_port(table, probe) for _ in range(2)]
        assert not [e.name for e in prof.events() if e.name.startswith(("bulk.", "lp."))]
    assert answers == [_answer(reference.answer(build, probe))] * 2
    queries = rec.snapshot()
    assert len(queries) == 2
    for root, *children in queries:
        assert root.name == "bulk.count" and root.counters == {"fallbacks": 0}
        assert [s.name for s in children] == STEPS
        assert all(s.parent == root.id and s.query == root.query for s in children)
        ends = [s.host_ns for s in children]
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
        first, ladder, tail = children
        assert first.counters == {} and tail.counters == {}
        assert set(ladder.counters) == {"stage_width", "stage_live"}
        width, live = ladder.counters["stage_width"], ladder.counters["stage_live"]
        assert width == sum(WIDTHS) and 0 < live <= width
        assert 0.3 < live / width < 0.7  # the compacted chunks' fill
        assert all(type(v) is int for v in ladder.counters.values())


def test_stage_live_is_each_stages_survivors_clamped_to_its_width(rec):
    """The ladder's `stage_live` totals the live lanes each stage keeps: the
    lanes still live after the step before it, each stage's count clamped
    to its width, as a plain step-by-step drain of the same probes finds."""
    table, _, probe = _case(seed=9)
    keys = probe[:, 0]
    mask = table.n_slots - 1
    cursor = bulk.HASH_PLAIN.hash(keys) & mask
    live = torch.ones(N_PROBE, dtype=torch.bool)
    want = 0
    for width in WIDTHS:
        _, _, live, cursor = bulk._lp_step(table, keys, cursor, live)
        want += min(int(live.sum()), width)
    with profiler.Spans.recording():
        bulk.bulk_count([table], probe)
    ((_, _, ladder, _),) = rec.snapshot()
    assert ladder.counters == {"stage_width": sum(WIDTHS), "stage_live": want}


def test_full_hits_overflow_the_first_stage_and_fall_back(rec):
    table, build, probe = _case(full_hits=True)
    with profiler.Spans.recording():
        got = _port(table, probe)
    assert got == _answer(reference.answer(build, probe)) and got[0] == N_PROBE
    ((root, *children),) = rec.snapshot()
    assert [s.name for s in children] == STEPS + ["lp.fallback"]
    assert root.counters == {"fallbacks": 1}
    # every lane survives step 0, so the first stage holds all it can
    assert children[1].counters["stage_live"] >= WIDTHS[0]


@pytest.mark.parametrize("full_hits", [False, True], ids=["1 in 16 hits", "full hits"])
def test_answers_are_the_same_recording_or_not(rec, full_hits):
    table, _, probe = _case(seed=7, full_hits=full_hits)
    off = _port(table, probe)
    with profiler.Spans.recording():
        on = _port(table, probe)
    assert on == off and len(rec.snapshot()) == 1


def test_small_probes_take_the_full_width_drain_and_record_the_root_alone(rec):
    table, build, probe = _case()
    probe = probe[: 1 << 12]
    with profiler.Spans.recording():
        got = _port(table, probe)
    assert got == _answer(reference.answer(build, probe))
    ((root,),) = rec.snapshot()
    assert root.name == "bulk.count" and root.counters == {}


def test_count_off_allocates_nothing_and_returns_at_once(rec, monkeypatch):
    def reached(*args):
        raise AssertionError("count went past the flags while the recorder was off")

    monkeypatch.setattr(profiler._RECORDER, "_count", reached)
    value = torch.zeros((), dtype=torch.int64)
    profiler.count("warm", 1)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(100):
            assert profiler.count("stage_live", value) is None
            assert profiler.count("stage_width", 8192) is None
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.size_diff > 0 and d.traceback[0].filename == profiler.__file__]
    assert grown == []
    assert rec.snapshot() == [] and rec.queries == 0


def test_counts_outside_a_recorded_query_are_dropped(rec, monkeypatch):
    monkeypatch.setattr(profiler.Spans, "EVERY", 4)
    with profiler.Spans.recording():
        profiler.count("stage_live", 3)  # no query open
    assert rec.snapshot() == []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):  # one query in EVERY is recorded: the third
            with profiler.span("bulk.count", device="cpu"):
                profiler.count("fallbacks", 1)
                with profiler.span("lp.first"):
                    profiler.count("stage_live", 2)
    queries = rec.snapshot()
    assert [q[0].query for q in queries] == [2]
    (root, first), = queries
    assert root.counters == {"fallbacks": 1} and first.counters == {"stage_live": 2}


def test_counters_sum_ints_and_tensors_in_the_innermost_span(rec):
    with profiler.Spans.recording():
        with profiler.span("bulk.count", device="cpu"):
            profiler.count("fallbacks", 0)
            with profiler.span("lp.ladder"):
                for k in range(3):
                    profiler.count("stage_width", 100)
                    profiler.count("stage_live", torch.tensor(10 * k + 1))
                with profiler.span("inner"):
                    profiler.count("stage_live", 1000)
            profiler.count("fallbacks", torch.tensor(True))
    ((root, ladder, inner),) = rec.snapshot()
    assert root.counters == {"fallbacks": 1}
    assert ladder.counters == {"stage_width": 300, "stage_live": 33}
    assert inner.counters == {"stage_live": 1000} and inner.parent == ladder.id


@pytest.mark.cuda
def test_device_intervals_of_the_ladder_nest_in_order_on_the_card(rec):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the device stamps are CUDA events)")
    table, build, probe = _case(device="cuda")
    off = _port(table, probe)
    with profiler.Spans.recording():
        on = [_port(table, probe) for _ in range(3)]
    assert on == [off] * 3 == [_answer(reference.answer(
        [(k.cuda(), p.cuda()) for k, p in build], probe))] * 3
    queries = rec.snapshot()
    assert len(queries) == 3
    for root, *children in queries:
        assert [s.name for s in children] == STEPS and root.counters == {"fallbacks": 0}
        assert root.device_ms[0] == 0.0
        # the ladder and the tail start at the previous step's end stamp
        assert [s.device_ms[0] for s in children[1:]] == [s.device_ms[1] for s in children[:-1]]
        assert all(s.device_interval_ms > 0 for s in children)
        assert children[-1].device_ms[1] <= root.device_ms[1]
        assert 0 < children[1].counters["stage_live"] <= sum(WIDTHS)
