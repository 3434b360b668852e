"""A rehearsal of a run on the CPU at a tiny size: the port's plain path
through the harness's set-up, closed loop, answer read, trace and
judgement; the control and each fault have to come out as not correct."""

import subprocess
import sys
import time

import pytest
import torch

from benchmark import data, judge
from benchmark.faults import FAULTS
from benchmark.harness import run_cell
from benchmark.manifest import ROOT, plugin
from benchmark.tests.tiny import CONFIGS, tiny


def _run(name, traced=False, wrap=None, seconds=0.3, seed=2**31 + 17):
    return run_cell(tiny(name), seed, seconds, traced, "cpu", time.perf_counter(),
                    wrap=wrap, log=lambda msg: None)


@pytest.mark.parametrize("name", CONFIGS)
def test_rehearsal_end_to_end(name):
    r = _run(name)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    names = {m["name"] for m in tiny(name).end_to_end}
    assert set(r["metrics"]) == names and "setup_s" in names and len(names) >= 2
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert {c["value"] for c in r["checks"].values()} == {0}
    assert r["device"]["count"] == 1


@pytest.mark.parametrize("name", CONFIGS)
def test_rehearsal_traced(name):
    r = _run(name, traced=True)
    assert r["correct"] is True
    assert "breakdown" in r and r["breakdown"]["idle_gaps"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    # no device on the CPU: the device's readers find nothing to read
    assert not {"kernel_ms", "idle_pct", "kernel_roofline"} & {
        k.split(".")[0] for k in r["metrics"]}


@pytest.mark.parametrize("name", CONFIGS)
def test_port_answer_equals_reference(name):
    cell = tiny(name)
    inputs = data.make_inputs(cell.config, cell.mix, 5, "cpu")
    query = plugin("queries", "count")
    reference = plugin("reference", "count")
    tables = query.prepare(inputs.build, "cpu")
    fields = cell.mix["answer"]
    for batch in inputs.pool:
        got = judge.as_ints(query.call(tables, batch), fields)
        assert got == judge.as_ints(reference.answer(inputs.build, batch), fields)
        assert got["count"][0] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CONFIGS)
def test_control_and_faults_are_caught(name, fault):
    r = _run(name, wrap=FAULTS[fault])
    assert r["correct"] is False
    assert r["failed"] == r["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_inputs_follow_the_seed(name):
    cell = tiny(name)

    def make(seed):
        inputs = data.make_inputs(cell.config, cell.mix, seed, "cpu")
        return [t for pair in inputs.build for t in pair] + inputs.pool, inputs.start

    a, start_a = make(2**31 + 5)
    b, start_b = make(2**31 + 5)
    c, _ = make(-(2**31) - 6)
    assert start_a == start_b and all(torch.equal(x, y) for x, y in zip(a, b))
    assert [x.shape for x in a] == [x.shape for x in c]
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    pool = a[2 * len(cell.config["build"]):]
    assert len({tuple(p.reshape(-1).tolist()) for p in pool}) == len(pool)


def test_permutation_keys_are_unique_and_payloads_follow_the_row():
    cell = tiny("config1")
    (keys, pays), = data.make_inputs(cell.config, cell.mix, 3, "cpu").build
    assert sorted(keys.tolist()) == list(range(keys.numel()))
    assert pays.tolist() == [r + 10_000_000 for r in range(keys.numel())]


def test_judge_reads_every_field():
    refs = [{"count": [5], "payload_checksums": [7, 8]}]
    ok = [(0, {"count": [5], "payload_checksums": [7, 8]})]
    bad = ok + [(0, {"count": [5], "payload_checksums": [7, 9]})]
    fields = ["count", "payload_checksums"]
    assert judge.passed(judge.checks(ok, refs, fields))
    c = judge.checks(bad, refs, fields)
    assert not judge.passed(c)
    assert c["wrong_answers"]["value"] == 1 and c["payload_checksums_gap"]["value"] == 1
    with pytest.raises(ValueError):
        judge.checks([(0, {"count": [5], "payload_checksums": [7]})], refs, fields)


def test_run_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "config1_count", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode == 2 and p.stdout == ""
