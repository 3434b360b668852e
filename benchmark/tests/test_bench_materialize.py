"""The cell `config1_materialize` rehearsed on the CPU at config1's tiny
size: the harness's set-up, closed loop, answer read, trace and
judgement over query kind `materialize`; the control and each fault come
out as not correct; the port's answer equals the reference's; the digest
tells multisets of rows apart and not their orders; and the cell runs as
new files and new manifest entries, with no benchmark file edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import data, judge, manifest
from benchmark.faults import FAULTS
from benchmark.harness import FORBIDDEN, run_cell
from benchmark.manifest import MANIFEST, ROOT, plugin
from benchmark.tests.tiny import SIZES
from ccve_tpu_torch.utils import profiler

CELL = "config1_materialize"
CONFIG = "config1_full_output"
MIX = "materialize_closed1"
reference = plugin("reference", "materialize")
# the files this cell added to the benchmark
ADDED = ["configs/config1_full_output.json", "traffic/materialize_closed1.json",
         "queries/materialize.py", "reference/materialize.py", "expand_spans.py",
         "metrics/expand_narrow_ms.py", "metrics/expand_merge_ms.py",
         "metrics/expand_candidates_ms.py", "metrics/expand_compact_ms.py",
         "metrics/expand_emit_ms.py", "metrics/materialize_self_host_ms.py",
         "tests/test_bench_materialize.py"]
SPAN_READERS = ["expand_narrow_ms", "expand_merge_ms", "expand_candidates_ms",
                "expand_compact_ms", "expand_emit_ms"]


def tiny(root=ROOT) -> manifest.Cell:
    """The cell with its configuration shrunk to config1's tiny size."""
    body = manifest.load_json(root / "benchmark" / "configs" / f"{CONFIG}.json")
    build_rows, probe_rows, hi = SIZES["config1"]
    body["build"][0]["rows"] = build_rows
    body["probe"]["rows"] = probe_rows
    body["probe"]["columns"][0]["hi"] = hi
    mix = manifest.load_json(root / "benchmark" / "traffic" / f"{MIX}.json")
    mix.update(trace_queries=6, span_queries=4)
    cell = manifest.cell(CELL)
    return manifest.Cell(name=f"{CELL}_tiny", chips=1, config=body, mix=mix,
                         end_to_end=cell.end_to_end, per_layer=cell.per_layer)


def _run(traced=False, wrap=None, seed=2**31 + 41):
    return run_cell(tiny(), seed, 0.3, traced, "cpu", time.perf_counter(), wrap=wrap,
                    log=lambda msg: None)


def test_rehearsal_end_to_end():
    r = _run()
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "rows_per_s", "query_p95_ms"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert set(r["checks"]) == {"wrong_answers", "count_gap", "column_sums_gap",
                                "row_hash_gap"}
    assert {c["value"] for c in r["checks"].values()} == {0}


def test_rehearsal_traced_reads_the_root_alone_on_the_cpu():
    r = _run(traced=True)
    assert r["correct"] is True and r["breakdown"]["idle_gaps"]
    assert r["metrics"]["materialize_self_host_ms"]["value"] > 0
    # no device stamps on the CPU, and no device operations
    assert not set(SPAN_READERS) & set(r["metrics"])
    assert not {"kernel_ms", "idle_pct"} & set(r["metrics"])
    assert profiler.Spans.get().snapshot() == []  # the reader cleared the recorder


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_control_and_faults_are_caught(fault):
    r = _run(wrap=FAULTS[fault])
    assert r["correct"] is False
    assert r["failed"] == r["checks"]["wrong_answers"]["value"] > 0


def test_the_control_differs_in_the_sums_and_not_the_count():
    r = _run(wrap=FAULTS["control"])
    assert r["checks"]["count_gap"]["value"] == 0
    assert r["checks"]["column_sums_gap"]["value"] > 0 and r["checks"]["row_hash_gap"]["value"] > 0


def test_port_answer_equals_reference():
    cell = tiny()
    inputs = data.make_inputs(cell.config, cell.mix, 5, "cpu")
    query = plugin("queries", "materialize")
    tables = query.prepare(inputs.build, "cpu")
    fields = cell.mix["answer"]
    for batch in inputs.pool:
        got = judge.as_ints(query.call(tables, batch), fields)
        assert got == judge.as_ints(reference.answer(inputs.build, batch), fields)
        # every probe key but those past the table's last matches once
        assert got["count"][0] == int((batch[:, 0] < SIZES["config1"][0]).sum())


def test_least_bytes_count_the_output_rows():
    cell = tiny()
    inputs = data.make_inputs(cell.config, cell.mix, 6, "cpu")
    batch = inputs.pool[0]
    rows = reference.rows(inputs.build, batch).shape[0]
    n_build = SIZES["config1"][0]
    want = batch.numel() * 8 + 2 * 8 * n_build + 24 * rows + 40
    assert plugin("queries", "materialize").least_bytes(inputs.build, batch) == want


def _rows(seed=0, n=300):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-(2**62), 2**62, (n, 3), generator=g)


def _digest(rows):
    return judge.as_ints(reference.digest(rows), ["count", "column_sums", "row_hash"])


def test_digest_is_the_same_under_a_permutation():
    rows = _rows()
    perm = torch.randperm(rows.shape[0], generator=torch.Generator().manual_seed(1))
    assert _digest(rows[perm]) == _digest(rows)


@pytest.mark.parametrize("change", ["drop", "duplicate", "probe key", "build key", "payload",
                                    "swap two fields"])
def test_digest_tells_the_rows_apart(change):
    rows = _rows()
    other = rows.clone()
    if change == "drop":
        other = rows[1:]
    elif change == "duplicate":
        other = torch.cat([rows, rows[7:8]])
    elif change == "swap two fields":
        other[3, 1], other[3, 2] = rows[3, 2], rows[3, 1]
    else:
        other[5, ["probe key", "build key", "payload"].index(change)] += 1
    assert _digest(other) != _digest(rows)


def test_digest_blocks_add_up(monkeypatch):
    build = [(torch.tensor([3, 1, 3, 7, 2]), torch.tensor([10, -5, 20, 1, 8]))]
    probe = torch.tensor([[3], [3], [2], [9], [7], [1], [-4], [3]])
    whole = judge.as_ints(reference.answer(build, probe), ["count", "column_sums", "row_hash"])
    monkeypatch.setattr(reference, "BLOCK_ROWS", 3)
    assert judge.as_ints(reference.answer(build, probe),
                         ["count", "column_sums", "row_hash"]) == whole
    rows = reference.rows(build, probe)
    assert sorted(map(tuple, rows.tolist())) == sorted(
        [(3, 3, 10), (3, 3, 20)] * 3 + [(2, 2, 8), (7, 7, 1), (1, 1, -5)])
    assert whole == _digest(rows)


SCRIPT = """
import json, sys, time
from benchmark.harness import run_cell
from benchmark.tests.test_bench_materialize import tiny
for traced in (False, True):
    r = run_cell(tiny(), 3, 0.2, traced, "cpu", time.perf_counter(), log=lambda m: None)
    assert r["correct"], r
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "ccve_tpu_torch" in loaded and not loaded & FORBIDDEN


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _without_cell(m: dict) -> dict:
    """The manifest without this cell: without its entries, and without its
    name in the metrics' lists of cells."""
    ours = {CONFIG, CELL}

    def metrics(group):
        return [dict(e, workloads=[w for w in e["workloads"] if w != CELL])
                if "workloads" in e else e
                for e in m[group] if e.get("workloads") != [CELL]]

    return dict(m, configs=[c for c in m["configs"] if c["name"] not in ours],
                workloads=[w for w in m["workloads"] if w["name"] not in ours],
                end_to_end=metrics("end_to_end"), per_layer=metrics("per_layer"))


def test_the_cell_is_new_files_and_new_entries_at_the_ends(tmp_path):
    """A copy of the benchmark without this cell's files and entries, then
    the cell's files laid over it and its entries appended: the files that
    were there keep their bytes, each list of the manifest keeps its entries
    first, a metric that was there gains at most this cell at the end of its
    list of cells, and the copy runs the cell."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ADDED:
        (tmp_path / "benchmark" / name).unlink()
    before = _digests(tmp_path / "benchmark")
    for name in ADDED:
        shutil.copy(ROOT / "benchmark" / name, tmp_path / "benchmark" / name)
    m = manifest.manifest()
    old = _without_cell(m)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        kept = m[group][: len(old[group])]
        assert _without_cell(dict(m, **{group: kept}))[group] == old[group], group
        # a metric that was there lists this cell last, if at all
        assert all(e["workloads"][-1] == CELL for e in kept if CELL in e.get("workloads", []))
    assert m["workloads"][0]["name"] == "config1_count"
    shutil.copy(ROOT / MANIFEST, tmp_path / MANIFEST)
    env = dict(os.environ, PYTHONPATH=str(ROOT))  # the port, behind the copy
    script = SCRIPT.replace("print(", "assert r['metrics']; print(")
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
