"""The cell `microbench_lp_h16_count` rehearsed on the CPU at a ladder-sized
scale (2^12 build keys, 2^18 probes uniform in [0, 2^16), so 1 in 16 hits
and the LP ladder runs its four stages as at 2^27): the port's tables are
`LPTable`s, its answer equals the reference's, the harness's run is
correct traced and untraced and reads the ladder's counters, the control
and each fault come out as not correct; and the cell is new files and new
manifest entries after the earlier ones."""

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

CELL = "microbench_lp_h16_count"
CONFIG = "microbench_lp_h16"
MIX = "count_lp_closed1"
BUILD_ROWS, PROBE_ROWS, PROBE_HI = 1 << 12, 1 << 18, (1 << 16) - 1
NEW_METRICS = ["lp_first_ms", "lp_ladder_ms", "lp_tail_ms", "lp_stage_occupancy_pct",
               "lp_fallbacks"]
# the files this cell added to the benchmark
ADDED = ["configs/microbench_lp_h16.json", "traffic/count_lp_closed1.json",
         "queries/count_lp.py", "reference/count_lp.py", "counters.py",
         "tests/test_bench_lp.py"] + [f"metrics/{m}.py" for m in NEW_METRICS]
# the cells that were there before this one
EARLIER = ["config1_count", "config1_materialize", "config1_wide_count"]
# the metrics that were there, which now name this cell too
SHARED = ["rows_per_s", "query_p95_ms", "entry_host_ms", "host_syncs", "device_launches",
          "torch_ops_ms", "kernel_ms", "kernel_roofline", "idle_pct", "query_roofline"]
query = plugin("queries", "count_lp")
reference = plugin("reference", "count_lp")


def tiny(root=ROOT) -> manifest.Cell:
    """The cell with its table shrunk to BUILD_ROWS and its batches to
    PROBE_ROWS keys in [0, PROBE_HI]: the hit share (1 in 16) and the
    ladder's four stages stay."""
    body = manifest.load_json(root / "benchmark" / "configs" / f"{CONFIG}.json")
    body["build"][0]["rows"] = BUILD_ROWS
    body["probe"]["rows"] = PROBE_ROWS
    body["probe"]["columns"][0]["hi"] = PROBE_HI
    mix = manifest.load_json(root / "benchmark" / "traffic" / f"{MIX}.json")
    mix.update(trace_queries=6, span_queries=4)
    cell = manifest.cell(CELL)
    return manifest.Cell(name=f"{CELL}_tiny", chips=1, config=body, mix=mix,
                         end_to_end=cell.end_to_end, per_layer=cell.per_layer)


def _inputs(seed):
    cell = tiny()
    return data.make_inputs(cell.config, cell.mix, seed, "cpu")


def _run(traced=False, wrap=None, seed=2**31 + 31):
    return run_cell(tiny(), seed, 0.3, traced, "cpu", time.perf_counter(), wrap=wrap,
                    log=lambda msg: None)


def test_the_configuration_is_the_sources_probe_benchmark():
    body = manifest.load_json(ROOT / "benchmark" / "configs" / f"{CONFIG}.json")
    (table,) = body["build"]
    assert table["rows"] == 128 << 13 and table["keys"] == {"dist": "permutation", "lo": 0}
    assert body["probe"]["rows"] == 1024 << 17
    (column,) = body["probe"]["columns"]
    # rand() & (kRHSTuples * kHitFreq - 1): 1 in 16 probes hit
    assert (column["lo"], column["hi"]) == (0, table["rows"] * 16 - 1)
    assert body["reduced"] == [] and set(body["assumed"]) >= {"scale", "hit_frequency"}


def test_the_tables_are_linear_probing_ones():
    (table,) = query.prepare(_inputs(5).build, "cpu")
    assert type(table).__name__ == "LPTable"
    assert table.n_slots == 4 * BUILD_ROWS


@pytest.mark.parametrize("seed", [3, 2**31 + 1, 2**32 + 5])
def test_port_answer_equals_reference(seed):
    inputs = _inputs(seed)
    tables = query.prepare(inputs.build, "cpu")
    fields = tiny().mix["answer"]
    for batch in inputs.pool:
        got = judge.as_ints(query.call(tables, batch), fields)
        assert got == judge.as_ints(reference.answer(inputs.build, batch), fields)
        assert 0.055 * PROBE_ROWS <= got["count"][0] <= 0.07 * PROBE_ROWS


def test_rehearsal_end_to_end():
    r = _run()
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "rows_per_s", "query_p95_ms"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert {c["value"] for c in r["checks"].values()} == {0}


def test_rehearsal_traced_reads_the_ladders_counters():
    r = _run(traced=True)
    assert r["correct"] is True and r["breakdown"]["idle_gaps"]
    metrics = r["metrics"]
    assert metrics["lp_fallbacks"]["value"] == 0
    assert 40 < metrics["lp_stage_occupancy_pct"]["value"] < 60
    assert metrics["entry_host_ms"]["value"] > 0
    # no device stamps on the CPU, and no device operations
    assert not {"lp_first_ms", "lp_ladder_ms", "lp_tail_ms", "kernel_ms",
                "idle_pct"} & set(metrics)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_control_and_faults_are_caught(fault):
    r = _run(wrap=FAULTS[fault])
    assert r["correct"] is False
    assert r["failed"] == r["checks"]["wrong_answers"]["value"] > 0


def test_least_bytes_is_the_count_querys():
    inputs = _inputs(4)
    want = PROBE_ROWS * 8 + BUILD_ROWS * 16 + 16
    assert query.least_bytes(inputs.build, inputs.pool[0]) == want
    # at full size: 1,090,519,056 B a query
    assert (1024 << 17) * 8 + (128 << 13) * 16 + 16 == 1_090_519_056


def test_the_cell_comes_after_the_earlier_ones():
    """Its configuration, cell and metrics follow those that were there,
    and each metric that was there and names it names it last."""
    m = manifest.manifest()
    configs = [c["name"] for c in m["configs"]]
    assert configs.index(CONFIG) == len(configs) - 1
    assert [w["name"] for w in m["workloads"]].index(CELL) == len(EARLIER)
    per_layer = [e["name"] for e in m["per_layer"]]
    assert per_layer[-len(NEW_METRICS):] == NEW_METRICS
    for e in m["per_layer"][-len(NEW_METRICS):]:
        assert e["workloads"] == [CELL]
    named = [e for e in m["end_to_end"] + m["per_layer"] if CELL in e.get("workloads", [])]
    assert sorted(e["name"] for e in named) == sorted(SHARED + NEW_METRICS)
    for e in named:
        assert e["workloads"][-1] == CELL
        assert all(e["workloads"].index(w) < e["workloads"].index(CELL)
                   for w in EARLIER if w in e["workloads"])


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


SCRIPT = """
import json, sys, time
from benchmark.harness import run_cell
from benchmark.tests.test_bench_lp import tiny
for traced in (False, True):
    r = run_cell(tiny(), 3, 0.2, traced, "cpu", time.perf_counter(), log=lambda m: None)
    assert r["correct"] and r["metrics"], r
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_copy_with_the_cells_files_laid_over_runs_it_and_loads_no_jax(tmp_path):
    """A copy of the benchmark without this cell's files, then its files
    laid over it: the files that were there keep their bytes, and the copy
    runs the cell without loading JAX or the JAX package."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ADDED:
        (tmp_path / "benchmark" / name).unlink()
    before = _digests(tmp_path / "benchmark")
    for name in ADDED:
        shutil.copy(ROOT / "benchmark" / name, tmp_path / "benchmark" / name)
    shutil.copy(ROOT / MANIFEST, tmp_path / MANIFEST)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)  # the port, behind the copy
    p = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "ccve_tpu_torch" in loaded and not loaded & FORBIDDEN
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_the_same_seed_gives_the_same_probes():
    a, b = _inputs(2**31 + 3), _inputs(2**31 + 3)
    assert all(torch.equal(x, y) for x, y in zip(a.pool, b.pool))
    assert not torch.equal(a.pool[0], _inputs(2**31 + 4).pool[0])
