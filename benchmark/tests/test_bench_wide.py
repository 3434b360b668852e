"""The cell `config1_wide_count` rehearsed on the CPU at a tiny size (1,000
build keys over 2^40, 16,000 probes): the distribution `scattered`
follows the seed, its build keys are unique and spread past 2^32, and
half its probes are build keys; the port's table is a wide one, so its
count side takes the int64 streams; the harness's run is correct, the
control and each fault come out as not correct, the port's answer equals
the reference's; and the cell is new files and new manifest entries."""

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

CELL = "config1_wide_count"
CONFIG = "config1_wide"
MIX = "count_closed1"
BUILD_ROWS, PROBE_ROWS = 1000, 16000
# the files this cell added to the benchmark
ADDED = ["configs/config1_wide.json", "dists/scattered.py", "metrics/pad_ms.py",
         "tests/test_bench_wide.py"]
# the cells that were there before this one
EARLIER = ["config1_count", "config1_materialize"]
scattered = plugin("dists", "scattered")
query = plugin("queries", "count")
reference = plugin("reference", "count")


def tiny(root=ROOT) -> manifest.Cell:
    """The cell with its tables shrunk to BUILD_ROWS and PROBE_ROWS; the
    keys' span and the hit share stay."""
    body = manifest.load_json(root / "benchmark" / "configs" / f"{CONFIG}.json")
    body["build"][0]["rows"] = BUILD_ROWS
    body["probe"]["rows"] = PROBE_ROWS
    body["probe"]["columns"][0]["keys"] = BUILD_ROWS
    mix = manifest.load_json(root / "benchmark" / "traffic" / f"{MIX}.json")
    mix.update(trace_queries=6, span_queries=4)
    cell = manifest.cell(CELL)
    return manifest.Cell(name=f"{CELL}_tiny", chips=1, config=body, mix=mix,
                         end_to_end=cell.end_to_end, per_layer=cell.per_layer)


def _inputs(seed):
    cell = tiny()
    return data.make_inputs(cell.config, cell.mix, seed, "cpu")


def _run(traced=False, wrap=None, seed=2**31 + 29):
    return run_cell(tiny(), seed, 0.3, traced, "cpu", time.perf_counter(), wrap=wrap,
                    log=lambda msg: None)


@pytest.mark.parametrize("role", ["build", "probe"])
def test_the_same_seed_gives_the_same_keys(role):
    spec = tiny().config["probe"]["columns"][0] if role == "probe" else {"bits": 40}

    def draw(seed):
        return scattered.draw(torch.Generator().manual_seed(seed), PROBE_ROWS, spec,
                              torch.int64)

    assert torch.equal(draw(2**31 + 3), draw(2**31 + 3))
    assert not torch.equal(draw(2**31 + 3), draw(2**31 + 4))


def test_build_keys_are_unique_and_spread_past_2_32():
    (keys, pays), = _inputs(2**31 + 7).build
    assert keys.dtype == torch.int64 and keys.numel() == BUILD_ROWS
    assert keys.unique().numel() == BUILD_ROWS
    assert int(keys.min()) >= 0 and int(keys.max()) < 2**40 and int(keys.max()) > 2**32
    assert pays.tolist() == [r + 10_000_000 for r in range(BUILD_ROWS)]


@pytest.mark.parametrize("seed", [2**31 + 7, 11])
def test_half_the_probes_are_build_keys(seed):
    inputs = _inputs(seed)
    (keys, _), = inputs.build
    for batch in inputs.pool:
        col = batch[:, 0]
        assert int(col.min()) >= 0 and int(col.max()) < 2**40
        share = torch.isin(col, keys).double().mean().item()
        assert 0.45 <= share <= 0.55
        # the hits reach the table's keys throughout, not a few of them
        assert col[torch.isin(col, keys)].unique().numel() > 0.9 * BUILD_ROWS


def test_the_table_is_wide():
    (table,) = query.prepare(_inputs(5).build, "cpu")
    assert table.pack32 is None and table.span62


def test_rehearsal_end_to_end():
    r = _run()
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "rows_per_s", "query_p95_ms"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert {c["value"] for c in r["checks"].values()} == {0}


def test_rehearsal_traced_has_no_device_readings_on_the_cpu():
    r = _run(traced=True)
    assert r["correct"] is True and r["breakdown"]["idle_gaps"]
    assert r["metrics"]["entry_self_host_ms"]["value"] > 0
    # no device stamps on the CPU, and no device operations
    assert not {"pad_ms", "narrow_ms", "kernel_ms", "idle_pct"} & set(r["metrics"])


@pytest.mark.parametrize("seed", [3, 2**31 + 1, 2**32 + 5])
def test_port_answer_equals_reference(seed):
    inputs = _inputs(seed)
    tables = query.prepare(inputs.build, "cpu")
    fields = tiny().mix["answer"]
    for batch in inputs.pool:
        got = judge.as_ints(query.call(tables, batch), fields)
        assert got == judge.as_ints(reference.answer(inputs.build, batch), fields)
        assert 0.45 * PROBE_ROWS <= got["count"][0] <= 0.55 * PROBE_ROWS


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_control_and_faults_are_caught(fault):
    r = _run(wrap=FAULTS[fault])
    assert r["correct"] is False
    assert r["failed"] == r["checks"]["wrong_answers"]["value"] > 0


def test_least_bytes():
    inputs = _inputs(4)
    want = PROBE_ROWS * 8 + BUILD_ROWS * 16 + 16
    assert query.least_bytes(inputs.build, inputs.pool[0]) == want


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_the_cell_comes_after_the_earlier_ones():
    """Its configuration, cell and metric follow those that were there,
    and a metric that was there names it after the earlier cells."""
    m = manifest.manifest()
    assert [c["name"] for c in m["configs"]].index(CONFIG) >= 2
    assert [w["name"] for w in m["workloads"]].index(CELL) == len(EARLIER)
    pad = [e for e in m["per_layer"] if e["name"] == "pad_ms"]
    assert len(pad) == 1 and pad[0]["workloads"] == [CELL]
    lists = [e["workloads"] for e in m["end_to_end"] + m["per_layer"]
             if CELL in e.get("workloads", []) and e["name"] != "pad_ms"]
    assert len(lists) == 15
    for cells in lists:
        assert all(cells.index(w) < cells.index(CELL) for w in EARLIER if w in cells)


SCRIPT = """
import json, sys, time
from benchmark.harness import run_cell
from benchmark.tests.test_bench_wide import tiny
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
