"""A later change adds a configuration, a traffic mix and a metric as new
files and new manifest entries, and edits no file of the benchmark."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.manifest import MANIFEST, ROOT

SCRIPT = """
import json, sys, time
from benchmark import manifest
from benchmark.harness import run_cell
r = run_cell(manifest.cell("tiny_p50"), 7, 0.3, False, "cpu", time.perf_counter(),
             log=lambda m: None)
print(json.dumps(r))
"""


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_add_a_configuration_a_mix_and_a_metric_as_new_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / MANIFEST, tmp_path / MANIFEST)
    before = _digests(tmp_path / "benchmark")

    bench = tmp_path / "benchmark"
    config = json.loads((bench / "configs" / "config3.json").read_text())
    config.update(name="tiny2", reduced=["build", "probe"])
    config["build"] = config["build"][:2]
    for table in config["build"]:
        table["rows"] = 40
    config["probe"]["rows"] = 3000
    config["probe"]["columns"] = [dict(c, hi=80) for c in config["probe"]["columns"][:2]]
    (bench / "configs" / "tiny2.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "count_closed1.json").read_text())
    (bench / "traffic" / "count_pool2.json").write_text(json.dumps(dict(mix, pool_batches=2)))
    (bench / "metrics" / "query_p50_ms.py").write_text(
        "def read(run):\n"
        "    ordered = sorted(run.latency_ms)\n"
        "    return ordered[(len(ordered) - 1) // 2]\n")

    m = json.loads((tmp_path / MANIFEST).read_text())
    m["configs"].append({"name": "tiny2", "source": config["source"],
                         "file": "benchmark/configs/tiny2.json",
                         "reduced": ["build", "probe"], "why": "a test's"})
    m["workloads"].append({"name": "tiny_p50", "config": "tiny2", "traffic": "count_pool2",
                           "chips": 1, "why": "a test's"})
    m["end_to_end"].append({"name": "query_p50_ms", "unit": "ms", "better": "lower",
                            "bound": 0.05, "source": "device_trace",
                            "workloads": ["tiny_p50"]})
    (tmp_path / MANIFEST).write_text(json.dumps(m))

    env = dict(os.environ, PYTHONPATH=str(ROOT))  # the port, behind the copy
    p = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert set(r["metrics"]) == {"query_p50_ms", "setup_s"}
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
