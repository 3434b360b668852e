"""Nothing the harness loads is JAX or the JAX package, compared by each
module's top-level name taken whole: the port's name, `ccve_tpu_torch`,
begins with the JAX package's, `ccve_tpu`."""

import ast
import json
import os
import subprocess
import sys

from benchmark.harness import FORBIDDEN, forbidden_modules
from benchmark.manifest import ROOT

SCRIPT = """
import json, sys, time
from benchmark.harness import run_cell
from benchmark.tests.tiny import tiny
for name in ("config1", "config3"):
    for traced in (False, True):
        r = run_cell(tiny(name), 3, 0.2, traced, "cpu", time.perf_counter(),
                     log=lambda m: None)
        assert r["correct"], r
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_whole_names_are_compared():
    assert forbidden_modules(["ccve_tpu_torch", "ccve_tpu_torch.exec.bulk"]) == []
    assert forbidden_modules(["ccve_tpu.ops.sort_merge", "jax.numpy", "jaxlib",
                              "flax.linen", "jaxtyping"]) == ["ccve_tpu", "flax", "jax",
                                                              "jaxlib"]


def test_a_run_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "ccve_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_no_benchmark_file_imports_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not forbidden_modules(names), (path, names)
