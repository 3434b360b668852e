"""Each cell's command on the card, for a second, and the control at the
cell's own size: run on the card with `pytest benchmark/tests -m cuda`."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.manifest import ROOT, manifest

CELLS = [w["name"] for w in manifest()["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name, traced):
    _card()
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", name,
                        "--seed", str(2**31 + 99), "--seconds", "1", "--trace", str(traced)],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    kind = "per_layer" if traced else "end_to_end"
    want = {m["name"] for m in manifest()[kind] if name in m.get("workloads", CELLS)}
    assert set(r["metrics"]) == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    _card()
    p = subprocess.run([sys.executable, "-m", "benchmark.control", "--workload", name,
                        "--seeds", "5,6,7", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
