"""The distributed tier through the CLI, as users launch it: `cli dist` as
one process (cross-checked with the one-device count) and as two
processes (CCVE_* variables, a file:// rendezvous) on every plan, its
refusals, and `cli baseline --config 5` without a GPU."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(args, env=None, **kw):
    return subprocess.Popen([sys.executable, "-m", "ccve_tpu_torch.cli", *args], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)


def _result(proc, timeout=240):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


SMALL = ["--n-build", "2000", "--n-probe", "30000", "--n-joins", "2", "--pipeline-levels", "2",
         "--device", "cpu"]


@pytest.mark.parametrize("shuffle", ["flat", "hier", "bcast"])
def test_cli_dist_two_processes_match_one(shuffle, tmp_path):
    """`cli dist` as two processes (CCVE_* variables, a file:// rendezvous)
    against one process, which cross-checks with the one-device count."""
    single = _result(_cli(["dist"] + SMALL))
    assert single["initialized"] is False and single["cross_checked"] is True
    pair = [_cli(["dist"] + SMALL + ["--shuffle", shuffle],
                 env={"CCVE_COORDINATOR": f"file://{tmp_path}/rendezvous",
                      "CCVE_NUM_PROCESSES": "2", "CCVE_PROCESS_ID": str(rank)})
            for rank in (0, 1)]
    results = [_result(p) for p in pair]
    for r in results:
        assert r["initialized"] is True and r["num_processes"] == 2
        assert r["hierarchical"] is (shuffle == "hier") and r["overflow"] is False
        assert (r["count"], r["payload_checksums"]) == (single["count"],
                                                        single["payload_checksums"])
        assert r["pipeline_rows"] == single["pipeline_rows"]


@pytest.mark.parametrize("kind", ["lp", "csr"])
def test_cli_dist_zipf_and_table_kinds_one_process(kind):
    r = _result(_cli(["dist", "--n-build", "2000", "--n-probe", "40000", "--zipf-alpha", "1.2",
                      "--kind", kind, "--device", "cpu"]))
    assert r["cross_checked"] is True and r["overflow"] is False and r["count"] > 0
    assert r["skew"] < 2.5


def test_cli_dist_refusals():
    proc = _cli(["dist", "--shuffle", "hier", "--zipf-alpha", "1.1", "--device", "cpu"])
    proc.communicate(timeout=120)
    assert proc.returncode == 2
    for args in (["dist"], ["baseline", "--config", "5", "--tiny"]):
        proc = _cli(args)
        _, err = proc.communicate(timeout=120)
        assert proc.returncode != 0 and "no CUDA device" in err
