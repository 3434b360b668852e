"""What the port's distributed tier does beyond the JAX package's, held
against the oracle and numpy: keys the JAX package takes for sentinels
(-2 its dead rows, -3 its empty hot set, INT64_MAX its aggregate padding)
join and group like any key; probe rows not divisible by the ranks; every
plan on one rank (a group of its own), 2 and 4 gloo ranks; the mesh's
refusals; the bootstrap's identity plumbing; and the dry run
(`tests/test_torch_dist_cli.py` launches the CLI)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.exec.oracle import OracleBuildTable, assert_same_multiset, oracle_pipeline
from ccve_tpu_torch.parallel import bootstrap
from ccve_tpu_torch.parallel import distributed as pd
from ccve_tpu_torch.parallel.dryrun import dryrun_multichip

import torch_dist_cases as cases

WORLDS = (1, 2, 4)
COUNT_PLANS = [f"{plan}_{kind}" for plan in ("flat", "bcast", "ring")
               for kind in ("sorted", "lp", "csr")] + [
    "prpd_empty_hot", "prpd_hot_sentinels", "hier_sorted", "hier_lp"]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = {1: cases.run_cases("PORT_CASES", ["every_plan"])["every_plan"]}
    for P in WORLDS[1:]:
        out[P] = cases.spawn("PORT_CASES", P, tmp_path_factory.mktemp(f"p{P}"))["every_plan"]
    assert not dist.is_initialized()  # the one-rank meshes destroyed their groups
    return out


@pytest.fixture(scope="module")
def oracle():
    probe, keys, payloads = cases.sentinel_inputs()
    rows = oracle_pipeline(probe, [OracleBuildTable(keys, payloads)] * 2, PayloadMode.FULL)
    return {"count": rows.shape[0], "checksums": [int(rows[:, 3].sum()), int(rows[:, 5].sum())],
            "rows": rows}


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("plan", COUNT_PLANS)
def test_sentinel_keys_join_on_every_plan(port, oracle, plan, P):
    got = port[P][plan]
    assert (got["count"], got["checksums"]) == (oracle["count"], oracle["checksums"])
    assert not got["overflow"]


@pytest.mark.parametrize("P", WORLDS)
def test_sentinel_keys_expand(port, P):
    probe, keys, payloads = cases.sentinel_inputs()
    one = oracle_pipeline(probe[:, :1], [OracleBuildTable(keys, payloads)], PayloadMode.FULL)
    rows = np.nonzero(probe[:, 0][:, None] == keys[None, :])
    want = sorted(zip(rows[0].tolist(), keys[rows[1]].tolist(), payloads[rows[1]].tolist()))
    assert len(want) == one.shape[0]
    assert port[P]["expand"] == want


@pytest.mark.parametrize("P", WORLDS)
def test_sentinel_keys_pipeline(port, oracle, P):
    assert_same_multiset(port[P]["pipeline"], oracle["rows"])


@pytest.mark.parametrize("P", WORLDS)
def test_aggregate_groups_int64_extremes(port, P):
    probe, _, _ = cases.sentinel_inputs()
    keys = np.concatenate([probe[:, 0], [cases.I64_MAX, cases.I64_MAX, cases.I64_MIN]])
    vals = np.arange(keys.size, dtype=np.int64) - 300
    uniq = np.unique(keys)
    want = np.stack([uniq] + [np.array([f(vals[keys == k]) for k in uniq])
                              for f in (np.size, np.sum, np.min, np.max)], axis=1)
    np.testing.assert_array_equal(port[P]["aggregate"], want)
    assert cases.I64_MAX in port[P]["aggregate"][:, 0]


def test_mesh_size_must_be_a_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        pd.make_join_mesh(3, "cpu")
    with pytest.raises(ValueError, match="power of two"):
        pd.make_join_mesh_2d(3, 1, "cpu")
    assert not dist.is_initialized()


def test_mesh_without_a_group_has_one_rank():
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        pd.make_join_mesh(2, "cpu")
    with pd.make_join_mesh(1, "cpu") as mesh:
        assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, (1,))
        assert mesh.comm_device == torch.device("cpu") and dist.get_backend() == "gloo"
    assert not dist.is_initialized()


def test_mesh_on_the_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pd.make_join_mesh(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bootstrap.init_distributed()
    with pytest.raises(ValueError, match="NCCL"):
        pd.make_join_mesh(1, "cpu", backend="nccl")
    assert not dist.is_initialized()


def test_init_distributed_identity_plumbing(monkeypatch):
    """Arguments, then CCVE_*, then torchrun's variables; with none of them
    nothing is joined. The init call is captured, not made."""
    for name in ("CCVE_COORDINATOR", "CCVE_NUM_PROCESSES", "CCVE_PROCESS_ID", "MASTER_ADDR",
                 "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    info = bootstrap.init_distributed(device="cpu")
    assert info == {"initialized": False, "process_id": 0, "num_processes": 1,
                    "backend": "gloo", "device": "cpu", "local_world_size": 1}
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append(
        (backend, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda: calls[-1][1]["rank"])
    monkeypatch.setattr(dist, "get_world_size", lambda: calls[-1][1]["world_size"])
    monkeypatch.setenv("MASTER_ADDR", "node9")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    info = bootstrap.init_distributed(device="cpu")
    assert calls[-1] == ("gloo", {"init_method": "tcp://node9:29500", "world_size": 8,
                                  "rank": 5})
    assert (info["process_id"], info["num_processes"], info["local_world_size"]) == (5, 8, 4)
    monkeypatch.setenv("CCVE_COORDINATOR", "node0:1234")
    monkeypatch.setenv("CCVE_NUM_PROCESSES", "4")
    monkeypatch.setenv("CCVE_PROCESS_ID", "3")
    bootstrap.init_distributed(device="cpu")
    assert calls[-1] == ("gloo", {"init_method": "tcp://node0:1234", "world_size": 4,
                                  "rank": 3})
    bootstrap.init_distributed("file:///tmp/x", 2, 1, device="cpu", backend="gloo")
    assert calls[-1] == ("gloo", {"init_method": "file:///tmp/x", "world_size": 2, "rank": 1})


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_covers_every_plan(n):
    got = dryrun_multichip(n, "cpu")
    assert set(got) == {"bulk_count", "flat", "expand", "pipeline", "ring", "prpd", "hier",
                        "bcast"}
    for plan in ("flat", "ring", "prpd", "hier", "bcast"):
        assert got[plan] == got["bulk_count"]
    assert got["pipeline"] == got["bulk_count"][0]
