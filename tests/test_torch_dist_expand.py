"""The port's materializing distributed joins (`dist_bulk_expand`,
`dist_pipeline_expand` with and without `level_caps`) on 2 and 4 gloo
ranks, held against the JAX package's on its 8-device CPU mesh and the
oracle: totals, overflow, max_bound, and the triples and rows as
multisets, on the JAX tests' inputs (`tests/test_distributed.py`)."""

import numpy as np
import pytest

from ccve_tpu.config import PayloadMode
from ccve_tpu.exec.oracle import OracleBuildTable, assert_same_multiset, oracle_pipeline
from ccve_tpu.parallel import distributed as jd

import torch_dist_cases as cases

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return {P: cases.spawn("EXPAND_CASES", P, tmp_path_factory.mktemp(f"p{P}"))
            for P in WORLDS}


@pytest.mark.parametrize("P", WORLDS)
def test_expand_matches_jax(port, P):
    probe, keys, payloads = cases.expand_inputs()
    mesh = jd.make_join_mesh(P)
    table = jd.partition_tables(keys, payloads, P, "sorted", mesh)
    res = jd.dist_bulk_expand(mesh, table, probe, cap_slack=8.0)
    got = port[P]["expand"]
    assert not got["overflow"] and not bool(res.overflow)
    assert got["max_bound"] == table.max_bound == 3
    assert got["total"] == int(res.total) == sum(got["counts"])
    assert got["triples"] == sorted(map(tuple, res.triples().tolist()))


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("mode", ["reference", "full"])
def test_pipeline_expand_matches_jax(port, mode, P):
    probe, keys, payloads = cases.pipeline_inputs()
    pm = PayloadMode(mode)
    mesh = jd.make_join_mesh(P)
    tables = [jd.partition_tables(keys, payloads, P, "sorted", mesh) for _ in range(3)]
    res = jd.dist_pipeline_expand(mesh, tables, probe, cap_slack=8.0)
    got = port[P][f"pipeline_{mode}"]
    assert (got["total"], got["overflow"]) == (int(res.total), bool(res.overflow))
    assert_same_multiset(got["rows"], res.materialize(probe, pm))
    assert_same_multiset(got["rows"], oracle_pipeline(
        probe, [OracleBuildTable(keys, payloads)] * 3, pm))


@pytest.mark.parametrize("P", WORLDS)
def test_pipeline_level_caps_match_jax(port, P):
    probe, keys, payloads, caps, tiny = cases.level_caps_inputs(P)
    mesh = jd.make_join_mesh(P)
    tables = [jd.partition_tables(keys, payloads, P, "sorted", mesh) for _ in range(4)]
    res = jd.dist_pipeline_expand(mesh, tables, probe, cap_slack=8.0, level_caps=caps)
    got = port[P]["level_caps"]
    assert (got["total"], got["overflow"]) == (int(res.total), bool(res.overflow))
    assert got["state"] == caps[-1] and res.rid.shape[0] == P * caps[-1]
    assert_same_multiset(got["rows"], res.materialize(probe, PayloadMode.FULL))
    res2 = jd.dist_pipeline_expand(mesh, tables, probe, cap_slack=8.0, level_caps=tiny)
    assert got["tiny_overflow"] and bool(res2.overflow)
    assert got["caps"] == caps and np.all(np.asarray(caps) >= 64)
