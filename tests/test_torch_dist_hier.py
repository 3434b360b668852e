"""The port's hierarchical two-hop shuffle (`dist_bulk_count_hier`) and the
broadcast join on 2D (dcn, ici) meshes of 2 and 4 gloo ranks
(`init_device_mesh`), held exactly against the JAX package's on
`make_join_mesh_2d` of its 8-device CPU mesh: count, checksums, overflow
(live rows only, as JAX counts them here), skew (float32) and max_bound,
on the JAX tests' inputs (`tests/test_distributed.py`)."""

import numpy as np
import pytest

from ccve_tpu.parallel import distributed as jd

import torch_dist_cases as cases

SHAPES = [(P, shape) for P, shapes in cases.HIER_SHAPES.items() for shape in shapes]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = {}
    for P, shapes in cases.HIER_SHAPES.items():
        names = [n for n in cases.HIER_CASES
                 if any(n.endswith(f"_{d}x{i}") for d, i in shapes)]
        out[P] = cases.spawn("HIER_CASES", P, tmp_path_factory.mktemp(f"p{P}"), names)
    return out


def _summary(res):
    return {"count": int(res.count), "checksums": np.asarray(res.payload_checksums).tolist(),
            "skew": float(np.float32(res.skew)), "overflow": bool(res.overflow)}


def _jax_hier(kind, shape, data=cases.uniform, cap_slack=8.0, **kw):
    probe, keys, payloads = data(**kw)
    mesh = jd.make_join_mesh_2d(*shape)
    P = shape[0] * shape[1]
    tables = [jd.partition_tables(keys, payloads, P, kind, mesh) for _ in range(probe.shape[1])]
    out = _summary(jd.dist_bulk_count_hier(mesh, tables, probe, cap_slack=cap_slack))
    out["max_bound"] = [t.max_bound for t in tables]
    return out


@pytest.mark.parametrize("P,shape", SHAPES)
@pytest.mark.parametrize("kind", ["lp", "sorted", "csr"])
def test_hier_matches_jax(port, kind, P, shape):
    got = port[P][f"hier_{kind}_{shape[0]}x{shape[1]}"]
    assert got == _jax_hier(kind, shape)
    assert not got["overflow"]


def test_hier_overflow_matches_jax(port):
    got = port[4]["hier_overflow_2x2"]
    want = _jax_hier("lp", (2, 2), data=cases.one_key, cap_slack=1.1, n=400, rhs=64, at=3)
    assert got["overflow"] and want["overflow"]
    assert got["skew"] == want["skew"]


@pytest.mark.parametrize("P,shape", [(4, (2, 2)), (2, (1, 2))])
def test_bcast_2d_matches_jax(port, P, shape):
    probe, keys, payloads = cases.uniform(lhs=777, n_joins=3, rhs=32, dup=1)
    mesh = jd.make_join_mesh_2d(*shape)
    tables = [jd.replicate_tables(keys, payloads, "sorted", mesh) for _ in range(3)]
    want = _summary(jd.dist_bulk_count_bcast(mesh, tables, probe))
    assert port[P][f"bcast_2d_{shape[0]}x{shape[1]}"] == want
