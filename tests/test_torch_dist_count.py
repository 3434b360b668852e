"""The port's distributed counts (`ccve_tpu_torch.parallel.distributed`:
the flat shuffle, the ring, PRPD and the broadcast join) on 2 and 4 gloo
ranks, held exactly against the JAX package's plans on its 8-device CPU
mesh, on the JAX tests' inputs (`tests/test_distributed.py`): count,
checksums, overflow, skew (float32, equal) and max_bound. One group a
world size runs every case (`torch_dist_cases.COUNT_CASES`)."""

import numpy as np
import pytest

from ccve_tpu.parallel import distributed as jd

import torch_dist_cases as cases

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return {P: cases.spawn("COUNT_CASES", P, tmp_path_factory.mktemp(f"p{P}"))
            for P in WORLDS}


def _summary(res):
    return {"count": int(res.count), "checksums": np.asarray(res.payload_checksums).tolist(),
            "skew": float(np.float32(res.skew)), "overflow": bool(res.overflow)}


def _jax_count(kind, P, data=cases.uniform, cap_slack=8.0, plan="flat", **kw):
    probe, keys, payloads = data(**kw)
    mesh = jd.make_join_mesh(P)
    if plan == "bcast":
        tables = [jd.replicate_tables(keys, payloads, kind, mesh) for _ in range(probe.shape[1])]
        return _summary(jd.dist_bulk_count_bcast(mesh, tables, probe))
    tables = [jd.partition_tables(keys, payloads, P, kind, mesh) for _ in range(probe.shape[1])]
    out = _summary(jd.dist_bulk_count(mesh, tables, probe, cap_slack=cap_slack))
    out["max_bound"] = [t.max_bound for t in tables]
    return out


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("kind", ["lp", "csr", "sorted"])
def test_flat_matches_jax(port, kind, P):
    got = port[P][f"flat_{kind}"]
    assert got == _jax_count(kind, P)
    assert not got["overflow"] and got["skew"] >= 1.0


@pytest.mark.parametrize("P", WORLDS)
def test_skew_detection_matches_jax(port, P):
    """All probes one key: one owner takes every row, skew = P."""
    got = port[P]["skew"]
    assert got == _jax_count("lp", P, data=cases.one_key, cap_slack=16.0, n=400, rhs=32, at=3)
    assert got["count"] == 400 and got["skew"] == float(P)


@pytest.mark.parametrize("P", WORLDS)
def test_overflow_flag_matches_jax(port, P):
    got = port[P]["overflow"]
    want = _jax_count("lp", P, data=cases.one_key, cap_slack=0.1, n=512, rhs=32, at=0)
    assert got["overflow"] and want["overflow"]
    assert got["skew"] == want["skew"]


@pytest.mark.parametrize("P", WORLDS)
def test_ring_matches_jax(port, P):
    probe, keys, payloads = cases.uniform(lhs=500)
    mesh = jd.make_join_mesh(P)
    tables = [jd.partition_tables_block(keys, payloads, P, k, mesh) for k in ("lp", "csr")]
    got = port[P]["ring"]
    assert got["n_chunks=2"] == _summary(jd.dist_bulk_count_ring(mesh, tables, probe))
    assert got["max_bound"] == [t.max_bound for t in tables]


@pytest.mark.parametrize("P", WORLDS)
def test_ring_chunked_matches_jax(port, P):
    """n_chunks 1 and 4 on 493 rows (not divisible by ranks x chunks)."""
    probe, keys, payloads = cases.uniform(lhs=493)
    mesh = jd.make_join_mesh(P)
    tables = [jd.partition_tables_block(keys, payloads, P, "lp", mesh) for _ in range(2)]
    got = port[P]["ring_chunks"]
    for c in (1, 4):
        assert got[f"n_chunks={c}"] == _summary(
            jd.dist_bulk_count_ring(mesh, tables, probe, n_chunks=c))


@pytest.mark.parametrize("P", WORLDS)
def test_prpd_beats_skew_matches_jax(port, P):
    probe, keys, payloads = cases.hot_probe()
    mesh = jd.make_join_mesh(P)
    plain = jd.dist_bulk_count(mesh, [jd.partition_tables(keys, payloads, P, "lp", mesh)],
                               probe, cap_slack=1.2)
    hot = jd.detect_heavy_hitters(probe[:, 0], max_hot=4, min_frac=0.05)
    split = jd.dist_bulk_count(
        mesh, [jd.partition_tables_split(keys, payloads, P, hot, "lp", mesh)], probe,
        cap_slack=1.2)
    got = port[P]["prpd_skew"]
    assert got["hot"] == hot.tolist()
    assert got["plain"]["overflow"] == bool(plain.overflow)
    assert got["plain"]["skew"] == float(np.float32(plain.skew))
    assert got["split"] == _summary(split)
    assert not got["split"]["overflow"]


@pytest.mark.parametrize("P", WORLDS)
def test_prpd_mixed_levels_match_jax(port, P):
    probe, keys, payloads = cases.uniform(lhs=500)
    mesh = jd.make_join_mesh(P)
    hot = jd.detect_heavy_hitters(probe[:, 0], max_hot=8, min_frac=0.01)
    lv0 = jd.partition_tables_split(keys, payloads, P, hot, "lp", mesh)
    lv1 = jd.partition_tables(keys, payloads, P, "csr", mesh)
    want = _summary(jd.dist_bulk_count(mesh, [lv0, lv1], probe, cap_slack=8.0))
    want["max_bound"] = [lv0.part.max_bound, lv0.rep.max_bound, lv1.max_bound]
    assert port[P]["prpd_mixed"] == want


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("kind", ["lp", "csr", "sorted"])
def test_bcast_matches_jax(port, kind, P):
    got = port[P][f"bcast_{kind}"]
    assert got == _jax_count(kind, P, plan="bcast")
    assert got["skew"] == 1.0 and not got["overflow"]


@pytest.mark.parametrize("P", WORLDS)
def test_bcast_agrees_with_shuffle(port, P):
    got = port[P]["bcast_vs_shuffle"]
    want = _jax_count("sorted", P, cap_slack=8.0, lhs=900, rhs=128, dup=4)
    assert {k: got["shuffle"][k] for k in want if k != "max_bound"} == \
        {k: want[k] for k in want if k != "max_bound"}
    assert (got["bcast"]["count"], got["bcast"]["checksums"]) == \
        (got["shuffle"]["count"], got["shuffle"]["checksums"])
