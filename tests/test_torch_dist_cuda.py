"""The distributed tier on the card: every plan on a world of one rank over
NCCL (a group of its own on a HashStore), against the same plan on the CPU
over gloo and the oracle, at small shapes. Tolerance 0: every output is an
integer.

Every test needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor `ccve_tpu`, so on a machine without JAX run it as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dist_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table
from ccve_tpu_torch.exec.oracle import OracleBuildTable, assert_same_multiset, oracle_pipeline
from ccve_tpu_torch.parallel import distributed as pd
from ccve_tpu_torch.parallel.dist_aggregate import collect_groups, dist_aggregate

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs():
    probe = gen_probe_table(100_000, 2, 5_000)
    keys, payloads = gen_rhs_table(5_000, 2)
    rows = oracle_pipeline(probe, [OracleBuildTable(keys, payloads)] * 2, PayloadMode.FULL)
    return probe, keys, payloads, (rows.shape[0], [int(rows[:, 3].sum()), int(rows[:, 5].sum())])


def _plans(device):
    probe, keys, payloads, _ = _inputs()
    out = {}
    with pd.make_join_mesh(1, device) as mesh:
        assert dist.get_backend() == ("nccl" if mesh.device.type == "cuda" else "gloo")
        for kind in ("sorted", "lp", "csr"):
            parts = [pd.partition_tables(keys, payloads, 1, kind, mesh) for _ in range(2)]
            out[f"flat_{kind}"] = pd.dist_bulk_count(mesh, parts, probe)
            blocks = [pd.partition_tables_block(keys, payloads, 1, kind, mesh) for _ in range(2)]
            out[f"ring_{kind}"] = pd.dist_bulk_count_ring(mesh, blocks, probe)
            reps = [pd.replicate_tables(keys, payloads, kind, mesh) for _ in range(2)]
            out[f"bcast_{kind}"] = pd.dist_bulk_count_bcast(mesh, reps, probe)
        hot = pd.detect_heavy_hitters(probe[:, 0], max_hot=8, min_frac=0.0005)
        split = [pd.partition_tables_split(keys, payloads, 1, hot, "sorted", mesh)
                 for _ in range(2)]
        out["prpd"] = pd.dist_bulk_count(mesh, split, probe)
        out = {k: (int(r.count), r.payload_checksums.tolist(), float(r.skew), bool(r.overflow))
               for k, r in out.items()}
        tables = [pd.partition_tables(keys, payloads, 1, "sorted", mesh) for _ in range(2)]
        res = pd.dist_pipeline_expand(mesh, tables, probe, level_caps=[400_000, 800_000])
        out["pipeline"] = res.materialize(probe, PayloadMode.FULL)
        res = pd.dist_bulk_expand(mesh, tables[0], probe[:, 0])
        out["expand"] = res.triples()
        out["aggregate"] = collect_groups(dist_aggregate(mesh, probe[:, 0], probe[:, 1]))
    with pd.make_join_mesh_2d(1, 1, device) as mesh:
        tables = [pd.partition_tables(keys, payloads, 1, "lp", mesh) for _ in range(2)]
        r = pd.dist_bulk_count_hier(mesh, tables, probe)
        out["hier"] = (int(r.count), r.payload_checksums.tolist(), float(r.skew),
                       bool(r.overflow))
    return out


def test_every_plan_on_one_nccl_rank(cuda):
    probe, keys, payloads, want = _inputs()
    got, plain = _plans(cuda), _plans("cpu")
    assert not dist.is_initialized()
    for name, value in got.items():
        if isinstance(value, np.ndarray):
            assert_same_multiset(value, plain[name])
        else:
            assert value == plain[name], name
            assert value[:2] == (want[0], want[1]) and value[2:] == (1.0, False), name
    rows = oracle_pipeline(probe, [OracleBuildTable(keys, payloads)] * 2, PayloadMode.FULL)
    assert_same_multiset(got["pipeline"], rows)
