"""Inputs and port-side cases of the distributed tier's tests.

The cases run on gloo ranks spawned by `ccve_tpu_torch.parallel.bootstrap.
spawn_ranks`, which import this module by name in fresh processes, so it
imports no JAX and nothing of `ccve_tpu`. Each `tests/test_torch_dist*.py`
file spawns one group a world size, runs all of its cases there, and holds
the results against the JAX package's on the 8-device CPU mesh that
`tests/conftest.py` makes. The inputs are the JAX tests' own
(`tests/test_distributed.py`, `test_dist_aggregate.py`), made by the port's
generators, which are bit-exact with the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table, gen_zipf_keys
from ccve_tpu_torch.parallel import distributed as pd
from ccve_tpu_torch.parallel.bootstrap import spawn_ranks
from ccve_tpu_torch.parallel.dist_aggregate import collect_groups, dist_aggregate

DEVICE = "cpu"


# ---- inputs -----------------------------------------------------------------------------

def uniform(lhs=600, n_joins=2, rhs=64, dup=2):
    """(probe [lhs, n_joins], keys, payloads): the JAX tests' uniform join."""
    keys, payloads = gen_rhs_table(rhs, dup)
    return gen_probe_table(lhs, n_joins, rhs), keys, payloads


def one_key(n, rhs, at):
    """Every probe the build key at row `at` of gen_rhs_table(rhs, 1)."""
    keys, payloads = gen_rhs_table(rhs, 1)
    return np.full((n, 1), keys[at], np.int64), keys, payloads


def hot_probe():
    """test_dist_hot_split_beats_skew's probes: 600 of one key, 200 cold."""
    keys, payloads = gen_rhs_table(64, 2)
    rng = np.random.default_rng(7)
    cold = rng.choice(keys, 200)
    probe = np.concatenate([np.full(600, keys[5]), cold])
    rng.shuffle(probe)
    return probe.reshape(-1, 1).astype(np.int64), keys, payloads


def expand_inputs():
    """test_dist_expand_matches_single_chip's inputs (multiplicity 3)."""
    keys, payloads = gen_rhs_table(64, 3)
    return np.random.default_rng(13).integers(0, 70, 500).astype(np.int64), keys, payloads


def pipeline_inputs():
    """test_dist_pipeline_expand_matches_oracle's: 3 levels, multiplicity 2."""
    keys, payloads = gen_rhs_table(48, 2)
    return np.random.default_rng(29).integers(0, 96, (600, 3)).astype(np.int64), keys, payloads


def level_caps_inputs(n_parts):
    """test_dist_pipeline_expand_level_caps's: 4 levels, multiplicity 4,
    with its per-rank caps and its tiny caps."""
    keys, payloads = gen_rhs_table(32, 4)
    probe = np.random.default_rng(31).integers(0, 80, (400, 4)).astype(np.int64)
    key_mult = np.zeros(81, np.int64)
    uk, cnt = np.unique(keys, return_counts=True)
    key_mult[uk] = cnt
    live = np.ones(probe.shape[0], np.int64)
    caps = []
    for level in range(4):
        live = live * key_mult[probe[:, level]]
        caps.append(max(2 * int(live.sum()) // n_parts + 64, 64))
    return probe, keys, payloads, caps, [max(c // 64, 2) for c in caps]


def aggregate_inputs(name):
    """(keys, values, cap_slack) of test_dist_aggregate.py's cases."""
    if name == "uniform":
        rng = np.random.default_rng(11)
        return (rng.integers(0, 97, 1000, dtype=np.int64),
                rng.integers(-50, 50, 1000, dtype=np.int64), 8.0)
    if name == "zipf":
        return (gen_zipf_keys(2000, domain=50, alpha=1.3, seed=5),
                np.arange(2000, dtype=np.int64), 32.0)
    if name == "overflow":
        return np.full(800, 7, np.int64), np.ones(800, np.int64), 1.0
    if name == "uneven":
        rng = np.random.default_rng(3)
        return (rng.integers(0, 31, 777, dtype=np.int64),
                rng.integers(0, 9, 777, dtype=np.int64), 8.0)
    raise KeyError(name)


# ---- results ------------------------------------------------------------------------------

def summary(res) -> dict:
    return {"count": int(res.count), "checksums": res.payload_checksums.tolist(),
            "skew": float(res.skew), "overflow": bool(res.overflow)}


def _count_case(kind, plan="flat", data=uniform, cap_slack=8.0, **kw):
    def case(P):
        probe, keys, payloads = data(**kw)
        n_joins = probe.shape[1]
        with pd.make_join_mesh(P, DEVICE) as mesh:
            if plan == "bcast":
                tables = [pd.replicate_tables(keys, payloads, kind, mesh) for _ in range(n_joins)]
                return summary(pd.dist_bulk_count_bcast(mesh, tables, probe))
            tables = [pd.partition_tables(keys, payloads, P, kind, mesh) for _ in range(n_joins)]
            out = summary(pd.dist_bulk_count(mesh, tables, probe, cap_slack=cap_slack))
            out["max_bound"] = [t.max_bound for t in tables]
            return out
    return case


def _ring(P, kinds=("lp", "csr"), lhs=500, chunks=(2,)):
    probe, keys, payloads = uniform(lhs=lhs)
    with pd.make_join_mesh(P, DEVICE) as mesh:
        tables = [pd.partition_tables_block(keys, payloads, P, kind, mesh) for kind in kinds]
        out = {f"n_chunks={c}": summary(pd.dist_bulk_count_ring(mesh, tables, probe, n_chunks=c))
               for c in chunks}
        out["max_bound"] = [t.max_bound for t in tables]
        return out


def _prpd_skew(P):
    probe, keys, payloads = hot_probe()
    with pd.make_join_mesh(P, DEVICE) as mesh:
        plain = [pd.partition_tables(keys, payloads, P, "lp", mesh)]
        out = {"plain": summary(pd.dist_bulk_count(mesh, plain, probe, cap_slack=1.2))}
        hot = pd.detect_heavy_hitters(probe[:, 0], max_hot=4, min_frac=0.05)
        split = [pd.partition_tables_split(keys, payloads, P, hot, "lp", mesh)]
        out["split"] = summary(pd.dist_bulk_count(mesh, split, probe, cap_slack=1.2))
        out["hot"] = hot.tolist()
        return out


def _prpd_mixed(P):
    probe, keys, payloads = uniform(lhs=500)
    with pd.make_join_mesh(P, DEVICE) as mesh:
        hot = pd.detect_heavy_hitters(probe[:, 0], max_hot=8, min_frac=0.01)
        levels = [pd.partition_tables_split(keys, payloads, P, hot, "lp", mesh),
                  pd.partition_tables(keys, payloads, P, "csr", mesh)]
        out = summary(pd.dist_bulk_count(mesh, levels, probe, cap_slack=8.0))
        out["max_bound"] = [levels[0].part.max_bound, levels[0].rep.max_bound,
                            levels[1].max_bound]
        return out


def _bcast_vs_shuffle(P):
    probe, keys, payloads = uniform(lhs=900, rhs=128, dup=4)
    with pd.make_join_mesh(P, DEVICE) as mesh:
        parts = [pd.partition_tables(keys, payloads, P, "sorted", mesh) for _ in range(2)]
        reps = [pd.replicate_tables(keys, payloads, "sorted", mesh) for _ in range(2)]
        return {"shuffle": summary(pd.dist_bulk_count(mesh, parts, probe, cap_slack=8.0)),
                "bcast": summary(pd.dist_bulk_count_bcast(mesh, reps, probe))}


COUNT_CASES = {
    **{f"flat_{k}": _count_case(k) for k in ("lp", "csr", "sorted")},
    "skew": _count_case("lp", data=one_key, cap_slack=16.0, n=400, rhs=32, at=3),
    "overflow": _count_case("lp", data=one_key, cap_slack=0.1, n=512, rhs=32, at=0),
    "ring": _ring,
    "ring_chunks": lambda P: _ring(P, kinds=("lp", "lp"), lhs=493, chunks=(1, 4)),
    "prpd_skew": _prpd_skew,
    "prpd_mixed": _prpd_mixed,
    **{f"bcast_{k}": _count_case(k, plan="bcast") for k in ("lp", "csr", "sorted")},
    "bcast_vs_shuffle": _bcast_vs_shuffle,
}


def _hier(kind, shape, cap_slack=8.0, data=uniform, **kw):
    def case(P):
        D, I = shape
        probe, keys, payloads = data(**kw)
        with pd.make_join_mesh_2d(D, I, DEVICE) as mesh:
            tables = [pd.partition_tables(keys, payloads, P, kind, mesh)
                      for _ in range(probe.shape[1])]
            out = summary(pd.dist_bulk_count_hier(mesh, tables, probe, cap_slack=cap_slack))
            out["max_bound"] = [t.max_bound for t in tables]
            return out
    return case


def _bcast_2d(shape):
    def case(P):
        probe, keys, payloads = uniform(lhs=777, n_joins=3, rhs=32, dup=1)
        with pd.make_join_mesh_2d(*shape, DEVICE) as mesh:
            tables = [pd.replicate_tables(keys, payloads, "sorted", mesh) for _ in range(3)]
            return summary(pd.dist_bulk_count_bcast(mesh, tables, probe))
    return case


HIER_SHAPES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4), (4, 1))}
HIER_CASES = {
    **{f"hier_{k}_{d}x{i}": _hier(k, (d, i)) for k in ("lp", "sorted", "csr")
       for shapes in HIER_SHAPES.values() for (d, i) in shapes},
    "hier_overflow_2x2": _hier("lp", (2, 2), cap_slack=1.1, data=one_key, n=400, rhs=64, at=3),
    "bcast_2d_2x2": _bcast_2d((2, 2)),
    "bcast_2d_1x2": _bcast_2d((1, 2)),
}


def _expand(P):
    probe, keys, payloads = expand_inputs()
    with pd.make_join_mesh(P, DEVICE) as mesh:
        table = pd.partition_tables(keys, payloads, P, "sorted", mesh)
        res = pd.dist_bulk_expand(mesh, table, probe, cap_slack=8.0)
        return {"total": int(res.total), "overflow": bool(res.overflow),
                "counts": res.counts.tolist(), "max_bound": table.max_bound,
                "triples": sorted(map(tuple, res.triples().tolist()))}


def _pipeline(mode):
    def case(P):
        probe, keys, payloads = pipeline_inputs()
        with pd.make_join_mesh(P, DEVICE) as mesh:
            tables = [pd.partition_tables(keys, payloads, P, "sorted", mesh) for _ in range(3)]
            res = pd.dist_pipeline_expand(mesh, tables, probe, cap_slack=8.0)
            return {"total": int(res.total), "overflow": bool(res.overflow),
                    "rows": res.materialize(probe, PayloadMode(mode))}
    return case


def _level_caps(P):
    probe, keys, payloads, caps, tiny = level_caps_inputs(P)
    with pd.make_join_mesh(P, DEVICE) as mesh:
        tables = [pd.partition_tables(keys, payloads, P, "sorted", mesh) for _ in range(4)]
        res = pd.dist_pipeline_expand(mesh, tables, probe, cap_slack=8.0, level_caps=caps)
        res2 = pd.dist_pipeline_expand(mesh, tables, probe, cap_slack=8.0, level_caps=tiny)
        return {"total": int(res.total), "overflow": bool(res.overflow),
                "rows": res.materialize(probe, PayloadMode.FULL), "state": res.rid.shape[0],
                "caps": caps, "tiny_overflow": bool(res2.overflow)}


EXPAND_CASES = {"expand": _expand, "pipeline_reference": _pipeline("reference"),
                "pipeline_full": _pipeline("full"), "level_caps": _level_caps}


def _aggregate(name):
    def case(P):
        keys, values, slack = aggregate_inputs(name)
        with pd.make_join_mesh(P, DEVICE) as mesh:
            res = dist_aggregate(mesh, keys, values, cap_slack=slack)
            return {"groups": collect_groups(res), "shard_groups": res.shard_groups.tolist(),
                    "n_groups": int(res.n_groups), "block_len": res.block_len,
                    "skew": float(res.skew), "overflow": bool(res.overflow)}
    return case


AGGREGATE_CASES = {name: _aggregate(name) for name in ("uniform", "zipf", "overflow", "uneven")}


def run_cases(table: str, names) -> dict:
    """On this rank of the running group: {name: result} of the cases
    `names` of the case table `table` (a module-level dict here)."""
    cases = globals()[table]
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    P = dist.get_world_size() if dist.is_initialized() else 1
    return {name: cases[name](P) for name in names}


def spawn(table: str, world_size: int, store_dir, names=None) -> dict:
    """Every case of `table` (or `names`) on `world_size` spawned gloo
    ranks; asserts that the ranks agree and returns rank 0's results."""
    names = list(globals()[table]) if names is None else list(names)
    results = spawn_ranks(run_cases, world_size, args=(table, names), store_dir=str(store_dir),
                          timeout=240)
    for rank, res in enumerate(results[1:], 1):
        for name in names:
            assert _same(res[name], results[0][name]), (rank, name)
    return results[0]


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


# ---- port-only cases: keys the JAX package cannot carry --------------------------------

I64_MAX = 2**63 - 1
I64_MIN = -(2**63)


def sentinel_inputs():
    """A 2-level join whose build and probe keys include the JAX package's
    sentinels: -2 (its dead-row key), -3 (its empty hot-set padding),
    INT64_MAX - 1 beside an INT64_MAX aggregate key (its aggregate padding),
    on 601 probe rows (not divisible by 2 or 4). Key -1, the LP tables'
    empty slot, stays a sentinel of the LP layout and is left out."""
    rng = np.random.default_rng(5)
    keys = np.concatenate([np.arange(40), [-2, -2, -3, I64_MAX - 1, 123]]).astype(np.int64)
    payloads = np.arange(keys.size, dtype=np.int64) + 10_000_000
    pool = np.concatenate([keys, [-5, 99, 1 << 40]])
    probe = rng.choice(pool, (601, 2)).astype(np.int64)
    return probe, keys, payloads


def _every_plan(P):
    probe, keys, payloads = sentinel_inputs()
    out = {}
    with pd.make_join_mesh(P, DEVICE) as mesh:
        for kind in ("sorted", "lp", "csr"):
            tables = [pd.partition_tables(keys, payloads, P, kind, mesh) for _ in range(2)]
            out[f"flat_{kind}"] = summary(pd.dist_bulk_count(mesh, tables, probe, cap_slack=8.0))
            reps = [pd.replicate_tables(keys, payloads, kind, mesh) for _ in range(2)]
            out[f"bcast_{kind}"] = summary(pd.dist_bulk_count_bcast(mesh, reps, probe))
            blocks = [pd.partition_tables_block(keys, payloads, P, kind, mesh) for _ in range(2)]
            out[f"ring_{kind}"] = summary(pd.dist_bulk_count_ring(mesh, blocks, probe))
        empty = np.zeros(0, np.int64)  # no hot key: probe key -3 must reach its owner
        split = [pd.partition_tables_split(keys, payloads, P, empty, "lp", mesh)
                 for _ in range(2)]
        out["prpd_empty_hot"] = summary(pd.dist_bulk_count(mesh, split, probe, cap_slack=8.0))
        hot = np.array([-2, -3], np.int64)
        split = [pd.partition_tables_split(keys, payloads, P, hot, "sorted", mesh)
                 for _ in range(2)]
        out["prpd_hot_sentinels"] = summary(pd.dist_bulk_count(mesh, split, probe,
                                                               cap_slack=8.0))
        table = pd.partition_tables(keys, payloads, P, "sorted", mesh)
        res = pd.dist_bulk_expand(mesh, table, probe[:, 0], cap_slack=8.0)
        out["expand"] = sorted(map(tuple, res.triples().tolist()))
        tables = [pd.partition_tables(keys, payloads, P, "sorted", mesh) for _ in range(2)]
        res = pd.dist_pipeline_expand(mesh, tables, probe, cap_slack=8.0)
        out["pipeline"] = res.materialize(probe, PayloadMode.FULL)
        agg_keys = np.concatenate([probe[:, 0], [I64_MAX, I64_MAX, I64_MIN]])
        agg_vals = np.arange(agg_keys.size, dtype=np.int64) - 300
        out["aggregate"] = collect_groups(dist_aggregate(mesh, agg_keys, agg_vals, cap_slack=8.0))
    shape = (2, P // 2) if P >= 4 else (1, P)
    with pd.make_join_mesh_2d(*shape, DEVICE) as mesh:
        for kind in ("sorted", "lp"):
            tables = [pd.partition_tables(keys, payloads, P, kind, mesh) for _ in range(2)]
            out[f"hier_{kind}"] = summary(pd.dist_bulk_count_hier(mesh, tables, probe,
                                                                  cap_slack=8.0))
    return out


PORT_CASES = {"every_plan": _every_plan}
