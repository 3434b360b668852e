"""The cursor executors of both packages driven segment by segment, for the
port's parity tests: each returns the count, the stored rows and the work
counters (`level_steps`, `level_rows`, `occupancy`) that JAX's `run` does
not return, and, under the device tuner, the bandit's greedy thresholds
and commits."""

import numpy as np


def chunk_batches(probe: np.ndarray, n_joins: int, block: int, seg: int, pad: bool = False):
    """[(cols int64[S, n_joins, block], counts int32[S])] a segment of
    `seg` chunks, the last chunk zero-padded (and, with `pad`, the last
    segment padded to `seg` chunks of count 0, as the device tuner's
    stream is)."""
    n = probe.shape[0]
    n_chunks = -(-n // block)
    total = -(-n_chunks // seg) * seg if pad else n_chunks
    rows = np.zeros((total * block, n_joins), np.int64)
    rows[:n] = probe
    cols = np.ascontiguousarray(rows.reshape(total, block, n_joins).swapaxes(1, 2))
    counts = np.clip(n - np.arange(total) * block, 0, block).astype(np.int32)
    return [(cols[s : s + seg], counts[s : s + seg]) for s in range(0, total, seg)]


def _out(count, stored, rows, steps, level_rows, occ, **extra):
    return dict(count=int(count), rows=np.asarray(rows)[:, : int(stored)].T,
                level_steps=np.asarray(steps), level_rows=np.asarray(level_rows),
                occupancy=np.asarray(occ), **extra)


def jax_run(pipe, probe: np.ndarray, seg: int, thresholds=None) -> dict:
    """JAX's `JoinPipeline` over `probe` in segments of `seg` chunks at
    fixed `thresholds` (default its static ones), then the flush unless
    NONE: the path of its `run` without the tuners."""
    import jax.numpy as jnp

    from ccve_tpu.config import CompactionStrategy

    cfg = pipe.config
    thr = jnp.asarray(pipe.static_thresholds() if thresholds is None else thresholds, jnp.int32)
    ps = pipe.fresh_state()
    for cols, counts in chunk_batches(probe, cfg.n_joins, cfg.block_size, seg):
        ps = pipe._process(ps, jnp.asarray(cols), jnp.asarray(counts), thr)
    if cfg.strategy is not CompactionStrategy.NONE:
        ps = pipe._flush(ps, thr)
    return _out(ps.result_count, ps.result_stored, ps.result_rows, ps.level_steps,
                ps.level_rows, ps.occupancy)


def jax_run_device_tuner(pipe, probe: np.ndarray) -> dict:
    """JAX's device-tuner run, streamed (`_run_device_dynamic`), with its
    state read at the end."""
    import jax.numpy as jnp

    from ccve_tpu.control import device_bandit as db

    cfg = pipe.config
    arms = np.asarray(cfg.resolved_threshold_arms, np.int32)
    ps = pipe.fresh_state()
    bs = db.init_state(pipe.n_levels, len(arms))
    for cols, counts in chunk_batches(probe, cfg.n_joins, cfg.block_size,
                                      cfg.tuner_segment_chunks, pad=True):
        ps, bs = pipe._process_dyn_seg(ps, bs, jnp.asarray(cols), jnp.asarray(counts))
    greedy = arms[np.asarray(bs.est).argmax(1)]
    ps = pipe._flush(ps, jnp.asarray(greedy))
    return _out(ps.result_count, ps.result_stored, ps.result_rows, ps.level_steps,
                ps.level_rows, ps.occupancy, greedy_thresholds=greedy,
                bandit_committed=np.asarray(bs.committed),
                bandit_commit_t=np.asarray(bs.commit_t), bandit_est=np.asarray(bs.est))


def torch_run(pipe, probe: np.ndarray, seg: int, thresholds=None) -> dict:
    """The port's `JoinPipeline` driven as `jax_run` drives JAX's."""
    import torch

    from ccve_tpu_torch.config import CompactionStrategy

    cfg = pipe.config
    thr = np.asarray(pipe.static_thresholds() if thresholds is None else thresholds, np.int32)
    ps = pipe.fresh_state()
    for cols, counts in chunk_batches(probe, cfg.n_joins, cfg.block_size, seg):
        ps = pipe._process_chunks(ps, torch.from_numpy(cols), torch.from_numpy(counts), thr)
    if cfg.strategy is not CompactionStrategy.NONE:
        ps = pipe._flush_all(ps, thr)
    return _out(ps.result_count, ps.result_stored, ps.result_rows, ps.level_steps,
                ps.level_rows, ps.occupancy)


def pipelines(kind: str, n_joins: int, lhs: int, rhs: int, chunk_factor: int, strategy: str,
              result_capacity: int = 8192, prefilter=None, **cfg_kw):
    """The same cursor pipeline in both packages over `kind` ("lp" or
    "csr") tables of `gen_rhs_table(rhs, chunk_factor)`, `strategy` a
    CompactionStrategy name, config fields `cfg_kw` (the enums by name:
    payload_mode="FULL"); `prefilter` a function of a predicate module
    (`ops.filter` of either package). Returns (JAX pipeline, port
    pipeline, probe table, oracle rows in the config's payload mode)."""
    from ccve_tpu import config as jcfg
    from ccve_tpu.exec.pipeline import JoinPipeline as JaxPipeline
    from ccve_tpu.ops import filter as jflt
    from ccve_tpu.ops import hash_table as jht
    from ccve_tpu_torch import config as tcfg
    from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table
    from ccve_tpu_torch.exec.oracle import OracleBuildTable, oracle_pipeline
    from ccve_tpu_torch.exec.pipeline import JoinPipeline
    from ccve_tpu_torch.ops import filter as tflt
    from ccve_tpu_torch.ops import hash_table as tht

    payload = cfg_kw.pop("payload_mode", "FULL")
    common = dict(block_size=cfg_kw.pop("block_size", 128), n_joins=n_joins, lhs_size=lhs,
                  rhs_size=rhs, chunk_factor=chunk_factor, **cfg_kw)
    jc = jcfg.EngineConfig(strategy=jcfg.CompactionStrategy[strategy],
                           payload_mode=jcfg.PayloadMode[payload], **common)
    tc = tcfg.EngineConfig(strategy=tcfg.CompactionStrategy[strategy],
                           payload_mode=tcfg.PayloadMode[payload], **common)
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, chunk_factor)
    jb = jht.build_lp if kind == "lp" else jht.build_csr
    tb = tht.build_lp if kind == "lp" else tht.build_csr
    jpipe = JaxPipeline([jb(keys, payloads) for _ in range(n_joins)], jc,
                        result_capacity=result_capacity,
                        prefilter=None if prefilter is None else prefilter(jflt))
    tpipe = JoinPipeline([tb(keys, payloads, device="cpu") for _ in range(n_joins)], tc,
                         result_capacity=result_capacity,
                         prefilter=None if prefilter is None else prefilter(tflt))
    kept = probe if prefilter is None else probe[prefilter(_NumpyPredicates)(probe[:, 0])]
    want = oracle_pipeline(kept, [OracleBuildTable(keys, payloads)] * n_joins,
                           tcfg.PayloadMode[payload])
    return jpipe, tpipe, probe, want


class _NumpyPredicates:
    """`ops.filter`'s predicate constructors over numpy arrays."""

    @staticmethod
    def mod_eq(m, r):
        return lambda x: x % m == r

    @staticmethod
    def lt(c):
        return lambda x: x < c


def assert_same_run(got: dict, want: dict, rows: bool = True):
    """Count, work counters and histogram equal; rows as multisets."""
    from ccve_tpu_torch.exec.oracle import assert_same_multiset

    assert got["count"] == want["count"]
    for key in ("level_steps", "level_rows", "occupancy"):
        assert np.array_equal(got[key], want[key]), (key, got[key], want[key])
    if rows:
        assert_same_multiset(got["rows"], want["rows"])
