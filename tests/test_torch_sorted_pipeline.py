"""The port's sorted-chunk executor (`exec.sorted_pipeline.SortedPipeline`,
on the CPU) against the numpy oracle and the JAX package's SortedPipeline
with its XLA drain (`use_kernel=False`): counts exactly, collected rows as
multisets (the row order is not part of the contract). Count-only runs take
the fused drain (the twin of kernel #10 here); `use_kernel=False` takes
the torch drain."""

import dataclasses

import numpy as np
import pytest
import torch

from ccve_tpu.config import CompactionStrategy as JStrategy
from ccve_tpu.config import EngineConfig as JConfig
from ccve_tpu.config import PayloadMode as JPayload
from ccve_tpu.exec.sorted_pipeline import SortedPipeline as JSortedPipeline
from ccve_tpu.ops.sort_merge import build_sorted as jax_build_sorted
from ccve_tpu_torch.config import CompactionStrategy, EngineConfig, PayloadMode
from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table
from ccve_tpu_torch.exec.oracle import OracleBuildTable, assert_same_multiset, oracle_pipeline
from ccve_tpu_torch.exec.pipeline import JoinPipeline
from ccve_tpu_torch.exec.sorted_pipeline import SortedPipeline
from ccve_tpu_torch.ops import filter as flt
from ccve_tpu_torch.ops.sort_merge import build_sorted

BLOCK = 128
STRATEGIES = [CompactionStrategy.NONE, CompactionStrategy.FULL, CompactionStrategy.BINARY]


def _setup(n_joins, lhs, rhs, chunk_factor, strategy, payload_mode=PayloadMode.REFERENCE,
           collect=True, **cfg_kw):
    cfg = EngineConfig(block_size=BLOCK, n_joins=n_joins, lhs_size=lhs, rhs_size=rhs,
                       chunk_factor=chunk_factor, strategy=strategy,
                       payload_mode=payload_mode, collect_tuples=collect, **cfg_kw)
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, chunk_factor)
    tables = [build_sorted(keys, payloads, device="cpu")] * n_joins
    expected = oracle_pipeline(probe, [OracleBuildTable(keys, payloads)] * n_joins, payload_mode)
    return cfg, probe, tables, expected, (keys, payloads)


def _jax_run(cfg, probe, keys, payloads, capacity=None):
    """The JAX package's SortedPipeline on the same configuration, XLA
    drain."""
    jcfg = JConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name not in ("strategy", "payload_mode")
    }, strategy=JStrategy(cfg.strategy.value), payload_mode=JPayload(cfg.payload_mode.value))
    tables = [jax_build_sorted(keys, payloads)] * cfg.n_joins
    return JSortedPipeline(tables, jcfg, result_capacity=capacity, use_kernel=False).run(probe)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("payload_mode", [PayloadMode.REFERENCE, PayloadMode.FULL])
def test_collected_rows_match_oracle(strategy, payload_mode):
    cfg, probe, tables, expected, _ = _setup(2, 700, 96, 2, strategy, payload_mode)
    out = SortedPipeline(tables, cfg, result_capacity=8192).run(probe)
    assert out["count"] == expected.shape[0] and not out["overflowed"]
    assert_same_multiset(out["rows"], expected)


@pytest.mark.parametrize("strategy", [CompactionStrategy.FULL, CompactionStrategy.BINARY])
def test_collected_rows_match_jax(strategy):
    cfg, probe, tables, expected, (keys, payloads) = _setup(
        3, 300, 48, 3, strategy, PayloadMode.FULL)
    out = SortedPipeline(tables, cfg, result_capacity=1 << 14).run(probe)
    want = _jax_run(cfg, probe, keys, payloads, capacity=1 << 14)
    assert out["count"] == want["count"] == expected.shape[0]
    assert_same_multiset(out["rows"], want["rows"])


def test_capacity_cuts_stored_rows():
    cfg, probe, tables, expected, _ = _setup(2, 700, 96, 2, CompactionStrategy.FULL)
    out = SortedPipeline(tables, cfg, result_capacity=100).run(probe)
    assert out["count"] == expected.shape[0] > 100
    assert out["overflowed"] and out["rows"].shape == (100, 6)


def test_per_level_thresholds():
    cfg, probe, tables, expected, _ = _setup(
        3, 500, 64, 2, CompactionStrategy.FULL, PayloadMode.FULL,
        compact_threshold_per_level=(0, BLOCK, 0))
    out = SortedPipeline(tables, cfg, result_capacity=1 << 15).run(probe)
    assert out["count"] == expected.shape[0]
    assert_same_multiset(out["rows"], expected)
    counting = SortedPipeline(tables, dataclasses.replace(cfg, collect_tuples=False))
    assert counting._fused_drain_ok
    assert counting.run(probe)["count"] == expected.shape[0]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("n_joins, chunk_factor", [(1, 1), (2, 2), (4, 1), (2, 3)])
def test_count_only_fused_matches_torch_drain_and_oracle(strategy, n_joins, chunk_factor):
    cfg, probe, tables, expected, _ = _setup(n_joins, 700, 96, chunk_factor, strategy,
                                             collect=False)
    fused = SortedPipeline(tables, cfg)
    torch_drain = SortedPipeline(tables, cfg, use_kernel=False)
    assert fused._fused_drain_ok and not torch_drain._fused_drain_ok
    assert fused.run(probe)["count"] == torch_drain.run(probe)["count"] == expected.shape[0]


@pytest.mark.parametrize("strategy", [CompactionStrategy.FULL, CompactionStrategy.BINARY])
def test_count_only_matches_jax(strategy):
    cfg, probe, tables, expected, (keys, payloads) = _setup(2, 900, 64, 3, strategy,
                                                            collect=False)
    assert SortedPipeline(tables, cfg).run(probe)["count"] == \
        _jax_run(cfg, probe, keys, payloads)["count"] == expected.shape[0]


def _chunked(probe, block):
    n = probe.shape[0]
    S = -(-n // block)
    cols = np.zeros((S * block, probe.shape[1]), np.int64)
    cols[:n] = probe
    chunk_cols = torch.from_numpy(np.ascontiguousarray(
        cols.reshape(S, block, probe.shape[1]).transpose(0, 2, 1)))
    counts = torch.full((S,), block, dtype=torch.int32)
    counts[-1] -= S * block - n
    return chunk_cols, counts


@pytest.mark.parametrize("thresholds", [(BLOCK, BLOCK, BLOCK, 0), (BLOCK // 2, 0, BLOCK, 0)])
def test_fused_caches_match_torch_drain(thresholds):
    """After a segment, the fused route's caches (mult planes written back
    as rank columns) equal the torch drain's on their live prefix, and the
    flush completes both to the oracle's count."""
    cfg, probe, tables, expected, _ = _setup(
        4, 1500, 64, 2, CompactionStrategy.FULL, collect=False,
        compact_threshold_per_level=thresholds)
    chunk_cols, counts = _chunked(probe, BLOCK)
    thr = np.asarray(thresholds, np.int32)
    pipes = [SortedPipeline(tables, cfg), SortedPipeline(tables, cfg, use_kernel=False)]
    states = [p._process_chunks(p.fresh_state(), chunk_cols, counts, thr) for p in pipes]
    (fused, torch_drain), c0 = states, pipes[0]._rank_col0
    assert int(fused.result_count) == int(torch_drain.result_count)
    assert torch.equal(fused.cache_count, torch_drain.cache_count)
    assert int(fused.cache_count.sum()) > 0
    for level in range(cfg.n_joins - 1):
        live = int(fused.cache_count[level])
        got = fused.cache_cols[level, c0 + level + 1 :, :live] >> 32
        want = torch_drain.cache_cols[level, c0 + level + 1 :, :live] >> 32
        assert torch.equal(got, want), level
    for pipe, ps in zip(pipes, states):
        assert int(pipe._flush_all(ps, thr).result_count) == expected.shape[0]


def test_prefilter_and_uneven_tail():
    cfg, probe, tables, _, (keys, payloads) = _setup(1, 701, 64, 2, CompactionStrategy.FULL,
                                                     collect=False)
    kept = probe[probe[:, 0] % 3 == 0]
    want = oracle_pipeline(kept, [OracleBuildTable(keys, payloads)]).shape[0]
    for use_kernel in (True, False):
        pipe = SortedPipeline(tables, cfg, prefilter=flt.mod_eq(3, 0), use_kernel=use_kernel)
        assert pipe._fused_drain_ok == use_kernel
        assert pipe.run(probe)["count"] == want
    collecting = SortedPipeline(tables, dataclasses.replace(cfg, collect_tuples=True),
                                prefilter=flt.mod_eq(3, 0))
    assert_same_multiset(collecting.run(probe)["rows"],
                         oracle_pipeline(kept, [OracleBuildTable(keys, payloads)]))


@pytest.mark.parametrize("collect", [False, True])
def test_streamed_segments_match_preload(collect):
    cfg, probe, tables, expected, _ = _setup(3, 1100, 64, 2, CompactionStrategy.BINARY,
                                             collect=collect)
    pipe = SortedPipeline(tables, cfg, result_capacity=1 << 15)
    streamed = pipe.run(probe, segment_chunks=2)
    preloaded = pipe.run(probe, preload=True)
    assert streamed["chunks"] == preloaded["chunks"] == 9 and preloaded["preloaded"]
    assert streamed["count"] == preloaded["count"] == expected.shape[0]
    if collect:
        assert_same_multiset(streamed["rows"], preloaded["rows"])


@pytest.mark.parametrize("collect", [False, True])
def test_wide_keys(collect):
    """Keys spread over 2^45: the ranks come from the int64 stats route."""
    rng = np.random.default_rng(3)
    keys = np.sort(rng.integers(0, 1 << 45, 64).astype(np.int64))
    payloads = np.arange(64, dtype=np.int64) + 7
    probe = np.stack([
        np.concatenate([keys[rng.integers(0, 64, 200)], rng.integers(0, 1 << 40, 200)])
        for _ in range(2)], axis=1)
    rng.shuffle(probe, axis=0)
    cfg = EngineConfig(block_size=BLOCK, n_joins=2, lhs_size=400, rhs_size=64,
                       strategy=CompactionStrategy.FULL, payload_mode=PayloadMode.FULL,
                       collect_tuples=collect)
    tables = [build_sorted(keys, payloads, device="cpu")] * 2
    assert tables[0].pack32 is None and tables[0].span62
    expected = oracle_pipeline(probe, [OracleBuildTable(keys, payloads)] * 2, PayloadMode.FULL)
    out = SortedPipeline(tables, cfg, result_capacity=1 << 15).run(probe)
    assert out["count"] == expected.shape[0]
    if collect:
        assert_same_multiset(out["rows"], expected)


def test_unported_parts_raise():
    """Only the cursor executor (slice 6) still raises. DYNAMIC, the
    occupancy histograms, the chunk rank mode and zebra_profile, which
    raised before the tuner slice, now run to the oracle's count."""
    cfg, probe, tables, expected, (keys, payloads) = _setup(2, 300, 64, 1,
                                                            CompactionStrategy.FULL,
                                                            collect=False)
    want = expected.shape[0]
    assert SortedPipeline(tables, dataclasses.replace(
        cfg, strategy=CompactionStrategy.DYNAMIC)).run(probe)["count"] == want
    occ = SortedPipeline(tables, dataclasses.replace(cfg, record_occupancy=True)).run(probe)
    assert occ["count"] == want and occ["occupancy"].sum() > 0
    assert SortedPipeline(tables, cfg, rank_mode="chunk").run(probe)["count"] == want
    zebra = SortedPipeline(tables, dataclasses.replace(cfg, record_occupancy=True)).run(
        probe, zebra_profile=True)
    assert zebra["count"] == want and zebra["zebra_segments"] >= 1
    from ccve_tpu_torch.ops.hash_table import build_csr

    with pytest.raises(NotImplementedError, match="cursor"):
        JoinPipeline([build_csr(keys, payloads, device="cpu")] * 2, cfg).run(probe)
    with pytest.raises(TypeError):
        SortedPipeline([build_csr(keys, payloads, device="cpu")] * 2, cfg)


@pytest.mark.parametrize("n_joins, block, lhs", [(6, 2048, 5000), (2, 8192, 20000)])
def test_fused_drain_repaired_shapes_match_jax(n_joins, block, lhs):
    """Shapes the fused drain refused before its repair (ROADMAP Queue 3
    #1): a count-only FULL run counts what the oracle and JAX's fused route
    (Pallas interpret mode) count, on the fused route and the torch
    drain."""
    cfg = EngineConfig(block_size=block, n_joins=n_joins, lhs_size=lhs, rhs_size=256,
                       strategy=CompactionStrategy.FULL)
    probe = gen_probe_table(lhs, n_joins, 256)
    keys, payloads = gen_rhs_table(256, 1)
    tables = [build_sorted(keys, payloads, device="cpu")] * n_joins
    want = oracle_pipeline(probe, [OracleBuildTable(keys, payloads)] * n_joins).shape[0]
    jcfg = JConfig(block_size=block, n_joins=n_joins, lhs_size=lhs, rhs_size=256,
                   strategy=JStrategy.FULL)
    jax_count = JSortedPipeline([jax_build_sorted(keys, payloads)] * n_joins, jcfg,
                                interpret=True).run(probe)["count"]
    fused = SortedPipeline(tables, cfg)
    assert fused._fused_drain_ok
    assert fused.run(probe)["count"] == jax_count == want > 0
    assert SortedPipeline(tables, cfg, use_kernel=False).run(probe)["count"] == want


def test_engine_config_matches_jax():
    """The same fields, defaults, checks and derived thresholds."""
    assert [f.name for f in dataclasses.fields(EngineConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]
    for block in (256, 2048):
        for strategy in STRATEGIES:
            ours = EngineConfig(block_size=block, strategy=strategy)
            theirs = JConfig(block_size=block, strategy=JStrategy(strategy.value))
            assert ours.compact_threshold == theirs.compact_threshold
            assert ours.resolved_threshold_arms == theirs.resolved_threshold_arms
    for bad in (dict(block_size=100), dict(n_joins=0), dict(chunk_factor=0),
                dict(compact_threshold_per_level=(1, 2))):
        with pytest.raises(ValueError):
            EngineConfig(**bad)
    with pytest.raises(ValueError):
        EngineConfig(n_joins=1, compact_threshold_per_level=(1,))  # NONE
