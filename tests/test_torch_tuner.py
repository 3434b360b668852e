"""The tuner slice of the sorted-chunk executor against the numpy oracle and
the JAX package's SortedPipeline: DYNAMIC with the host and the device
tuner, the Zebra occupancy histograms and their profiler, and the chunk
rank mode. Counts, histograms, work counters, arms, selection counts and
commits exactly; bandit estimates at rtol 1e-6 (float32 `log` and `sqrt`
may differ by an ulp between XLA on the CPU and torch). The port's fused
route runs the twin of kernel #10 here and is held to JAX's fused route
(Pallas interpret mode) or, where the two routes agree (two levels), to its
XLA drain; the port's torch drain (`use_kernel=False`) to JAX's XLA drain."""

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
from ccve_tpu_torch.control.bandit import CompactTuner
from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table
from ccve_tpu_torch.exec.oracle import OracleBuildTable, assert_same_multiset, oracle_pipeline
from ccve_tpu_torch.exec.sorted_pipeline import SortedPipeline
from ccve_tpu_torch.ops.sort_merge import build_sorted
from ccve_tpu_torch.utils.profiler import ZebraProfiler

BLOCK = 128
DYNAMIC = CompactionStrategy.DYNAMIC
BANDIT_INTS = ("bandit_n_sel", "bandit_committed", "bandit_commit_t", "greedy_thresholds")


def _setup(n_joins, lhs, rhs, chunk_factor, strategy, collect=False,
           payload_mode=PayloadMode.REFERENCE, **cfg_kw):
    cfg = EngineConfig(block_size=BLOCK, n_joins=n_joins, lhs_size=lhs, rhs_size=rhs,
                       chunk_factor=chunk_factor, strategy=strategy, payload_mode=payload_mode,
                       collect_tuples=collect, **cfg_kw)
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, chunk_factor)
    tables = [build_sorted(keys, payloads, device="cpu")] * n_joins
    expected = oracle_pipeline(probe, [OracleBuildTable(keys, payloads)] * n_joins, payload_mode)
    return cfg, probe, tables, expected, (keys, payloads)


def _jax_pipe(cfg, keys, payloads, **kw):
    jcfg = JConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name not in ("strategy", "payload_mode")
    }, strategy=JStrategy(cfg.strategy.value), payload_mode=JPayload(cfg.payload_mode.value))
    return JSortedPipeline([jax_build_sorted(keys, payloads)] * cfg.n_joins, jcfg, **kw)


def _same_bandit(got, want):
    assert got["count"] == want["count"]
    np.testing.assert_allclose(got["bandit_est"], np.asarray(want["bandit_est"]), rtol=1e-6)
    for key in BANDIT_INTS:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(got["occupancy"], np.asarray(want["occupancy"]))


def _chunked(probe, block=BLOCK):
    n = probe.shape[0]
    S = -(-n // block)
    cols = np.zeros((S * block, probe.shape[1]), np.int64)
    cols[:n] = probe
    chunk_cols = np.ascontiguousarray(cols.reshape(S, block, probe.shape[1]).transpose(0, 2, 1))
    counts = np.full(S, block, np.int32)
    counts[-1] -= S * block - n
    return chunk_cols, counts


@pytest.mark.parametrize("preload", [False, True])
def test_host_tuner_matches_oracle(preload):
    """DYNAMIC with the host tuner: the collected rows (torch drain) and the
    count-only run (fused route) equal the oracle, streamed and
    preloaded, and the tuner's bandits saw every segment."""
    cfg, probe, tables, expected, _ = _setup(2, 600, 64, 2, DYNAMIC, collect=True,
                                             payload_mode=PayloadMode.FULL,
                                             threshold_arms=(0, 32, 64, 128),
                                             tuner_segment_chunks=2)
    tuner = CompactTuner()
    out = SortedPipeline(tables, cfg, result_capacity=8192).run(probe, tuner=tuner,
                                                                preload=preload)
    assert out["count"] == expected.shape[0] and not out["overflowed"]
    assert_same_multiset(out["rows"], expected)
    assert tuner.bandit_size() == 2
    assert sum(sum(b.n_select) for b in tuner._bandits) == out["chunks"] // 2 + 2
    counting = SortedPipeline(tables, dataclasses.replace(cfg, collect_tuples=False))
    assert counting._fused_drain_ok
    assert counting.run(probe, preload=preload)["count"] == expected.shape[0]


@pytest.mark.parametrize("preload", [False, True])
def test_device_tuner_two_levels_matches_jax(preload):
    """The device tuner at two levels, count only: the port's fused route
    (the twin) against JAX's XLA drain, and, preloaded, its fused route in
    interpret mode (the two JAX routes agree at two levels)."""
    cfg, probe, tables, expected, (keys, payloads) = _setup(
        2, 900, 96, 1, DYNAMIC, device_tuner=True, tuner_segment_chunks=2)
    pipe = SortedPipeline(tables, cfg)
    assert pipe._fused_drain_ok
    got = pipe.run(probe, preload=preload)
    assert got["count"] == expected.shape[0]
    _same_bandit(got, _jax_pipe(cfg, keys, payloads, use_kernel=False).run(probe, preload=preload))
    if preload:
        _same_bandit(got, _jax_pipe(cfg, keys, payloads, interpret=True).run(probe, preload=True))
    assert got["bandit_n_sel"].sum() == 2 * -(-got["chunks"] // 2)


def test_device_tuner_three_levels_torch_drain_matches_jax():
    """Three levels, where the two routes' work counters differ: the
    port's torch drain against JAX's XLA drain, streamed, with collected
    rows."""
    cfg, probe, tables, expected, (keys, payloads) = _setup(
        3, 2500, 64, 2, DYNAMIC, collect=True, payload_mode=PayloadMode.FULL, device_tuner=True,
        tuner_segment_chunks=2, threshold_arms=(0, 64, BLOCK), bandit_commit_after=3)
    got = SortedPipeline(tables, cfg, result_capacity=1 << 15, use_kernel=False).run(probe)
    want = _jax_pipe(cfg, keys, payloads, result_capacity=1 << 15, use_kernel=False).run(probe)
    _same_bandit(got, want)
    assert got["count"] == expected.shape[0]
    assert_same_multiset(got["rows"], expected)
    assert (got["bandit_committed"] >= 0).any()


@pytest.mark.parametrize("route", ["fused", "torch_drain"])
def test_work_counters_match_jax_route_for_route(route):
    """One segment at three levels under DYNAMIC: level_steps, level_rows,
    cache counts and the count after the flush equal the JAX package's on
    the same route (fused: JAX's Pallas kernel in interpret mode; torch
    drain: JAX's XLA drain)."""
    import jax

    cfg, probe, tables, expected, (keys, payloads) = _setup(
        3, 1100, 96, 2, DYNAMIC, device_tuner=True)
    fused = route == "fused"
    pipe = SortedPipeline(tables, cfg, use_kernel=fused)
    jpipe = _jax_pipe(cfg, keys, payloads, use_kernel=False, interpret=fused)
    assert pipe._fused_drain_ok == jpipe._fused_drain_ok == fused
    chunk_cols, counts = _chunked(probe)
    thr = np.array([BLOCK, BLOCK // 2, BLOCK], np.int32)
    ps = pipe._process_chunks(pipe.fresh_state(), torch.from_numpy(chunk_cols),
                              torch.from_numpy(counts), thr)
    jps = jax.tree.map(np.asarray, jpipe._process(
        jpipe.fresh_state(), jax.numpy.asarray(chunk_cols), jax.numpy.asarray(counts),
        jax.numpy.asarray(thr)))
    for name in ("level_steps", "level_rows", "cache_count"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(), getattr(jps, name),
                                      err_msg=name)
    assert int(ps.result_count) == int(jps.result_count)
    assert ps.level_steps.sum() > 0
    flushed = pipe._flush_all(ps, thr)
    assert int(flushed.result_count) == expected.shape[0]


@pytest.mark.parametrize("strategy, n_joins", [
    (CompactionStrategy.NONE, 2), (CompactionStrategy.FULL, 2),
    (CompactionStrategy.BINARY, 2), (CompactionStrategy.FULL, 3),
])
def test_record_occupancy_routes_match(strategy, n_joins):
    """The occupancy histograms bin for bin: the port's fused route (the
    twin of #10's variant), its torch drain and JAX's XLA drain; every
    count equals the oracle's."""
    cfg, probe, tables, expected, (keys, payloads) = _setup(
        n_joins, 700, 96, 2, strategy, record_occupancy=True)
    fused = SortedPipeline(tables, cfg)
    torch_drain = SortedPipeline(tables, cfg, use_kernel=False)
    assert fused._fused_drain_ok and not torch_drain._fused_drain_ok
    outs = [fused.run(probe), torch_drain.run(probe),
            _jax_pipe(cfg, keys, payloads, use_kernel=False).run(probe)]
    for out in outs:
        assert out["count"] == expected.shape[0]
    np.testing.assert_array_equal(outs[0]["occupancy"], outs[1]["occupancy"])
    np.testing.assert_array_equal(outs[0]["occupancy"], np.asarray(outs[2]["occupancy"]))
    assert outs[0]["occupancy"].sum() > 0
    assert outs[0]["occupancy"][n_joins - 1].sum() > 0  # the last level records too


def test_zebra_profile_segments(tmp_path):
    """run(zebra_profile=True): per-segment measured attribution over at
    least eight segments, the histogram calls summing to the occupancy's
    total, CSVs written; it needs record_occupancy and refuses the device
    tuner."""
    cfg, probe, tables, expected, _ = _setup(2, 2000, 96, 2, CompactionStrategy.FULL,
                                             record_occupancy=True, tuner_segment_chunks=2)
    zebra = ZebraProfiler.get()
    zebra.clear()
    pipe = SortedPipeline(tables, cfg)
    out = pipe.run(probe, zebra_profile=True)
    assert out["count"] == expected.shape[0]
    assert out["zebra_segments"] >= 8
    calls = seconds = 0
    for level in range(2):
        hist = zebra.histogram(f"level{level}_full_compaction")
        calls += sum(c for _, c in hist.values())
        seconds += sum(t for t, _ in hist.values())
    assert calls == int(out["occupancy"].sum()) > 0 and seconds > 0
    zebra.to_csv(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "level0_full_compaction.csv", "level1_full_compaction.csv"]
    zebra.clear()
    assert pipe.run(probe, preload=True)["count"] == out["count"]
    with pytest.raises(ValueError, match="record_occupancy"):
        SortedPipeline(tables, dataclasses.replace(cfg, record_occupancy=False)).run(
            probe, zebra_profile=True)
    with pytest.raises(ValueError, match="device-tuner"):
        SortedPipeline(tables, dataclasses.replace(cfg, strategy=DYNAMIC, device_tuner=True)).run(
            probe, zebra_profile=True)
    zebra.clear()


@pytest.mark.parametrize("strategy", [CompactionStrategy.FULL, CompactionStrategy.BINARY])
def test_chunk_rank_mode_matches_batched_and_jax(strategy):
    """rank_mode="chunk" (#11's twin on the CPU) against the batched mode
    and JAX's chunk mode (its XLA ranks): row multisets on a
    duplicate-heavy three-way join, and the count-only run against the
    oracle (chunk mode never takes the fused drain)."""
    cfg, probe, tables, expected, (keys, payloads) = _setup(
        3, 300, 48, 3, strategy, collect=True, payload_mode=PayloadMode.FULL)
    chunk = SortedPipeline(tables, cfg, result_capacity=1 << 17, rank_mode="chunk")
    batched = SortedPipeline(tables, cfg, result_capacity=1 << 17)
    want = _jax_pipe(cfg, keys, payloads, result_capacity=1 << 17, use_kernel=False,
                     rank_mode="chunk").run(probe)
    got = chunk.run(probe)
    assert got["count"] == want["count"] == expected.shape[0] and not got["overflowed"]
    assert_same_multiset(got["rows"], np.asarray(want["rows"]))
    assert_same_multiset(got["rows"], batched.run(probe)["rows"])
    counting = SortedPipeline(tables, dataclasses.replace(cfg, collect_tuples=False),
                              rank_mode="chunk")
    assert not counting._fused_drain_ok
    assert counting.run(probe, preload=True)["count"] == expected.shape[0]


def test_chunk_rank_mode_with_tuner_and_occupancy():
    """Chunk mode under the device tuner with the histograms on: the same
    bandit trajectory, histograms and count as the batched torch drain
    (the ranks differ in where they come from, not in value)."""
    cfg, probe, tables, expected, _ = _setup(
        3, 700, 64, 2, DYNAMIC, record_occupancy=True, device_tuner=True,
        tuner_segment_chunks=2, threshold_arms=(0, BLOCK))
    got = SortedPipeline(tables, cfg, rank_mode="chunk").run(probe)
    want = SortedPipeline(tables, cfg, use_kernel=False).run(probe)
    _same_bandit(got, want)
    assert got["count"] == expected.shape[0] and got["occupancy"].sum() > 0


def test_fused_drain_support_matrix():
    """Which runs ride the fused drain (the JAX package's
    test_fused_drain_support_matrix): count-only statics, DYNAMIC and the
    occupancy histograms do; collecting tuples, the chunk rank mode and
    more than 64 drain paths do not."""
    def mk(capacity=0, occupancy=False, chunk_factor=1, strategy=CompactionStrategy.FULL,
           rank_mode="batched", n_joins=2, use_kernel=True):
        cfg = EngineConfig(block_size=BLOCK, n_joins=n_joins, lhs_size=256, rhs_size=64,
                           chunk_factor=chunk_factor, strategy=strategy,
                           collect_tuples=capacity > 0, record_occupancy=occupancy)
        keys, payloads = gen_rhs_table(64, chunk_factor)
        tables = [build_sorted(keys, payloads, device="cpu") for _ in range(n_joins)]
        return SortedPipeline(tables, cfg, result_capacity=capacity or None,
                              use_kernel=use_kernel, rank_mode=rank_mode)

    assert mk()._fused_drain_ok
    assert mk(strategy=DYNAMIC)._fused_drain_ok
    assert mk(strategy=CompactionStrategy.NONE)._fused_drain_ok
    assert mk(occupancy=True)._fused_drain_ok
    assert mk(chunk_factor=8)._fused_drain_ok  # 8 paths (2 levels)
    assert not mk(capacity=8192)._fused_drain_ok
    assert not mk(rank_mode="chunk")._fused_drain_ok
    assert not mk(chunk_factor=65, n_joins=3)._fused_drain_ok
    assert not mk(use_kernel=False)._fused_drain_ok
    with pytest.raises(ValueError, match="rank_mode"):
        mk(rank_mode="tiled")
