"""The port's cursor executor against the JAX package's under per-level
and DYNAMIC thresholds: per-level static thresholds, a three-level
cascade, DYNAMIC at fixed thresholds (the `level_rows` occupancy signal),
the device tuner (its greedy thresholds, commits, estimates and the work
counters its rewards read, exactly) and the host tuner (the oracle's rows;
its arms follow the host clock, so no two runs need agree on them)."""

import numpy as np

from ccve_tpu_torch.control.bandit import CompactTuner
from ccve_tpu_torch.exec.oracle import assert_same_multiset
from torch_cursor import (
    assert_same_run,
    jax_run,
    jax_run_device_tuner,
    pipelines,
    torch_run,
)


def test_per_level_thresholds():
    """FULL at level 0 only: level 1 passes every chunk through."""
    jpipe, tpipe, probe, want = pipelines("lp", 2, 600, 48, 2, "FULL", collect_tuples=True,
                                          compact_threshold_per_level=(128, 0))
    t = torch_run(tpipe, probe, seg=2)
    assert_same_run(t, jax_run(jpipe, probe, seg=2))
    assert_same_multiset(t["rows"], want)


def test_three_level_cascade():
    """chunk factor 4: every hit fans out 4x a level, the tiny-chunk
    cascade compaction exists for."""
    jpipe, tpipe, probe, want = pipelines("csr", 3, 220, 32, 4, "BINARY", collect_tuples=True,
                                          result_capacity=1 << 17)
    t = torch_run(tpipe, probe, seg=2)
    assert_same_run(t, jax_run(jpipe, probe, seg=2))
    assert_same_multiset(t["rows"], want)
    assert np.all(t["level_steps"] > 0)


def test_dynamic_at_fixed_thresholds_counts_rows():
    """Under DYNAMIC the executor also sums each level's live scan rows
    over its steps: equal to JAX's, level by level."""
    jpipe, tpipe, probe, want = pipelines("csr", 2, 900, 64, 2, "DYNAMIC",
                                          threshold_arms=(0, 32, 64, 128))
    thresholds = np.array([64, 32], np.int32)
    t = torch_run(tpipe, probe, seg=3, thresholds=thresholds)
    j = jax_run(jpipe, probe, seg=3, thresholds=thresholds)
    assert_same_run(t, j, rows=False)
    assert t["count"] == want.shape[0] and t["level_rows"].min() > 0


def test_device_tuner_matches_jax():
    """The device tuner, streamed: its greedy thresholds, commits, commit
    rounds and estimates equal JAX's, and so do the counters its causally
    shifted rewards read."""
    jpipe, tpipe, probe, want = pipelines(
        "csr", 2, 4000, 64, 2, "DYNAMIC", collect_tuples=True, result_capacity=1 << 14,
        device_tuner=True, threshold_arms=(0, 32, 64, 128), tuner_segment_chunks=2,
        bandit_commit_after=3)
    j = jax_run_device_tuner(jpipe, probe)
    t = tpipe.run(probe)
    assert_same_run(t, j)
    assert_same_multiset(t["rows"], want)
    for key in ("greedy_thresholds", "bandit_committed", "bandit_commit_t"):
        assert np.array_equal(t[key], j[key]), (key, t[key], j[key])
    assert np.array_equal(t["bandit_est"], j["bandit_est"])
    assert (t["bandit_committed"] >= 0).any()
    pre = tpipe.run(probe, preload=True)
    assert pre["count"] == want.shape[0]
    assert np.array_equal(pre["greedy_thresholds"], j["greedy_thresholds"])


def test_host_tuner_matches_oracle():
    _, tpipe, probe, want = pipelines("lp", 2, 1200, 64, 2, "DYNAMIC", collect_tuples=True,
                                      threshold_arms=(0, 32, 64, 128))
    out = tpipe.run(probe, segment_chunks=2, tuner=CompactTuner())
    assert out["count"] == want.shape[0]
    assert_same_multiset(out["rows"], want)
    assert out["level_rows"].sum() > 0
