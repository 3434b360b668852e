"""The cursor executor on the card against its own CPU path: the staged
scan (hash through kernel #12, counted) and `JoinPipeline` give the same
cursors, counts, work counters, bandit choices and rows on CUDA tensors as
on CPU ones. Every test needs an NVIDIA GPU and skips without one. No JAX
here: run on a machine without it as
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cursor_cuda.py
"""

import numpy as np
import pytest
import torch

from ccve_tpu_torch.config import CompactionStrategy, EngineConfig, PayloadMode
from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table
from ccve_tpu_torch.exec.oracle import OracleBuildTable, assert_same_multiset, oracle_pipeline
from ccve_tpu_torch.exec.pipeline import JoinPipeline
from ccve_tpu_torch.kernels import murmur
from ccve_tpu_torch.ops import hash_table as ht

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cursor path hashes with a CUDA kernel)")
    return torch.device("cuda")


def _tables(kind, device):
    keys, payloads = gen_rhs_table(300, 3)
    build = ht.build_lp if kind == "lp" else ht.build_csr
    return build(keys, payloads, device="cpu"), build(keys, payloads, device=device)


@pytest.mark.parametrize("kind", ["lp", "csr"])
def test_scan_on_the_card_equals_cpu(cuda, kind):
    cpu_t, dev_t = _tables(kind, cuda)
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(0, 600, 2048))
    sel = torch.from_numpy(np.concatenate([np.sort(rng.choice(2048, 900, replace=False)),
                                           np.zeros(1148, np.int64)]))
    probe = ht.lp_probe if kind == "lp" else ht.csr_probe
    before = murmur.murmurhash64_i64.launches
    a = probe(cpu_t, keys, sel, 900)
    b = probe(dev_t, keys.to(cuda), sel.to(cuda), 900)
    assert murmur.murmurhash64_i64.launches == before + 1
    while a.count:
        assert b.count == a.count
        for field in ("cursor", "end", "sel"):
            assert torch.equal(getattr(b, field).cpu(), getattr(a, field)), field
        ra, rb = ht.scan_next(cpu_t, keys, a), ht.scan_next(dev_t, keys.to(cuda), b)
        assert rb.result_count == ra.result_count
        assert torch.equal(rb.result_vector.cpu(), ra.result_vector)
        assert torch.equal(rb.matched_payloads.cpu(), ra.matched_payloads)
        a, b = ra.state, rb.state
    assert b.count == 0


def test_batched_scan_on_the_card(cuda):
    cpu_t, dev_t = _tables("csr", cuda)
    grid = torch.from_numpy(np.random.default_rng(2).integers(0, 600, (8, 256)))
    sel = torch.arange(256).expand(8, 256).contiguous()
    count = torch.full((8,), 256, dtype=torch.int32)
    a = ht.csr_probe(cpu_t, grid, sel, count)
    b = ht.csr_probe(dev_t, grid.to(cuda), sel.to(cuda), count.to(cuda))
    while int(a.count.max()):
        assert torch.equal(b.count.cpu(), a.count)
        ra, rb = ht.scan_next(cpu_t, grid, a), ht.scan_next(dev_t, grid.to(cuda), b)
        assert torch.equal(rb.result_count.cpu(), ra.result_count)
        a, b = ra.state, rb.state


@pytest.mark.parametrize("kind", ["lp", "csr"])
@pytest.mark.parametrize("strategy", ["NONE", "FULL", "DYNAMIC"])
def test_pipeline_on_the_card_equals_cpu(cuda, kind, strategy):
    """Collecting tuples with the histogram on (DYNAMIC: the device tuner):
    the same count, counters, histogram, bandit choices and rows."""
    cfg = EngineConfig(block_size=256, n_joins=2, lhs_size=6000, rhs_size=300, chunk_factor=3,
                       strategy=CompactionStrategy[strategy], payload_mode=PayloadMode.FULL,
                       collect_tuples=True, record_occupancy=True, tuner_segment_chunks=2,
                       threshold_arms=(0, 64, 128, 256), device_tuner=strategy == "DYNAMIC",
                       bandit_commit_after=3)
    probe = gen_probe_table(6000, 2, 300)
    keys, payloads = gen_rhs_table(300, 3)
    want = oracle_pipeline(probe, [OracleBuildTable(keys, payloads)] * 2, PayloadMode.FULL)
    build = ht.build_lp if kind == "lp" else ht.build_csr
    outs = [JoinPipeline([build(keys, payloads, device=d)] * 2, cfg,
                         result_capacity=1 << 15).run(probe) for d in ("cpu", cuda)]
    for key in ("level_steps", "level_rows", "occupancy"):
        assert np.array_equal(outs[1][key], outs[0][key]), key
    if strategy == "DYNAMIC":
        for key in ("greedy_thresholds", "bandit_committed", "bandit_commit_t", "bandit_est"):
            assert np.array_equal(outs[1][key], outs[0][key]), key
    assert outs[1]["count"] == want.shape[0]
    assert_same_multiset(outs[1]["rows"], want)


def test_prefilter_on_the_card(cuda):
    from ccve_tpu_torch.ops import filter as flt

    cfg = EngineConfig(block_size=256, n_joins=1, strategy=CompactionStrategy.FULL,
                       chunk_factor=2)
    probe = gen_probe_table(20000, 1, 1000)
    keys, payloads = gen_rhs_table(1000, 2)
    kept = probe[probe[:, 0] % 10 == 0]
    want = oracle_pipeline(kept, [OracleBuildTable(keys, payloads)]).shape[0]
    pipe = JoinPipeline([ht.build_csr(keys, payloads, device=cuda)], cfg,
                        prefilter=flt.mod_eq(10, 0))
    assert pipe.run(probe)["count"] == want
    assert pipe.run(probe, preload=True)["count"] == want
