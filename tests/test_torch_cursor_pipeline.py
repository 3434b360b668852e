"""The port's cursor executor (`JoinPipeline` over LP and CSR tables)
against the JAX package's at `tests/test_pipeline.py`'s sizes: the static
strategies over both table kinds, collecting tuples in FULL payload mode
with the Zebra histogram on, and in REFERENCE payload mode. Counts and `level_steps` exact, the
histograms equal, rows equal as multisets and to the numpy oracle's.
`run` is held to the same numbers as the segment-by-segment drive."""

import pytest

from ccve_tpu_torch.exec.oracle import assert_same_multiset
from torch_cursor import assert_same_run, jax_run, pipelines, torch_run


@pytest.mark.parametrize("kind", ["lp", "csr"])
@pytest.mark.parametrize("strategy", ["NONE", "FULL", "BINARY"])
def test_static_strategies_match_jax(kind, strategy):
    jpipe, tpipe, probe, want = pipelines(kind, 2, 700, 96, 2, strategy, collect_tuples=True,
                                          record_occupancy=True)
    j = jax_run(jpipe, probe, seg=2)
    t = torch_run(tpipe, probe, seg=2)
    assert_same_run(t, j)
    assert t["count"] == want.shape[0]
    assert_same_multiset(t["rows"], want)
    out = tpipe.run(probe, segment_chunks=2)
    assert out["count"] == want.shape[0] and not out["overflowed"]
    assert (out["level_steps"] == j["level_steps"]).all()
    assert (out["occupancy"] == j["occupancy"]).all()
    assert_same_multiset(out["rows"], want)
    pre = tpipe.run(probe, preload=True)
    assert pre["preloaded"] and pre["count"] == want.shape[0]
    assert_same_multiset(pre["rows"], want)


def test_reference_payload_mode():
    jpipe, tpipe, probe, want = pipelines("csr", 2, 400, 64, 1, "FULL", collect_tuples=True,
                                          payload_mode="REFERENCE")
    t = torch_run(tpipe, probe, seg=3)
    assert_same_run(t, jax_run(jpipe, probe, seg=3))
    assert_same_multiset(t["rows"], want)
    # REFERENCE: each level's first column is never written (0)
    assert (t["rows"][:, 2] == 0).all() and (t["rows"][:, 4] == 0).all()
