"""The port's cursor executor against the JAX package's in count-only
runs and behind a prefilter (its composed selection vector, not
re-densified), over LP and CSR. Counts and `level_steps` exact,
histograms equal, rows as multisets."""

import pytest

from ccve_tpu_torch.exec.oracle import assert_same_multiset
from torch_cursor import assert_same_run, jax_run, pipelines, torch_run


@pytest.mark.parametrize("kind, n_joins", [("lp", 3), ("csr", 2)])
def test_count_only(kind, n_joins):
    jpipe, tpipe, probe, want = pipelines(kind, n_joins, 900, 64, 2, "FULL",
                                          record_occupancy=True)
    t = torch_run(tpipe, probe, seg=4)
    assert_same_run(t, jax_run(jpipe, probe, seg=4), rows=False)
    assert t["count"] == want.shape[0] and tpipe.width == n_joins
    assert tpipe.run(probe)["count"] == want.shape[0]


def test_prefilter_keeps_the_sparse_selection():
    """mod_eq(10, 0) before level 0: level 0 is probed through the
    filter's selection vector, so its steps scan under-filled chunks."""
    jpipe, tpipe, probe, want = pipelines("csr", 2, 2000, 100, 2, "FULL", collect_tuples=True,
                                          payload_mode="REFERENCE",
                                          prefilter=lambda f: f.mod_eq(10, 0))
    t = torch_run(tpipe, probe, seg=4)
    assert_same_run(t, jax_run(jpipe, probe, seg=4))
    assert_same_multiset(t["rows"], want)
    assert tpipe.run(probe)["count"] == want.shape[0]
