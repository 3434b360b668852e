"""The port's distributed cost model (`bench/dist_model.py`) against the
JAX package's (`ccve_tpu/bench/dist_model.py`): the byte counts of every
plan equal JAX's on every topology, the link constants are the H100
platform's (none of JAX's TPU figures), and the structural claims of
`tests/test_dist_model.py` are held where they still hold with those
constants; `cli roofline --dist` prints the report."""

import pytest

from ccve_tpu.bench import dist_model as jm

from ccve_tpu_torch import cli
from ccve_tpu_torch.bench import dist_model as tm
from ccve_tpu_torch.bench import roofline

TOPOLOGIES = [(1, 1), (1, 2), (1, 4), (1, 8), (2, 1), (2, 2), (2, 8), (4, 8), (8, 8)]


@pytest.mark.parametrize("n_probe", [1_000_000, 16_000_000, 999_999])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_byte_counts_equal_jax(topology, n_probe):
    d, i = topology
    for ours, theirs in ((tm.flat_shuffle_cost, jm.flat_shuffle_cost),
                         (tm.hier_shuffle_cost, jm.hier_shuffle_cost)):
        a, b = ours(n_probe, d, i), theirs(n_probe, d, i)
        assert (a.name, a.bytes_ici, a.bytes_dcn) == (b.name, b.bytes_ici, b.bytes_dcn)
    a, b = tm.bcast_cost(n_probe // 10, d, i), jm.bcast_cost(n_probe // 10, d, i)
    assert (a.bytes_ici, a.bytes_dcn) == (b.bytes_ici, b.bytes_dcn)


def test_no_tpu_constant():
    assert not any(hasattr(tm, name) for name in ("ICI_LINK_BW", "DCN_HOST_BW",
                                                  "DCN_MSG_OVERHEAD", "t_a2a_ring"))
    assert (tm.NVLINK_BW, tm.IB_GPU_BW) == (450e9, 50e9)
    # NVSwitch: a GPU sends the (P - 1) / P of its bytes that leave it at its rate
    assert tm.t_a2a(8e9, 8) == pytest.approx(8e9 * 7 / 8 / 450e9)
    assert tm.t_a2a(1e9, 1) == 0.0


def test_bcast_beats_the_per_key_shuffles_across_nodes():
    """JAX's first claim, ordering: bcast > hier > 0 and bcast > flat at
    2x8 and 4x8. Its bar (2x8 bcast efficiency >= 0.80) does not hold at
    the H100's rates: compute a GPU at (1M build, 1M probe) is 0.031 ms,
    so bcast's amortized copy and all-reduce (0.012 ms) weigh more."""
    for topo in ((2, 8), (4, 8)):
        flat, hier, bc = (tm.predict(1_000_000, 16_000_000, topologies=(topo,), shuffle=s,
                                     n_batches=8 if s == "bcast" else 1)[0]
                          for s in ("flat", "hier", "bcast"))
        assert bc.efficiency > hier.efficiency > 0
        assert bc.efficiency > flat.efficiency
    two = tm.predict(1_000_000, 16_000_000, topologies=((2, 8),), shuffle="bcast",
                     n_batches=8)[0]
    assert 0.5 < two.efficiency < 0.80


def test_bcast_cost_is_one_time_and_scales_with_build():
    a, b = tm.bcast_cost(1_000_000, 2, 8), tm.bcast_cost(2_000_000, 2, 8)
    assert b.bytes_dcn == 2 * a.bytes_dcn
    one = tm.bcast_cost(1_000_000, 1, 8)
    assert one.bytes_dcn == 0 and one.t_dcn == 0.0
    e1, e8 = (tm.predict(1_000_000, 16_000_000, topologies=((4, 8),), shuffle="bcast",
                         n_batches=k)[0] for k in (1, 8))
    assert e8.t_comm < e1.t_comm and e8.efficiency > e1.efficiency


def test_per_level_shuffles_recur_per_level():
    for fn in (tm.flat_shuffle_cost, tm.hier_shuffle_cost):
        c = fn(16_000_000, 2, 8)
        assert c.bytes_dcn > 0 and c.t_dcn > 0
    one, two = (tm.predict(1_000_000, 16_000_000, n_levels=k, topologies=((2, 8),),
                           shuffle="hier")[0] for k in (1, 2))
    assert abs(two.t_comm - 2 * one.t_comm) / two.t_comm < 1e-6


def test_ranking_on_one_node():
    """On one node of 2 or 4 GPUs, config 5 ranks bcast first (no per-key
    traffic), then flat and hier (hier's one-node hop B is a copy to
    itself); on one GPU every plan costs the same."""
    for p in (2, 4):
        assert tm.ranking(100_000, 1_000_000, 1, p)[0] == "bcast"
    assert sorted(tm.ranking(100_000, 1_000_000, 1, 1)) == ["bcast", "flat", "hier"]


def test_report_renders_all_plans():
    r = tm.report_dist()
    for token in ("flat", "hier", "bcast", "eff", "NVLink", "InfiniBand"):
        assert token in r


@pytest.mark.parametrize("args", [["--dist"], ["--n-levels", "2"], ["--dist", "--n-levels", "2"]])
def test_cli_roofline_dist(args, capsys):
    assert cli.main(["roofline", "--n-build", "100000", "--n-probe", "1000000", *args]) == 0
    out = capsys.readouterr().out
    want = roofline.report(100_000, 1_000_000, None)
    if "--dist" in args:
        levels = int(args[-1]) if "--n-levels" in args else 1
        want += "\n\n" + tm.report_dist(100_000, 1_000_000, levels)
    assert out.strip() == want
