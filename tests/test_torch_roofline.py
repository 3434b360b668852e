"""The port's roofline slice on the CPU: #17's plain version against the JAX
package's compare-exchange kernel in Pallas interpret mode, the H100 model
against the plan the count side runs and against the JAX model's rows that
do not depend on the hardware, the report, the anchors on the host, and
`cli roofline`."""

import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ccve_tpu.bench import roofline as jax_roofline
from ccve_tpu.kernels import flatvec as fv
from ccve_tpu_torch import cli
from ccve_tpu_torch.bench import roofline
from ccve_tpu_torch.kernels import bigsort, merge_scan
from ccve_tpu_torch.kernels.ce_stages import TILE_LOG, ce_stages_i32, ce_stages_plain
from ccve_tpu_torch.ops import sort_merge as sm
from torch_interpret import interpret

ROOT = Path(__file__).resolve().parent.parent
R = 8  # the JAX kernel's [R, 128] tile, shrunk from 1024


def _jax_ce_stages(x: np.ndarray, K: int) -> np.ndarray:
    """`make_ce_kernel(K)` and its `pallas_call` as
    ccve_tpu/bench/roofline.py:208-235 compose them (a closure there, so
    mirrored here line for line), with R = 8."""

    def ce_kernel(x_ref, o_ref):
        x = x_ref[:]
        flat = fv.flat_index(R)
        for s in range(K):
            k = 1 << (s % 3)
            up = fv.shift_flat_left(x, k, R)
            dn = fv.shift_flat_right(x, k, R, 0)
            is_lo = (flat & k) == 0
            x = jnp.where(is_lo, jnp.minimum(x, up), jnp.maximum(x, dn))
        o_ref[:] = x

    rows = x.size // 128
    spec = pl.BlockSpec((R, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)

    def stages(x2d):
        with jax.enable_x64(False):
            return pl.pallas_call(
                ce_kernel,
                grid=(rows // R,),
                in_specs=[spec],
                out_specs=spec,
                out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.int32),
            )(x2d)

    return np.asarray(interpret(stages, jnp.asarray(x.reshape(rows, 128)))).reshape(-1)


@pytest.mark.parametrize("K", [1, 2, 3, 7, 16])
def test_ce_stages_plain_matches_jax(K):
    rng = np.random.default_rng(K)
    x = rng.integers(-(2**31), 2**31 - 1, 2 << TILE_LOG, dtype=np.int64).astype(np.int32)
    got = ce_stages_plain(torch.from_numpy(x), K)
    np.testing.assert_array_equal(got.numpy(), _jax_ce_stages(x, K))


@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("K", [0, 1, 5, 64])
def test_ce_stages_i32_on_cpu_is_the_plain_version(n_tiles, K):
    rng = np.random.default_rng(n_tiles + K)
    x = torch.from_numpy(rng.integers(0, 50, n_tiles << TILE_LOG).astype(np.int32))
    before = ce_stages_i32.launches
    got = ce_stages_i32(x, K)
    assert ce_stages_i32.launches == before  # nothing launched on the CPU
    assert torch.equal(got, ce_stages_plain(x, K))
    if K == 0:
        assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("x, K, error", [
    (torch.zeros(8191, dtype=torch.int32), 3, ValueError),
    (torch.zeros(8192, dtype=torch.int64), 3, TypeError),
    (torch.zeros((2, 8192), dtype=torch.int32), 3, ValueError),
    (torch.zeros(16384, dtype=torch.int32)[::2], 3, ValueError),
    (torch.zeros(8192, dtype=torch.int32), -1, ValueError),
])
def test_ce_stages_i32_refuses(x, K, error):
    with pytest.raises(error):
        ce_stages_i32(x, K)


class _Counting:
    """A kernel wrapper that counts its calls (the plain versions on the
    CPU count no launches)."""

    def __init__(self, fn):
        self.fn, self.calls, self.args = fn, 0, []

    def __call__(self, *args):
        self.calls += 1
        self.args.append(args)
        return self.fn(*args)


@pytest.mark.parametrize("m, n", [(1000, 20_000), (50, 30_000), (20_000, 9000),
                                  (300, 100_000), (1, 8193), (4000, 8193)])
def test_count_side_plan_is_what_the_count_side_runs(monkeypatch, m, n):
    """With the tile shrunk to 2^6, the model's plan equals
    `count_side_plan`'s, and its levels and runs are those that
    `sorted_match_totals` launches on the CPU path."""
    monkeypatch.setattr(bigsort, "TILE_LOG", 6)
    sort_tiles, merge_level = bigsort.KERNELS[torch.int32]
    merges = _Counting(merge_level)
    counts = _Counting(merge_scan.MERGE_COUNTS[torch.int32])
    monkeypatch.setitem(bigsort.KERNELS, torch.int32, (sort_tiles, merges))
    monkeypatch.setitem(merge_scan.MERGE_COUNTS, torch.int32, counts)
    rng = np.random.default_rng(m + n)
    keys, pays = rng.integers(0, 3 * m, m), rng.integers(-50, 50, m)
    probe = rng.integers(0, 3 * m, n).astype(np.int32)
    table = sm.build_sorted(keys, pays, device="cpu")
    count, checksum = sm.sorted_match_totals(table, torch.from_numpy(probe))

    plan = roofline.count_side_plan(m, n)
    n_pad, run_log = sm.count_side_plan(n, m, 6)
    assert (plan.n_pad, plan.tile_log, plan.run_log) == (n_pad, 6, run_log)
    assert plan.n_levels == merges.calls
    (runs, run_len, *_), = counts.args
    assert run_len == 1 << plan.run_log and -(-runs.numel() // run_len) == plan.n_runs
    hit = np.searchsorted(np.sort(keys), probe, "right") - np.searchsorted(np.sort(keys), probe)
    assert int(count) == int(hit.sum())


@pytest.mark.parametrize("m, n", [(1_000_000, 16_000_000), (50_000, 1_000_000),
                                  (1000, 300_000), (2_000_000, 20_000_000), (10, 1 << 24)])
def test_count_side_model_matches_jax_at_the_tpu_tile(m, n):
    """At tile_log = 17 (the JAX model's tile) the rows that do not depend
    on the hardware (pack, dot: bytes and stage passes; the presort's
    bytes) and the merge level and run counts equal the JAX model's. The
    presort's, merge-level and counts rows' work differs by design: the
    port's tile sort is 16 keys a thread in registers, then one shared-
    memory pass a merge-path round (13 at 2^17), where the TPU's is a
    bitonic network of 153 stages; its levels are merge-path passes bound
    by bandwidth (no stage work) where the TPU's are bitonic merges at 17
    stages a level, and its counts a binary search over the runs where the
    TPU's is a fused merge+counts scan."""
    ops = roofline.count_side_model(m, n, tile_log=17)
    want = jax_roofline.count_side_model(m, n)
    for i in (0, 4):
        assert (ops[i].bytes_hbm, ops[i].stage_passes) == (want[i].bytes_hbm,
                                                           want[i].stage_passes), i
    assert ops[1].bytes_hbm == want[1].bytes_hbm
    assert ops[1].stage_passes == 13 * ops[1].bytes_hbm // 8
    assert want[1].stage_passes == 153 * want[1].bytes_hbm // 8
    plan = roofline.count_side_plan(m, n, tile_log=17)
    levels, runs = re.search(r"x(\d+) levels .* -> (\d+) runs", want[2].name).groups()
    assert (plan.n_levels, plan.n_runs) == (int(levels), int(runs))
    assert f"x{plan.n_runs} runs" in want[3].name
    assert want[2].bytes_hbm == 2 * 4 * plan.n_pad * plan.n_levels == ops[2].bytes_hbm
    # by design: the port's merge levels do no stage work, the TPU's do
    assert ops[2].stage_passes == 0 and (plan.n_levels == 0 or want[2].stage_passes > 0)
    assert ops[3].stage_passes == 0 and want[3].stage_passes > 0


@pytest.mark.parametrize("n", [1, 100, 1 << sm.SMALL_PROBE_LOG])
def test_small_probes_are_not_modelled(n):
    with pytest.raises(ValueError, match="small-probe route"):
        roofline.count_side_model(1000, n)
    roofline.count_side_model(1000, (1 << sm.SMALL_PROBE_LOG) + 1)


def test_config1_model():
    """Config 1's operators: each speed-of-light is the larger bound; the
    tile sort is bound by its stages, everything else by bandwidth; the
    plan is the one the count side runs at the port's tile."""
    ops = roofline.count_side_model(1_000_000, 16_000_000)
    assert len(ops) == 5
    for op in ops:
        assert op.t_sol == max(op.t_hbm, op.t_alu)
    assert [op.bound for op in ops] == ["HBM", "ALU", "HBM", "HBM", "HBM"]
    plan = roofline.count_side_plan(1_000_000, 16_000_000)
    assert plan == roofline.CountSidePlan(16_007_168, bigsort.TILE_LOG, 21, 8, 8)
    assert ops[1].stage_passes == 9 * plan.n_pad  # 512 threads' runs, 9 merge-path rounds
    assert "9 merge-path rounds" in ops[1].name
    assert ops[2].t_hbm == pytest.approx(8 * 8 * plan.n_pad / roofline.BW_HBM)


def test_bound_ms():
    assert roofline.bound_ms(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert roofline.bound_ms(0, 67e9) == (pytest.approx(1.0), "operations")


def test_report_prints_every_row_and_the_measured_line():
    ops = roofline.count_side_model(1_000_000, 16_000_000)
    text = roofline.report(measured_s=2.5e-3)
    lines = text.splitlines()
    assert "H100" in lines[0]
    for op in ops:
        assert any(line.startswith(op.name) for line in lines), op.name
    total = sum(op.t_sol for op in ops)
    assert f"{total * 1e3:7.4f}ms" in lines[-3]
    assert lines[-2].startswith("bandwidth floor (read the probe keys once)")
    assert "unreachable" not in text
    assert lines[-1] == (f"measured: 2.5000 ms = {total / 2.5e-3 * 100:.1f}% of model "
                         f"speed-of-light ({16_000_000 / 2.5e-3 / 1e6:.1f}M rows/s)")
    assert "measured" not in roofline.report()


def test_measure_anchors_on_the_host():
    text = roofline.measure_anchors(n=1 << 16, niter=2, device="cpu")
    lines = text.splitlines()
    assert len(lines) == 3 and "host clock: not a device time" in lines[0]
    assert lines[1].startswith(" A. CE-stage kernel K-slope")
    assert lines[2].startswith(" B. library sort torch.sort [8, 8192] dim=1")


def test_measure_anchors_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.measure_anchors()
    with pytest.raises(ValueError, match="multiple"):
        roofline.measure_anchors(n=1000, device="cpu")


def _cli(*args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-m", "ccve_tpu_torch.cli", "roofline", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_cli_roofline_prints_the_report():
    proc = _cli("--n-build", "50000", "--n-probe", "1000000", "--measured-ms", "0.5")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == roofline.report(50_000, 1_000_000, 0.5e-3)


@pytest.mark.parametrize("args", [["--dist"], ["--n-levels", "2"], ["--dist", "--anchor"]])
def test_cli_roofline_dist_is_not_ported(args, capsys, monkeypatch):
    """The name is from before slice 9: `--dist` and `--n-levels` are ported
    now. `--dist` adds the distributed cost model to the report,
    `--n-levels` alone changes nothing (as in the JAX CLI), and `--anchor`
    still needs the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if "--anchor" in args:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["roofline", *args])
        return
    assert cli.main(["roofline", *args]) == 0
    out = capsys.readouterr()
    want = roofline.report(1_000_000, 16_000_000, None)
    if "--dist" in args:
        from ccve_tpu_torch.bench.dist_model import report_dist

        want += "\n\n" + report_dist(1_000_000, 16_000_000, 1)
    assert out.out.strip() == want and out.err == ""


def test_cli_roofline_anchor_needs_the_card_unless_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["roofline", "--anchor"])
    assert capsys.readouterr().out == ""  # refused before the report
    monkeypatch.setattr(roofline, "measure_anchors",
                        functools.partial(roofline.measure_anchors, n=1 << 14, niter=1))
    assert cli.main(["roofline", "--anchor", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("count-side join roofline on the H100")
    assert out[-2].startswith(" A. CE-stage kernel K-slope")
    assert out[-1].startswith(" B. library sort")


def test_one_round_of_ce_stages_is_a_fixed_point():
    """After one round of strides 1, 2, 4 no stage swaps anything: why
    csrc/ce_stages.cu stores both keys every stage instead of on a swap."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 2**30, 4 << TILE_LOG).astype(np.int32))
    once = ce_stages_plain(x, 3)
    assert not torch.equal(ce_stages_plain(x, 2), once)
    for K in (4, 5, 6, 16, 64):
        assert torch.equal(ce_stages_plain(x, K), once)
