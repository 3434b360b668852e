"""Per-operator roofline of the count-side join on the NVIDIA H100.

Counterpart of `ccve_tpu.bench.roofline`, with the same public names, for
the algorithm the port runs and the card it runs on. For each operator of
the int32 count side (`ops.sort_merge.sorted_match_totals` with `pack32`:
pack, tile sort, merge-path levels, merge counts, payload dot) it reports

  bytes_hbm   device-memory bytes moved (reads + writes)
  t_hbm       bytes / BW_HBM                   (bandwidth bound)
  t_alu       shared-memory passes over the tile x STAGE_COST (a
              compare-exchange stage, or a merge-path round: one store and
              one load of each key and a barrier)
  bound       which of the two binds (the larger)

and the totals, so "x % of speed-of-light" names the binding resource of
each operator.

The constants are the card's, and all of them are here (`chip_smoke.py`
reads its bounds from this module):

  BW_HBM        3.35e12 B/s, the H100 SXM's HBM3 (NVIDIA's data sheet)
  ALU_OPS_PER_S 67e12 op/s, its non-tensor float32 rate, taken as the rate
                of one integer compare or add (the data sheet gives no
                int32 rate)
  STAGE_COST    0.24115e-12 s per element per compare-exchange stage of
                a tile in shared memory: anchor A's K-slope
                (`measure_anchors`), the median of two runs of `python -m
                ccve_tpu_torch.cli roofline --anchor` on an NVIDIA H100 80GB
                HBM3 at a 700.00 W power limit (0.2420 and 0.2403 ps; PERF.md),
                with csrc/ce_stages.cu's bank-conflict-free stages: 1.01x
                the card's shared-memory floor, SMEM_BYTES_PER_CLOCK on 132
                SMs at 1.98 GHz (`smem_floor_ms`: 0.2391 ps). The first
                design's 2-way bank conflicts read 0.5002-0.5017 ps.

The merge counts are one streaming read of each run's slices, staged in
shared memory (csrc/merge_counts.cu), so their row is priced by its bytes
like the levels'. What the model does not price: the small-probe route
(n_probe <= 2^SMALL_PROBE_LOG), for which `count_side_model` raises.

Run `python -m ccve_tpu_torch.cli roofline [--n-build N --n-probe N]
[--measured-ms MS] [--anchor]`.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ccve_tpu_torch.device import require_device
from ccve_tpu_torch.kernels import bigsort
from ccve_tpu_torch.kernels.ce_stages import TILE_LOG as CE_TILE_LOG, ce_stages_i32
from ccve_tpu_torch.ops import sort_merge

BW_HBM = 3.35e12  # B/s, H100 SXM HBM3
ALU_OPS_PER_S = 67e12  # op/s, H100 SXM non-tensor float32, as one integer op
STAGE_COST = 0.24115e-12  # s per element per CE stage, anchor A on the H100
I32 = 4
ANCHOR_REPEATS = 7  # turns of the anchors' three timed runs
TILE_ITEMS = 16  # keys a thread of the tile sort sorts in registers (csrc/sort_tiles.cu)
SMEM_BYTES_PER_CLOCK = 128  # an SM's shared memory: 32 banks of 4 bytes a clock


@dataclass
class OpModel:
    name: str
    bytes_hbm: int
    stage_passes: float  # CE stage passes x elements

    @property
    def t_hbm(self) -> float:
        return self.bytes_hbm / BW_HBM

    @property
    def t_alu(self) -> float:
        return self.stage_passes * STAGE_COST

    @property
    def t_sol(self) -> float:
        return max(self.t_hbm, self.t_alu)

    @property
    def bound(self) -> str:
        return "ALU" if self.t_alu > self.t_hbm else "HBM"


def smem_rate() -> tuple[int, float]:
    """(SMs, the largest SM clock in Hz) of the current card: the SMs from
    `torch.cuda.get_device_properties`, the clock from `nvidia-smi
    --query-gpu=clocks.max.sm`."""
    index = torch.cuda.current_device()
    mhz = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return torch.cuda.get_device_properties(index).multi_processor_count, float(mhz) * 1e6


def smem_floor_ms(n: int, n_stages: int, sms: int, clock_hz: float) -> float:
    """The least ms of `n_stages` passes over n int32 keys in shared memory
    (one load and one store of each key a pass, as a compare-exchange stage
    of csrc/ce_stages.cu makes) at SMEM_BYTES_PER_CLOCK a clock on each of
    `sms` SMs."""
    return 2 * I32 * n * n_stages / (sms * SMEM_BYTES_PER_CLOCK * clock_hz) * 1e3


def stage_line(stages, ms) -> tuple[float, float, float]:
    """(slope in ms a stage, intercept in ms, the largest |t - line| / t)
    of the least-squares line through the times `ms` at `stages`: where
    the times lie on one line, the slope is the cost of a stage alone."""
    stages, ms = np.asarray(stages, float), np.asarray(ms, float)
    slope, intercept = np.polyfit(stages, ms, 1)
    return float(slope), float(intercept), float(np.max(np.abs(ms - (slope * stages + intercept))
                                                        / ms))


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take to move
    `nbytes` through HBM and to do `ops` integer operations."""
    by_bytes = nbytes / BW_HBM * 1e3
    by_ops = ops / ALU_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


class CountSidePlan(NamedTuple):
    n_pad: int  # probes padded to a tile multiple
    tile_log: int
    run_log: int  # the probe stream is sorted into runs of 2^run_log
    n_levels: int  # merge levels launched
    n_runs: int


def count_side_plan(n_build: int, n_probe: int, tile_log: int | None = None) -> CountSidePlan:
    """The shape of the count side's tile route for n_probe probes against
    n_build builds, from `ops.sort_merge.count_side_plan` with the tile
    that `_count_side` uses (`bigsort.TILE_LOG`, read per call, unless
    `tile_log` is given)."""
    if n_probe <= 1 << sort_merge.SMALL_PROBE_LOG:
        raise ValueError(
            f"n_probe {n_probe} <= 2^{sort_merge.SMALL_PROBE_LOG} takes the small-probe "
            "route (one sort, #5 and #4), which this model does not price"
        )
    tile_log = bigsort.TILE_LOG if tile_log is None else tile_log
    n_pad, run_log = sort_merge.count_side_plan(n_probe, n_build, tile_log)
    return CountSidePlan(n_pad, tile_log, run_log, run_log - tile_log, -(-n_pad >> run_log))


def merge_rounds(tile_log: int) -> int:
    """Merge-path rounds of csrc/sort_tiles.cu's tile sort: log2 of its
    threads, one a TILE_ITEMS-key run."""
    return max(tile_log - TILE_ITEMS.bit_length() + 1, 0)


def count_side_model(n_build: int, n_probe: int, tile_log: int | None = None) -> list[OpModel]:
    """Operator list of `sorted_match_totals`' int32 count side as the port
    runs it (`ops.sort_merge._count_side`): pack, the tile sort
    (TILE_ITEMS keys a thread sorted in registers, which touches no shared
    memory, then `merge_rounds` merge-path rounds, each one store and one
    load of every key in shared memory and a barrier: priced as a stage
    pass apiece), merge-path levels (one read and one write of the stream
    a level, no stage work), the merge counts over every run (one read of
    the run buffer and of b, one write of bc: each run's slices are read
    once into shared memory and counted there), and the payload dot."""
    plan = count_side_plan(n_build, n_probe, tile_log)
    n_pad, m, tl = plan.n_pad, n_build, plan.tile_log
    rounds = merge_rounds(tl)
    return [
        OpModel("pack_i32 (probe keys -> key' << 1)", 2 * I32 * n_probe, 0),
        OpModel(f"tile sort, {TILE_ITEMS} keys a thread in registers, then {rounds} "
                f"merge-path rounds in shared memory (2^{tl} tiles)",
                2 * I32 * n_pad, rounds * n_pad),
        OpModel(f"merge-path levels x{plan.n_levels} (-> {plan.n_runs} runs of "
                f"2^{plan.run_log})", 2 * I32 * n_pad * plan.n_levels, 0),
        OpModel(f"merge counts x{plan.n_runs} runs (each run's slices staged and counted "
                "in shared memory)", I32 * (n_pad + 2 * m), 0),
        OpModel("payload dot (bc . payloads)", (I32 + 8) * m, 0),
    ]


def report(
    n_build: int = 1_000_000,
    n_probe: int = 16_000_000,
    measured_s: float | None = None,
) -> str:
    ops = count_side_model(n_build, n_probe)
    w = max(len(op.name) for op in ops)
    lines = [
        f"count-side join roofline on the H100 SXM @ {n_build / 1e6:.1f}M build / "
        f"{n_probe / 1e6:.1f}M probe (HBM {BW_HBM / 1e9:.0f} GB/s, stage "
        f"{STAGE_COST * 1e12:.5g} ps/elem)",
        f"{'operator':{w}s} {'MB':>8s} {'t_hbm':>9s} {'t_alu':>9s} {'t_sol':>9s} bound",
    ]
    for op in ops:
        lines.append(
            f"{op.name:{w}s} {op.bytes_hbm / 1e6:8.1f} {op.t_hbm * 1e3:7.4f}ms "
            f"{op.t_alu * 1e3:7.4f}ms {op.t_sol * 1e3:7.4f}ms {op.bound}"
        )
    tot_hbm = sum(op.t_hbm for op in ops)
    tot_alu = sum(op.t_alu for op in ops)
    tot_sol = sum(op.t_sol for op in ops)
    lines.append(
        f"{'TOTAL (speed-of-light, serial ops)':{w}s} {'':8s} {tot_hbm * 1e3:7.4f}ms "
        f"{tot_alu * 1e3:7.4f}ms {tot_sol * 1e3:7.4f}ms"
    )
    lines.append(
        f"bandwidth floor (read the probe keys once): {I32 * n_probe / BW_HBM * 1e3:.4f} ms"
    )
    if measured_s is not None:
        lines.append(
            f"measured: {measured_s * 1e3:.4f} ms = {tot_sol / measured_s * 100:.1f}% of "
            f"model speed-of-light ({n_probe / measured_s / 1e6:.1f}M rows/s)"
        )
    return "\n".join(lines)


ANCHOR_RUN = 1 << CE_TILE_LOG  # anchor B's rows: the port's sort tile, 8192 keys
ANCHOR_STAGES = CE_TILE_LOG * (CE_TILE_LOG + 1) // 2  # a bitonic network over them: 91


def _seconds(run, device: torch.device) -> float:
    """Seconds of one call of `run`: CUDA events on the card, the host
    clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def _spread_ms(ts: list[float]) -> str:
    return f"{np.median(ts) * 1e3:.4f} ms [{min(ts) * 1e3:.4f}, {max(ts) * 1e3:.4f}]"


def measure_anchors(n: int = 1 << 24, niter: int = 16, device="cuda") -> str:
    """Two cross-checks of STAGE_COST, so the speed-of-light is not graded
    by constants calibrated from the very kernels it grades:

      A. the K-slope of a compare-exchange kernel that is not the engine's
         (`kernels.ce_stages`, csrc/ce_stages.cu): `niter` chained launches
         (each on the previous output) at K = 16 and at K = 64 stages,
         (t64 - t16) / 48 / n, so the device-memory round trip and the
         launch cost difference away;
      B. the library's own sort, `torch.sort` of [n / 8192, 8192] rows
         along dim 1, `niter` calls on the unsorted data, per element per
         stage of a bitonic network over 8192 keys (91): what the library
         pays per stage.

    Data: `np.random.default_rng(11).integers(0, 2**30, n)` as int32 on
    `device` (default the card; raises without one). Times are medians of
    ANCHOR_REPEATS turns of A16, A64, B, with min and max: CUDA events on the
    card, the host clock with `device="cpu"` (labelled so)."""
    device = require_device(device)
    if n % ANCHOR_RUN:
        raise ValueError(f"n {n} is not a multiple of {ANCHOR_RUN}")
    rng = np.random.default_rng(11)
    x0 = torch.from_numpy(rng.integers(0, 2**30, n).astype(np.int32)).to(device)

    def stage_chain(n_stages: int):
        y = x0
        for _ in range(niter):
            y = ce_stages_i32(y, n_stages)

    def library_sort():
        for _ in range(niter):
            torch.sort(x0.view(-1, ANCHOR_RUN), dim=1)

    runs = {"t16": lambda: stage_chain(16), "t64": lambda: stage_chain(64),
            "sort": library_sort}
    for run in runs.values():  # warm-up
        run()
    times = {name: [] for name in runs}
    for _ in range(ANCHOR_REPEATS):
        for name, run in runs.items():
            times[name].append(_seconds(run, device) / niter)
    t16, t64, t_sort = (float(np.median(times[k])) for k in ("t16", "t64", "sort"))
    a_cost = (t64 - t16) / 48 / n
    b_cost = t_sort / (n * ANCHOR_STAGES)
    where = (f"{torch.cuda.get_device_name(device)}, CUDA events" if device.type == "cuda"
             else "the host's CPU, host clock: not a device time")
    return (
        f"STAGE_COST anchors @ n={n / 1e6:.1f}M i32 on {where}, {niter} chained calls, "
        f"median [min, max] of {ANCHOR_REPEATS} (model constant {STAGE_COST * 1e12:.5g} "
        f"ps/elem/stage):\n"
        f" A. CE-stage kernel K-slope (t64 {_spread_ms(times['t64'])} / t16 "
        f"{_spread_ms(times['t16'])}): {a_cost * 1e12:.4f} ps/elem/stage "
        f"= {a_cost / STAGE_COST:.2f}x model\n"
        f" B. library sort torch.sort [{n // ANCHOR_RUN}, {ANCHOR_RUN}] dim=1: "
        f"{_spread_ms(times['sort'])} / {ANCHOR_STAGES} bitonic stages -> "
        f"{b_cost * 1e12:.4f} ps/elem/stage = {b_cost / STAGE_COST:.2f}x model"
    )


if __name__ == "__main__":
    print(report())
