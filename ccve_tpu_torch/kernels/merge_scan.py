"""Per-build-row probe counts from sorted probe runs.

Counterpart of `ccve_tpu.kernels.merge_scan.merge_counts_fused`, summed
over the runs of an early-stopped sort: `merge_counts_i32` (kernel
csrc/merge_counts.cu) takes the whole buffer of runs in one launch.
"""

from __future__ import annotations

import torch

from ccve_tpu_torch.kernels import _build


def merge_counts_plain(
    runs: torch.Tensor, run_len: int, n_real: int, b32: torch.Tensor, m: int
) -> torch.Tensor:
    """`merge_counts_i32` as searchsorted upper minus lower bound, summed
    over the runs, on any device."""
    want = b32 - 1
    bc = torch.zeros(m, dtype=torch.int64, device=b32.device)
    for lo in range(0, n_real, run_len):
        run = runs[lo : min(lo + run_len, n_real)]
        bc += torch.searchsorted(run, want, right=True)
        bc -= torch.searchsorted(run, want)
    return bc.to(torch.int32)


def merge_counts_i32(
    runs: torch.Tensor, run_len: int, n_real: int, b32: torch.Tensor, m: int
) -> torch.Tensor:
    """bc int32[m]: bc[j] = the number of real probes p with
    p == b32[j] - 1, over every run.

    `runs` is int32[n_pad] made of ascending runs of `run_len` values (the
    last may be shorter) whose first `n_real` values are the real probes
    (packed `key' << 1`); the rest is padding and never counted. `b32` is
    the ascending build stream (`key' << 1 | 1`, keys may repeat: every row
    of a key gets that key's full count)."""
    _build.check_i32(runs, "runs")
    _build.check_i32(b32, "b32")
    if b32.numel() != m:
        raise ValueError(f"b32 has {b32.numel()} values, m = {m}")
    if run_len < 1:
        raise ValueError(f"run_len {run_len} < 1")
    if not 0 <= n_real <= runs.numel():
        raise ValueError(f"n_real {n_real} outside [0, {runs.numel()}]")
    if runs.device != b32.device:
        raise ValueError(f"runs on {runs.device}, b32 on {b32.device}")
    if runs.device.type == "cpu":
        return merge_counts_plain(runs, run_len, n_real, b32, m)
    bc = torch.empty(m, dtype=torch.int32, device=b32.device)
    if m:
        code = _build.load().ccve_merge_counts_i32(
            runs.data_ptr(), run_len, n_real, b32.data_ptr(), m,
            bc.data_ptr(), _build.stream(runs),
        )
        _build.check(code, "merge_counts_i32")
        merge_counts_i32.launches += 1
    return bc


merge_counts_i32.launches = 0
