"""Scans of the sort-merge join's sorted streams.

 - `merge_counts_i32` (kernel csrc/merge_counts.cu): per-build-row probe
   counts from sorted probe runs, the counterpart of
   `ccve_tpu.kernels.merge_scan.merge_counts_fused` summed over the runs of
   an early-stopped sort, all runs in one launch.
 - `merge_stats_i32` (kernel csrc/merge_stats.cu): per-probe match count
   and matched-payload sum over the merged build and probe stream, the
   counterpart of `merge_scan_stats32` followed by its unsort sort: the
   kernel writes each probe's result to its row directly.
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


I32_MAX = 2**31 - 1


def merge_stats_plain(s: torch.Tensor, v: torch.Tensor, n: int):
    """`merge_stats_i32` as torch scans (cumsums, each run's start found
    by a cumsum over the run starts and a scatter, then a scatter to the
    probe rows), on any device."""
    mult = torch.zeros(n, dtype=torch.int32, device=s.device)
    psum = torch.zeros(n, dtype=torch.int64, device=s.device)
    length = s.numel()
    if not length:
        return mult, psum
    key = s >> 1
    run_start = torch.ones(length, dtype=torch.bool, device=s.device)
    run_start[1:] = key[1:] != key[:-1]
    is_build = (s & 1) == 0
    ib = is_build.to(torch.int64)
    bpay = torch.where(is_build, v.to(torch.int64), 0)
    count = ib.cumsum(0)
    total = bpay.cumsum(0)
    run = run_start.cumsum(0) - 1  # run_start[0] holds: runs number from 0
    start = torch.zeros(length + 1, dtype=torch.int64, device=s.device)
    start.scatter_(0, torch.where(run_start, run, length),
                   torch.arange(length, device=s.device))
    start = start[run]
    probe = ~is_build & (s != I32_MAX) & (v >= 0) & (v < n)
    rows = v[probe].to(torch.int64)
    mult[rows] = (count - (count - ib)[start])[probe].to(torch.int32)
    psum[rows] = (total - (total - bpay)[start])[probe]
    return mult, psum


def merge_stats_i32(s: torch.Tensor, v: torch.Tensor, n: int):
    """(mult int32[n], psum int64[n]) in probe-row order from the merged
    ascending stream `s` of `key' << 1 | tag` (builds even, probes odd,
    INT32_MAX padding) and its cargo plane `v` (a build's payload, any
    sign, or a probe's row id in [0, n)): for each probe row, the number
    of builds with its key and the sum of their payloads. Rows that no
    probe of the stream names stay 0."""
    _build.check_i32(s, "s")
    _build.check_i32(v, "v")
    if v.numel() != s.numel() or v.device != s.device:
        raise ValueError(f"v has {v.numel()} values on {v.device}, s {s.numel()} on {s.device}")
    if n < 0:
        raise ValueError(f"n {n} < 0")
    if s.device.type == "cpu":
        return merge_stats_plain(s, v, n)
    mult = torch.zeros(n, dtype=torch.int32, device=s.device)
    psum = torch.zeros(n, dtype=torch.int64, device=s.device)
    if s.numel():
        lib = _build.load()
        scratch = torch.empty(
            lib.ccve_merge_stats_scratch_bytes(s.numel()), dtype=torch.uint8,
            device=s.device,
        )
        code = lib.ccve_merge_stats_i32(
            s.data_ptr(), v.data_ptr(), s.numel(), n, scratch.data_ptr(),
            mult.data_ptr(), psum.data_ptr(), _build.stream(s),
        )
        _build.check(code, "merge_stats_i32")
        merge_stats_i32.launches += 1
    return mult, psum


merge_stats_i32.launches = 0
