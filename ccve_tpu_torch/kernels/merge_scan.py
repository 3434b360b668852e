"""Scans of the sort-merge join's sorted streams, for int32 or int64 keys.

 - `merge_counts_i32` / `merge_counts_i64` (kernel csrc/merge_counts.cu):
   per-build-row probe counts from sorted probe runs, the counterpart of
   `ccve_tpu.kernels.merge_scan.merge_counts_fused` (int32) and of
   `merge_scan_build_counts64` after `merge_sorted_i64_limbs` (int64),
   summed over the runs of an early-stopped sort, all runs in one launch.
 - `merge_stats_i32` / `merge_stats_i64` (kernel csrc/merge_stats.cu):
   per-probe match count and matched-payload sum over the merged build and
   probe stream, the counterpart of `merge_scan_stats32` (int32) and of
   `merge_scan_stats` (int64, the wide stats path), each followed by its
   unsort sort: the kernel writes each probe's result to its row directly.
"""

from __future__ import annotations

import torch

from ccve_tpu_torch.kernels import _build
from ccve_tpu_torch.kernels.bigsort import PAD


PLAIN_SEARCHES = 1 << 22  # (run, build row) searches a batch of the plain counts


def _run_counts(runs: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """int64[m]: Σ over the rows of `runs` (sorted rows, [R, L]) of the
    entries equal to each `want` + 1, as upper minus lower bound."""
    w = want.expand(runs.shape[0], -1).contiguous()
    hi = torch.searchsorted(runs, w, right=True)
    return (hi - torch.searchsorted(runs, w)).sum(0)


def merge_counts_plain(
    runs: torch.Tensor, run_len: int, n_real: int, b: torch.Tensor, m: int
) -> torch.Tensor:
    """`merge_counts_i32` / `merge_counts_i64` as searchsorted upper minus
    lower bound, summed over the runs, on any device. The whole runs are
    searched as rows of one batch (PLAIN_SEARCHES searches at a time), so
    many short runs cost a few calls, not one each."""
    want = b - 1
    bc = torch.zeros(m, dtype=torch.int64, device=b.device)
    n_full = n_real // run_len
    rows = runs[: n_full * run_len].reshape(n_full, run_len)
    step = max(PLAIN_SEARCHES // max(m, 1), 1)
    for lo in range(0, n_full, step):
        bc += _run_counts(rows[lo : lo + step], want)
    if n_full * run_len < n_real:
        bc += _run_counts(runs[n_full * run_len : n_real].reshape(1, -1), want)
    return bc.to(torch.int32)


def _merge_counts(wrapper, runs, run_len, n_real, b, m, dtype) -> torch.Tensor:
    _build.check_int(runs, "runs", dtype)
    _build.check_int(b, "b", dtype)
    if b.numel() != m:
        raise ValueError(f"b has {b.numel()} values, m = {m}")
    if run_len < 1:
        raise ValueError(f"run_len {run_len} < 1")
    if not 0 <= n_real <= runs.numel():
        raise ValueError(f"n_real {n_real} outside [0, {runs.numel()}]")
    if runs.device != b.device:
        raise ValueError(f"runs on {runs.device}, b on {b.device}")
    if runs.device.type == "cpu":
        return merge_counts_plain(runs, run_len, n_real, b, m)
    bc = torch.empty(m, dtype=torch.int32, device=b.device)
    if m:
        entry = getattr(_build.load(), f"ccve_merge_counts_{_build.SUFFIX[dtype]}")
        code = entry(
            runs.data_ptr(), run_len, n_real, b.data_ptr(), m, bc.data_ptr(),
            _build.stream(runs),
        )
        _build.check(code, wrapper.__name__)
        wrapper.launches += 1
    return bc


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
    return _merge_counts(merge_counts_i32, runs, run_len, n_real, b32, m, torch.int32)


def merge_counts_i64(
    runs: torch.Tensor, run_len: int, n_real: int, b64: torch.Tensor, m: int
) -> torch.Tensor:
    """`merge_counts_i32` on int64 runs and build stream; bc stays int32."""
    return _merge_counts(merge_counts_i64, runs, run_len, n_real, b64, m, torch.int64)


merge_counts_i32.launches = 0
merge_counts_i64.launches = 0
MERGE_COUNTS = {torch.int32: merge_counts_i32, torch.int64: merge_counts_i64}


def merge_stats_plain(s: torch.Tensor, v: torch.Tensor, n: int):
    """`merge_stats_i32` / `merge_stats_i64` as torch scans (cumsums, each
    run's start found by a cumsum over the run starts and a scatter, then a
    scatter to the probe rows), on any device."""
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
    probe = ~is_build & (s != PAD[s.dtype]) & (v >= 0) & (v < n)
    rows = v[probe].to(torch.int64)
    mult[rows] = (count - (count - ib)[start])[probe].to(torch.int32)
    psum[rows] = (total - (total - bpay)[start])[probe]
    return mult, psum


def _merge_stats(wrapper, s, v, n, dtype):
    _build.check_int(s, "s", dtype)
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
        entry = getattr(lib, f"ccve_merge_stats_{_build.SUFFIX[dtype]}")
        code = entry(
            s.data_ptr(), v.data_ptr(), s.numel(), n, scratch.data_ptr(),
            mult.data_ptr(), psum.data_ptr(), _build.stream(s),
        )
        _build.check(code, wrapper.__name__)
        wrapper.launches += 1
    return mult, psum


def merge_stats_i32(s: torch.Tensor, v: torch.Tensor, n: int):
    """(mult int32[n], psum int64[n]) in probe-row order from the merged
    ascending stream `s` of `key' << 1 | tag` (builds even, probes odd,
    INT32_MAX padding) and its cargo plane `v` (a build's payload, any
    sign, or a probe's row id in [0, n)): for each probe row, the number
    of builds with its key and the sum of their payloads. Rows that no
    probe of the stream names stay 0."""
    return _merge_stats(merge_stats_i32, s, v, n, torch.int32)


def merge_stats_i64(s: torch.Tensor, v: torch.Tensor, n: int):
    """`merge_stats_i32` over an int64 stream `s` (INT64_MAX padding); the
    cargo plane `v` stays int32."""
    return _merge_stats(merge_stats_i64, s, v, n, torch.int64)


merge_stats_i32.launches = 0
merge_stats_i64.launches = 0
