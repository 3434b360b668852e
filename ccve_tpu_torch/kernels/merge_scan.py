"""Scans of the sort-merge join's sorted streams, for int32 or int64 keys.

 - `merge_counts_i32` / `merge_counts_i64` (kernel csrc/merge_counts.cu):
   per-build-row probe counts from sorted probe runs, the counterpart of
   `ccve_tpu.kernels.merge_scan.merge_counts_fused` (int32) and of
   `merge_scan_build_counts64` after `merge_sorted_i64_limbs` (int64),
   summed over the runs of an early-stopped sort, all runs in one launch.
 - `merge_scan_build_counts` (kernel csrc/dense_counts.cu, one
   cooperative launch of `dense_counts_grid` blocks): the same counts from
   one merged int32 stream, the counterpart of the JAX function of that
   name.
 - `merge_stats_i32` / `merge_stats_i64` (kernel csrc/merge_stats.cu):
   per-probe match count and matched-payload sum over the merged build and
   probe stream, the counterpart of `merge_scan_stats32` (int32) and of
   `merge_scan_stats` (int64, the wide stats path), each followed by its
   unsort sort: the kernel writes each probe's result to its row directly.
 - `merge_scan_stats` and `merge_scan_stats_packed` (kernel
   csrc/merge_stats.cu): the same stats per element of a sorted int64
   stream, generic (untagged keys beside tagged payloads) or packed (key'
   and payload in one word), the counterparts of the JAX functions of
   those names.

Each kernel has a plain PyTorch version beside it (`*_plain`): cumsums, the
copy-last segment base (`segment_base`) and a scatter, or searchsorted.
A wrapper takes the plain version for a tensor on the CPU; on a CUDA tensor
it launches its kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from ccve_tpu_torch.kernels import _build
from ccve_tpu_torch.kernels.bigsort import PAD


PLAIN_SEARCHES = 1 << 22  # (run, build row) searches a batch of the plain counts
# csrc/dense_counts.cu's launch: threads a block, stream elements a tile
# (16 a thread), co-resident blocks an SM
DENSE_THREADS = 512
DENSE_TILE = DENSE_THREADS * 16
DENSE_BLOCKS_PER_SM = 2


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


def run_starts(key: torch.Tensor) -> torch.Tensor:
    """bool[L]: True where a run of equal keys begins (always at 0)."""
    starts = torch.ones(key.numel(), dtype=torch.bool, device=key.device)
    starts[1:] = key[1:] != key[:-1]
    return starts


def segment_base(flags: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """`values` at each position's latest flagged position (0 before the
    first): the copy-last scan. A cumsum numbers the flags, a scatter
    records where each one sits, and a gather reads it back; no step
    synchronises with the host. (The cummax of where(flags, position, -1)
    gives the same positions, but torch.cummax takes 51 ms for 17M int64
    on an H100 against 1.5 ms for this form.)"""
    n = flags.numel()
    seg = flags.cumsum(0) - 1  # the number of flags up to here, less one
    where_flag = torch.zeros(n + 1, dtype=torch.int64, device=flags.device)
    # unflagged positions all write the spare slot n, which is never read
    where_flag.scatter_(0, torch.where(flags, seg, n), torch.arange(n, device=flags.device))
    return torch.where(seg >= 0, values[where_flag[seg.clamp(min=0)]], 0)


def _run_sums(key: torch.Tensor, is_build: torch.Tensor, pay: torch.Tensor):
    """(count, total) int64 per element: the builds, and the sum of their
    payloads `pay`, from the start of the element's key run up to it."""
    starts = run_starts(key)
    ib = is_build.to(torch.int64)
    bpay = torch.where(is_build, pay, 0)
    count, total = ib.cumsum(0), bpay.cumsum(0)
    return (count - segment_base(starts, count - ib),
            total - segment_base(starts, total - bpay))


def merge_stats_plain(s: torch.Tensor, v: torch.Tensor, n: int):
    """`merge_stats_i32` / `merge_stats_i64` as torch scans (cumsums, the
    copy-last segment base, then a scatter to the probe rows), on any
    device."""
    mult = torch.zeros(n, dtype=torch.int32, device=s.device)
    psum = torch.zeros(n, dtype=torch.int64, device=s.device)
    if not s.numel():
        return mult, psum
    is_build = (s & 1) == 0
    count, total = _run_sums(s >> 1, is_build, v.to(torch.int64))
    probe = ~is_build & (s != PAD[s.dtype]) & (v >= 0) & (v < n)
    rows = v[probe].to(torch.int64)
    mult[rows] = count[probe].to(torch.int32)
    psum[rows] = total[probe]
    return mult, psum


def _scratch(size_fn, length: int, device) -> torch.Tensor:
    return torch.empty(size_fn(length), dtype=torch.uint8, device=device)


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
        scratch = _scratch(lib.ccve_merge_stats_scratch_bytes, s.numel(), s.device)
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


def per_element_stats(key, is_build, pay):
    """(mult int32[L], psum int64[L]) per element of a sorted stream of
    keys `key` with build flags and build payloads `pay`: at a probe, the
    builds of its run that precede it and the sum of their payloads; zero
    at builds. Torch scans, on any device."""
    count, total = _run_sums(key, is_build, pay)
    return (torch.where(is_build, 0, count).to(torch.int32),
            torch.where(is_build, 0, total))


def merge_scan_stats_plain(sk: torch.Tensor, st: torch.Tensor):
    """`merge_scan_stats` as torch scans, on any device."""
    is_build = (st & 1) == 1
    return per_element_stats(sk, is_build, st >> 1)


def merge_scan_stats_packed_plain(s: torch.Tensor, pay_bits: int):
    """`merge_scan_stats_packed` as torch scans, on any device."""
    field = s & ((1 << pay_bits) - 1)
    is_build = (field & 1) == 0
    return per_element_stats(s >> pay_bits, is_build, field >> 1)


def _stats_outputs(length: int, device):
    return (torch.empty(length, dtype=torch.int32, device=device),
            torch.empty(length, dtype=torch.int64, device=device))


def merge_scan_stats(sk: torch.Tensor, st: torch.Tensor):
    """(mult int32[L], psum int64[L]) per element of a sorted stream of
    int64 keys `sk` (any value: INT64_MIN and INT64_MAX are keys like any
    other) with the tagged int64 payload `st`, a build's payload as
    pay * 2 + 1 and a probe 0: at a probe, the number of builds of its key
    that precede it and the sum of their payloads (exact for any sign); at
    a build, 0. Builds precede the probes of their key in the sort, so a
    probe counts every build of its key."""
    _build.check_int(sk, "sk", torch.int64)
    _build.check_int(st, "st", torch.int64)
    if st.numel() != sk.numel() or st.device != sk.device:
        raise ValueError(f"st has {st.numel()} values on {st.device}, sk {sk.numel()} on {sk.device}")
    if sk.device.type == "cpu":
        return merge_scan_stats_plain(sk, st)
    mult, psum = _stats_outputs(sk.numel(), sk.device)
    if sk.numel():
        lib = _build.load()
        scratch = _scratch(lib.ccve_merge_stats_scratch_bytes, sk.numel(), sk.device)
        code = lib.ccve_merge_scan_stats_i64(
            sk.data_ptr(), st.data_ptr(), sk.numel(), scratch.data_ptr(),
            mult.data_ptr(), psum.data_ptr(), _build.stream(sk),
        )
        _build.check(code, "merge_scan_stats")
        merge_scan_stats.launches += 1
    return mult, psum


def merge_scan_stats_packed(s: torch.Tensor, pay_bits: int):
    """`merge_scan_stats` over one sorted packed int64 stream `s` of
    `key' << pay_bits | field` (2 <= pay_bits <= 31): a build's field is
    its payload times 2 (even), a probe's the all-ones tag."""
    _build.check_int(s, "s", torch.int64)
    if not 2 <= pay_bits <= 31:
        raise ValueError(f"pay_bits {pay_bits} outside [2, 31]")
    if s.device.type == "cpu":
        return merge_scan_stats_packed_plain(s, pay_bits)
    mult, psum = _stats_outputs(s.numel(), s.device)
    if s.numel():
        lib = _build.load()
        scratch = _scratch(lib.ccve_merge_stats_scratch_bytes, s.numel(), s.device)
        code = lib.ccve_merge_scan_stats_packed_i64(
            s.data_ptr(), s.numel(), pay_bits, scratch.data_ptr(),
            mult.data_ptr(), psum.data_ptr(), _build.stream(s),
        )
        _build.check(code, "merge_scan_stats_packed")
        merge_scan_stats_packed.launches += 1
    return mult, psum


merge_scan_stats.launches = 0
merge_scan_stats_packed.launches = 0


def dense_build_counts(key: torch.Tensor, is_build: torch.Tensor, m: int) -> torch.Tensor:
    """bc int32[m] of a sorted stream whose key runs hold their probes
    before their builds: bc[j] = the probes in the run of the j-th build
    entry; build entries past the m-th are dropped, ranks the stream does
    not reach stay 0. Torch scans, on any device."""
    ip = (~is_build).to(torch.int64)
    cp = ip.cumsum(0)
    counts = cp - segment_base(run_starts(key), cp - ip)
    rank = is_build.to(torch.int64).cumsum(0) - 1
    keep = is_build & (rank < m)
    bc = torch.zeros(m, dtype=torch.int32, device=key.device)
    bc[rank[keep]] = counts[keep].to(torch.int32)
    return bc


def merge_scan_build_counts_plain(s: torch.Tensor, m: int, extra: int = 0) -> torch.Tensor:
    """`merge_scan_build_counts` as torch scans and a scatter, on any
    device."""
    del extra  # sizes nothing: phantoms rank past m and are dropped
    return dense_build_counts(s >> 1, (s & 1) == 1, m)


def dense_counts_grid(length: int, sm_count: int) -> int:
    """Blocks of the dense counts' cooperative launch over a stream of
    `length` elements on a card of `sm_count` SMs: one a tile, but at most
    DENSE_BLOCKS_PER_SM an SM (all resident at once, as its grid-wide
    barrier needs) and at most DENSE_THREADS (each block scans the grid's
    aggregates one a thread); at least 1, which zeroes bc when the stream
    is empty."""
    tiles = -(-length // DENSE_TILE)
    return max(1, min(tiles, DENSE_BLOCKS_PER_SM * sm_count, DENSE_THREADS))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def merge_scan_build_counts(s: torch.Tensor, m: int, extra: int = 0) -> torch.Tensor:
    """bc int32[m] from a merged, ascending int32 stream `s` of
    `key' << 1 | tag` (builds odd, probes even, so a key's probes come
    first): bc[j] = the number of probes in the run of the j-th build
    entry, which is table row j for a pre-sorted table. INT32_MAX entries
    are phantom builds that sort last; build entries past the m-th are
    dropped. `extra` is kept only for parity with the JAX signature, where
    it bounds the phantoms and sizes that kernel's output ring: it must be
    >= 0 and sizes nothing here."""
    _build.check_i32(s, "s")
    if m < 0 or extra < 0:
        raise ValueError(f"m {m} and extra {extra} must be >= 0")
    if s.is_cpu:
        return merge_scan_build_counts_plain(s, m, extra)
    # every rank is written by the kernel: no memset of bc or the scratch
    bc = s.new_empty(m)
    if m:
        grid = dense_counts_grid(s.numel(), _sm_count(s.get_device()))
        scratch = s.new_empty(3 * grid)
        code = _build.load().ccve_merge_build_counts_i32(
            s.data_ptr(), s.numel(), m, grid, scratch.data_ptr(), bc.data_ptr(),
            _build.stream(s),
        )
        _build.check(code, "merge_scan_build_counts")
        merge_scan_build_counts.launches += 1
    return bc


merge_scan_build_counts.launches = 0
