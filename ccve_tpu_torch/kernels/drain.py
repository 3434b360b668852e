"""The fused per-segment drain of the sorted-chunk executor (count only).

Counterpart of `ccve_tpu.kernels.drain.drain_segment`: `drain_segment`
(kernel csrc/drain.cu) runs a segment of S chunks, in order, through the
whole level recursion of `exec.sorted_pipeline.SortedPipeline._run_tree`:
at each level l < L-1 and drain rank t < fanouts[l], the rows with
mult > t are compacted, the NaiveCompactor (compactor.cpp:5-41, threshold
`thresholds[l]`) passes, absorbs or emits, and the emission descends; the
last level adds Σ mult over its live rows (the count collapse). The
compactor caches carry from chunk to chunk.

Inputs, all int32 and on one device:

    mults      [S, L, block]   per-level match counts of each chunk's rows
    counts     [S]             live rows of each chunk (in [0, block])
    thresholds [L]             per-level compaction thresholds
    cache_m    [CL, L, block]  level l's cache holds planes l2 > l
    cache_cnt  [CC]            rows in each cache (CL = max(L - 1, 1);
                               CC = L with `record_occupancy`, else CL)

Returns (total int64 scalar, cache_m out, cache counts int32[CC], work
int32[L], rows int32[L]), and with `record_occupancy` also occ
int32[L, block + 1]. Only each cache's live prefix of its planes l2 > l is
defined. `work[l]` counts the chunks that entered level l (level 0) or
arrived non-empty, plus the compactions at l; `rows[l]` the rows that
arrived; as in the JAX kernel, a compaction of an empty emission below an
absorbed one counts too.

`record_occupancy` is the Zebra variant: every emission after a compaction
decision at level l adds one to occ[l, c], c its live-row count (c = block
in the last column). The last level then runs the compactor's count algebra
on a count-only cache (cache_cnt[L-1], no planes) instead of the collapse;
the total over stream and flush is the same. `branchy` (the executor's
`branchy_descend`) records nothing under an empty emission; without it the
empty subtree records its zero-count emissions.

The JAX kernel pads planes to max(block / 128, 8) x 128 lanes and sums in
int32 (Mosaic has no 64-bit types); here planes are `block` wide and the
total is int64. The kernel takes the recursion level by level in one
cooperative launch over the whole card (csrc/drain.cu's header), with a
scratch the wrapper sizes from S, the block and the fanouts. Any number of
levels and any block run; the one limit is the JAX gate's, at most 64
drain paths (Π fanouts[:-1]).
"""

from __future__ import annotations

import ctypes
import functools
import math
from types import SimpleNamespace

import torch

from ccve_tpu_torch.kernels import _build

MAX_PATHS = 64  # the JAX package's gate on the fused route


def _check(mults, counts, thresholds, cache_m, cache_cnt, block, fanouts, record_occupancy):
    for name, t in (("mults", mults), ("counts", counts), ("thresholds", thresholds),
                    ("cache_m", cache_m), ("cache_cnt", cache_cnt)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name}: expected an int32 tensor, got {getattr(t, 'dtype', type(t))}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.device != mults.device:
            raise ValueError(f"{name} on {t.device}, mults on {mults.device}")
    if mults.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {mults.device}")
    if mults.dim() != 3:
        raise ValueError(f"mults: expected [S, L, block], got {tuple(mults.shape)}")
    S, L, B = mults.shape
    if B != block or block < 1:
        raise ValueError(f"mults planes are {B} wide, block {block}")
    if L < 1:
        raise ValueError("mults: expected at least one level")
    fanouts = tuple(int(f) for f in fanouts)
    if len(fanouts) != L or min(fanouts) < 1:
        raise ValueError(f"fanouts {fanouts}: expected {L} values >= 1")
    if math.prod(fanouts[:-1]) > MAX_PATHS:
        raise ValueError(f"fanouts {fanouts}: more than {MAX_PATHS} drain paths")
    CL = max(L - 1, 1)
    CC = L if record_occupancy else CL
    for name, t, shape in (("counts", counts, (S,)), ("thresholds", thresholds, (L,)),
                           ("cache_m", cache_m, (CL, L, block)), ("cache_cnt", cache_cnt, (CC,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    return fanouts


def drain_segment_plain(mults, counts, thresholds, cache_m, cache_cnt, *, block, fanouts,
                        record_occupancy=False, branchy=True):
    """`drain_segment` in torch ops on [block] planes, with the compactor's
    scalars and the histograms as host ints, on any device (it reads each
    step's count back, so on the card it syncs per step)."""
    fanouts = _check(mults, counts, thresholds, cache_m, cache_cnt, block, fanouts,
                     record_occupancy)
    S, L, B = mults.shape
    dev = mults.device
    lane = torch.arange(B, device=dev)
    cache = cache_m.clone()
    ccnt = cache_cnt.tolist()
    thr = thresholds.tolist()
    work, rows = [0] * L, [0] * L
    occ = [[0] * (B + 1) for _ in range(L)]
    total = torch.zeros((), dtype=torch.int64, device=dev)

    def compacted(plane, at):
        out = plane.new_zeros(B + 1)
        out[at] = plane
        return out[:B]

    def gen(level, planes, c, live):
        """One chunk (its planes, or None when it is empty) at `level`;
        `live` says whether its emissions are recorded."""
        nonlocal total
        if level == L - 1 and not record_occupancy:
            if c:
                total = total + torch.where(lane < c, planes[level], 0).sum(dtype=torch.int64)
            return
        for t in range(fanouts[level]):
            emitted, ecnt = {}, 0
            if c:
                keep = (lane < c) & (planes[level] > t)
                at = torch.where(keep, torch.cumsum(keep, 0) - 1, B)
                ecnt = int(keep.sum())
                emitted = {l2: compacted(planes[l2], at) for l2 in range(level + 1, L)}
            cc = ccnt[level]
            passthrough = ecnt >= thr[level] or ecnt >= B
            new_count = cc + ecnt
            if passthrough:
                out, out_count = emitted, ecnt
            elif new_count >= B:  # the cache fills: emit it, keep the overflow
                room = B - cc
                out = {l2: torch.cat([cache[level, l2, :cc], e[:room]]) for l2, e in emitted.items()}
                for l2, e in emitted.items():
                    cache[level, l2, : new_count - B] = e[room:ecnt]
                ccnt[level], out_count = new_count - B, B
            else:  # absorbed
                for l2, e in emitted.items():
                    cache[level, l2, cc:new_count] = e[:ecnt]
                ccnt[level], out, out_count = new_count, None, 0
            work[level] += 0 if passthrough else 1
            if record_occupancy and live:
                occ[level][out_count] += 1
            if level == L - 1:  # the variant's last level: a counting collector
                total = total + out_count
                continue
            work[level + 1] += 1 if out_count else 0
            rows[level + 1] += out_count
            gen(level + 1, out if out_count else None, out_count,
                live and (out_count > 0 or not branchy))

    for i, c in enumerate(counts.tolist()):
        work[0] += 1
        rows[0] += c
        gen(0, {l: mults[i, l] for l in range(L)} if c else None, c, True)
    as_i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa: E731
    out = (total, cache, as_i32(ccnt), as_i32(work), as_i32(rows))
    return out + (as_i32(occ),) if record_occupancy else out


@functools.lru_cache(maxsize=256)
def _host_fanouts(fanouts: tuple) -> ctypes.Array:
    """The fanouts as the C entry points take them: int32[L] on the host
    (kept a tuple, so a call builds no array)."""
    return (ctypes.c_int * len(fanouts))(*fanouts)


def grid(S, fanouts, record_occupancy=False) -> int:
    """The blocks of the cooperative launch of a drain of S chunks at
    `fanouts` on the current CUDA device."""
    fanouts = tuple(int(f) for f in fanouts)
    blocks = _build.load().ccve_drain_grid(S, len(fanouts), int(record_occupancy),
                                           ctypes.addressof(_host_fanouts(fanouts)))
    if blocks <= 0:
        _build.check(-blocks, "drain grid")
    return blocks


def drain_segment(mults, counts, thresholds, cache_m, cache_cnt, *, block, fanouts,
                  record_occupancy=False, branchy=True):
    """The fused drain of one segment (see the module docstring): kernel
    csrc/drain.cu on a CUDA device, `drain_segment_plain` on the CPU."""
    fanouts = _check(mults, counts, thresholds, cache_m, cache_cnt, block, fanouts,
                     record_occupancy)
    if mults.device.type == "cpu":
        return drain_segment_plain(mults, counts, thresholds, cache_m, cache_cnt, block=block,
                                   fanouts=fanouts, record_occupancy=record_occupancy,
                                   branchy=branchy)
    S, L, _ = mults.shape
    lib = _build.load()
    fan = ctypes.addressof(_host_fanouts(fanouts))
    n_scratch = lib.ccve_drain_scratch_bytes(S, L, block, int(record_occupancy), fan)
    if n_scratch < 0:
        raise ValueError(f"drain_segment: L={L}, block {block} and fanouts {fanouts} take "
                         "row ids past int32 even one chunk at a time")
    scratch = mults.new_empty(n_scratch // 4)
    # the outputs in one allocation, each written by the kernel (no memset):
    # total (int64), caches, cache counts, work, rows and the histograms
    CL, CC = cache_m.shape[0], cache_cnt.shape[0]
    sizes = [2, cache_m.numel(), CC, L, L] + ([L * (block + 1)] if record_occupancy else [])
    parts = mults.new_empty(sum(sizes)).split(sizes)
    total = parts[0].view(torch.int64)
    cache_out = parts[1].view(CL, L, block)
    ccnt_out, work, rows = parts[2:5]
    occ = parts[5].view(L, block + 1) if record_occupancy else None
    code = lib.ccve_drain_segment_i32(
        mults.data_ptr(), counts.data_ptr(), thresholds.data_ptr(), fan,
        cache_m.data_ptr(), cache_cnt.data_ptr(), S, L, block, int(record_occupancy),
        int(branchy), scratch.data_ptr(), total.data_ptr(), cache_out.data_ptr(),
        ccnt_out.data_ptr(), work.data_ptr(), rows.data_ptr(),
        None if occ is None else occ.data_ptr(), _build.stream(mults),
    )
    _build.check(code, "drain_segment")
    out = (total[0], cache_out, ccnt_out, work, rows)
    if record_occupancy:
        occupancy_variant.launches += 1
        return out + (occ,)
    drain_segment.launches += 1
    return out


# the count path's launches; the occupancy variant's are counted apart
drain_segment.launches = 0
occupancy_variant = SimpleNamespace(launches=0)
