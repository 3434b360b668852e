"""Single-join probe micro-benchmark: the reference's variant matrix.

Port of `ccve_tpu.bench.micro`. `simd_micro_bench.cpp:75-362` times {SIMD,
scalar} x {staged Next, fused InOneNext} x {chaining, linear probing} in
cycles a key over a glibc-rand key stream. On the card the {SIMD, scalar}
axis has no meaning (every op is vectorized); the execution styles are

 - **bulk fused**: `exec.bulk.match_stats` over the whole stream, one
   fused hash, gather, compare and advance drain (the InOneNext analogue);
 - **staged scan**: the stream as chunks of `block` keys, probed at once
   (`lp_probe` / `csr_probe` over the [chunks, block] grid, kernel #12 for
   the hash), then `scan_next` rounds until every chunk's scan drains,
   'probe' and 'drain' timed apart;
 - **phased**: the reference's 4-phase CycleProfiler report
   (profiler.h:264-290; simd_micro_bench.cpp:108-116): hash, match, gather
   and advance each timed apart over the whole grid, a round at a time,
   into a `utils.profiler.PhaseProfiler`,

crossed with {LP, CSR}. The staged and phased variants scan every chunk of
the grid in one op a phase (count tensors, no host read inside a round);
a round reads the live count once, as JAX's rounds read it back. The key
stream reproduces simd_micro_bench.cpp:78-79 bit-exactly (glibc rand() &
(rhs_tuples * hit_freq - 1), `core.datagen.gen_microbench_keys`), and
every variant reports its matched-tuple count, which must agree across
variants (the reference's cross-check, simd_micro_bench.cpp:116).

Times are host clock around calls that end in a device sync: warm-up, then
the best of three (one above 5 s of warm-up). Removed with the port: the
JAX `lax.map` tiling of the bulk LP variant past 2^24 keys (the tiles are
a Python loop here) and the `max_steps` / `max_iters` drain bounds (the
rounds end when the scans drain).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ccve_tpu_torch.core.datagen import gen_microbench_keys, gen_rhs_table
from ccve_tpu_torch.device import require_device
from ccve_tpu_torch.exec.bulk import match_stats
from ccve_tpu_torch.ops.hash_table import (
    LPTable,
    build_csr,
    build_lp,
    csr_probe,
    lp_probe,
    scan_advance,
    scan_gather,
    scan_match,
    scan_next,
)

LP_TILE_ROWS = 1 << 21  # the bulk LP variant's tile past 2^24 keys, as in JAX


@dataclass
class VariantResult:
    name: str
    seconds: float
    n_keys: int
    tuples: int
    phase_seconds: dict | None = None
    phase_profiler: object = None
    tile_rows: int | None = None  # None: the whole stream at once

    @property
    def ns_per_key(self) -> float:
        return self.seconds * 1e9 / self.n_keys


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device: torch.device, reps: int = 3):
    """(best seconds, last result) of `reps` calls after a warm-up; one
    call where the warm-up took over 5 s."""
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    if time.perf_counter() - t0 > 5.0:
        reps = 1
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


def run_bulk_variant(table, keys: torch.Tensor, name: str,
                     tile_rows: int | None = None) -> VariantResult:
    """`match_stats` over the stream (in tiles of `tile_rows` keys, counts
    summed, when given)."""
    n = keys.shape[0]
    tiles = [keys] if not tile_rows or n <= tile_rows else list(keys.split(tile_rows))

    def total():
        return sum(match_stats(table, t).mult.sum(dtype=torch.int64) for t in tiles)

    secs, out = _time(total, keys.device)
    return VariantResult(name=name, seconds=secs, n_keys=n, tuples=int(out),
                         tile_rows=tile_rows if len(tiles) > 1 else None)


def _grid(keys: torch.Tensor, block: int):
    """The stream's whole chunks as [chunks, block] keys, with every row of
    every chunk selected."""
    n_chunks = keys.shape[0] // block
    grid = keys[: n_chunks * block].reshape(n_chunks, block)
    sel = torch.arange(block, dtype=torch.int32, device=keys.device).expand(n_chunks, block)
    count = torch.full((n_chunks,), block, dtype=torch.int32, device=keys.device)
    return grid, sel.contiguous(), count


def run_staged_variant(table, keys: torch.Tensor, block: int, name: str) -> VariantResult:
    """The staged probe: every chunk probed at once ('probe'), then
    `scan_next` rounds over the grid until every scan drains ('drain')."""
    grid, sel, count = _grid(keys, block)
    prober = lp_probe if isinstance(table, LPTable) else csr_probe

    def drain(st):
        total = torch.zeros((), dtype=torch.int64, device=keys.device)
        while int(st.count.max()) > 0:  # the round's one read
            res = scan_next(table, grid, st)
            total += res.result_count.sum(dtype=torch.int64)
            st = res.state
        return total

    p_secs, states = _time(lambda: prober(table, grid, sel, count), keys.device)
    d_secs, total = _time(lambda: drain(states), keys.device)
    return VariantResult(name=name, seconds=p_secs + d_secs, n_keys=grid.numel(),
                         tuples=int(total), phase_seconds={"probe": p_secs, "drain": d_secs})


def run_phased_variant(table, keys: torch.Tensor, block: int, name: str) -> VariantResult:
    """The 4-phase attribution: hash (the probe), then rounds of match,
    gather and advance, each phase over the whole grid, synced and timed
    apart, into a PhaseProfiler with approximate byte counts (16 B an item:
    an 8-byte key read and an 8-byte state touch a live row a phase)."""
    from ccve_tpu_torch.utils.profiler import PhaseProfiler

    grid, sel, count = _grid(keys, block)
    n = grid.numel()
    prober = lp_probe if isinstance(table, LPTable) else csr_probe
    prof = PhaseProfiler()

    # each phase ends in a read of a count or a checksum: the read is its sync
    t0 = time.perf_counter()
    states = prober(table, grid, sel, count)
    live = int(states.count.sum())
    prof.record("hash", time.perf_counter() - t0, n, 16 * n)
    tuples = 0
    while live > 0:
        t0 = time.perf_counter()
        rvs, rcs = scan_match(table, grid, states)
        matched = int(rcs.sum())
        prof.record("match", time.perf_counter() - t0, live, 16 * live)
        tuples += matched

        t0 = time.perf_counter()
        mk, mp = scan_gather(table, states, rvs)
        int((mk[:, 0] + mp[:, 0]).sum())  # the checksum keeps the gathers live
        prof.record("gather", time.perf_counter() - t0, matched, 16 * matched)

        t0 = time.perf_counter()
        states = scan_advance(table, states)
        live = int(states.count.sum())
        prof.record("advance", time.perf_counter() - t0, live + matched,
                    16 * (live + matched))
    return VariantResult(
        name=name, seconds=sum(s.seconds for s in prof.stats().values()), n_keys=n,
        tuples=tuples, phase_seconds={p: s.seconds for p, s in prof.stats().items()},
        phase_profiler=prof,
    )


def run_micro_bench(scale: int = 0, hit_freq: int = 1, chunk_factor: int = 1,
                    n_keys: int | None = None,
                    variants: tuple[str, ...] = ("bulk", "staged", "phased"),
                    device="cuda") -> list[VariantResult]:
    """The matrix on `device` (default the GPU; raises without one).
    Geometry as simd_micro_bench.cpp:62-63: block = 256 << scale (at least
    128), rhs_tuples = 128 << scale; the key stream is glibc rand masked
    (simd_micro_bench.cpp:78-79). The reference streams 1024 << 17 keys;
    the default here is 2^24."""
    device = require_device(device)
    block = max(256 << scale, 128)
    rhs_tuples = 128 << scale
    n_keys = n_keys or (1 << 24)
    keys = torch.from_numpy(gen_microbench_keys(n_keys, rhs_tuples, hit_freq)).to(device)
    build_keys, build_payloads = gen_rhs_table(rhs_tuples, chunk_factor)
    lp = build_lp(build_keys, build_payloads, device=device)
    csr = build_csr(build_keys, build_payloads, device=device)
    _sync(device)
    results = []
    if "bulk" in variants:
        results += [
            run_bulk_variant(lp, keys, "bulk_fused_lp",
                             tile_rows=LP_TILE_ROWS if n_keys > (1 << 24) else None),
            run_bulk_variant(csr, keys, "bulk_fused_csr"),
        ]
    if "staged" in variants:
        results += [run_staged_variant(lp, keys, block, "staged_scan_lp"),
                    run_staged_variant(csr, keys, block, "staged_scan_csr")]
    if "phased" in variants:
        results += [run_phased_variant(lp, keys, block, "phased_lp"),
                    run_phased_variant(csr, keys, block, "phased_csr")]
    counts = {r.tuples for r in results}
    if len(counts) > 1:
        raise AssertionError(f"variant tuple counts disagree: {counts}")
    return results


def report(results: list[VariantResult]) -> str:
    lines = []
    for r in results:
        phases = ""
        if r.phase_seconds:
            phases = "  (" + ", ".join(f"{k} {v * 1e9 / r.n_keys:.2f} ns/key"
                                       for k, v in r.phase_seconds.items()) + ")"
        lines.append(f" {r.name:18s} {r.ns_per_key:8.3f} ns/key  #tuples {r.tuples}{phases}")
        if r.phase_profiler is not None:
            # the reference's CycleProfiler table (simd_micro_bench.cpp:108-116),
            # ns a key instead of cycles
            lines.append(r.phase_profiler.report(total_items=r.n_keys))
    return "\n".join(lines)
