#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ccve_tpu_torch`) on one NVIDIA GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.

 1. Requires a CUDA device; prints the card's name and power limit.
 2. Builds the kernels of `ccve_tpu_torch/kernels/csrc` with nvcc (sm_90a).
 3. Holds each kernel of the config-1 path against its plain PyTorch
    version on the card, at small ragged shapes: exact integer equality
    (tolerance 0, the outputs are integers). Times the merge counts on
    5,000 builds clustered on 500 keys beside 5,000 spread ones.
 4. Drives the config-1 join (1M build rows against 16M probe rows) once
    through `build_sorted` and `bulk_count`, with every launch counter set
    to 0 just before; checks that each kernel launched (#1 as
    `sort_runs_narrowed`; its key-only form `sort_tiles_i32` must not), a
    merge-path partition for every count-side merge level, and that count
    and checksum equal numpy's and the all-plain path's.
 5. Holds each kernel against its plain version again at the shapes that
    run gave it (#1's narrowing load, `sort_runs_narrowed`, the main
    path's tile sort, on the int32 column and on an int64 copy of it, the
    tile sort alone and the whole ladder, against its plain twin), and
    times kernels, plain versions, `bulk_count` and the all-plain path
    with CUDA events.
 6. Runs `bench.configs.config1_single_join` as the CLI would.
 7. Slice 2's kernels (multi-plane tile sort, multi-plane merges, stats
    scan, compaction) against their plain versions at small ragged
    shapes, exactly.
 8. Config 3's bulk engine at full size (1M probe rows x 4 levels, 50K
    build rows each) through `bulk_count`, launch counters zeroed just
    before: count and four checksums against the numpy oracle and the
    all-plain path, a merge-path partition launched for every #7 merge;
    the kernels again at its shapes; times, and #6 and #7's device time a
    launch beside their bounds and the one-call `torch.sort` yardsticks
    of the packed words (per tile; the whole stream).
 9. Config 1 materialized at full size (phase 4's data) through
    `sorted_expand_tiled`, counters zeroed just before: total, Σ payload
    and sampled triples against numpy, every tensor against the
    all-plain path; the kernels again at its shapes (the expansion's
    candidates, `expand_candidates_i32`, on the merged stream of L =
    17,000,000 at F = 1: valid slots, mask and total); times, with #6 and
    #7 read apart as in phase 8, and the candidates alone beside their
    byte bound and their plain version.
10. Duplicate keys (256K build rows, 4 per key, 4M probes): per-probe
    stats and the expanded triple multiset against numpy; the candidates
    at F = 4 over the merged stream of 786,432 of its probes (L = 2^20),
    against their plain version, timed beside both.
11. Runs `config3_four_way` and `config1_materialize` as the CLI would.
12. Slice 3's int64 kernels (tile sort, merge level, counts, multi-plane
    tile sort, multi-plane merges, stats scan) against their plain
    versions at small ragged shapes, exactly: keys near ±2^62 and at the
    int64 extremes, INT64_MAX padding, n off the tile, P = 1..3, empty
    streams.
13. `config1_wide` at full size (1M build rows with keys over 2^40, 2^24
    probes) through `bulk_count` and `sorted_match_totals`, counters zeroed
    just before: count and checksum against numpy and the all-plain path,
    #13 as `sort_runs_narrowed_i64` (its key-only form `sort_tiles_i64`
    must not launch), a partition for every count-side merge level; the
    int64 count-side kernels again at its shapes (the narrowing load on
    the int64 column and a stride-2 view of it, the tile sort alone and
    the whole ladder, against its plain twin and the composition it
    replaces; the key-only form on the packed, padded probes); times, the
    narrowing load beside the key-only form.
14. The wide stats side on phase 13's data: `sorted_match_stats` (mult and
    psum on every row against numpy's searchsorted ranges, the all-plain
    route identical), `sorted_match_ranks` on the rank twin, a 2-level
    `bulk_count` against the numpy oracle, each with counters zeroed just
    before; the int64 stats kernels again at its shapes; times, with #6
    and #7's int64 builds read apart as in phase 8.
15. The int64/int32 ratio: config 1's count side (phase 4's table and
    column) on its int32 streams and, with the table's `pack32` dropped,
    on int64 streams, timed in turns (each the whole count side from the
    column).
16. Slice 4's kernel, the murmur64 hash (#12), against its plain version
    at small shapes, exactly: the int64 extremes, unaligned n, n = 0.
17. Config 1 (phase 4's data) through `build_lp` and `build_csr` at full
    size and `bulk_count`, counters zeroed just before: count and checksum
    against numpy and each table's all-plain route, per-row mult and psum
    against `sorted_match_stats` on the same column; the hash launched on
    both, the compaction on the LP drain. Build seconds, max_run, max_len.
18. The hash at config 1's 16M probe keys against its plain version,
    timed.
19. `bulk_count` on the LP and CSR tables beside the sort-merge table on
    the same data (medians of 20, min and max), the hash tables' all-plain
    routes, and each engine's device idle share from torch.profiler.
20. `bulk_materialize` over LP and CSR tables on phase 10's duplicate-key
    data: the triple multiset against the sort-merge route's and numpy's.
21. Runs `config1_single_join` with `engine` hash_lp and hash_csr as the
    CLI would.
22. The LP ladder at 5, 25 and 50 % hits on config 1's LP table (16M
    probes): counters zeroed just before each ladder call; where at most a
    quarter of the probes hit, the ladder must hold (one hash launch, four
    compactions), so its own answer is the one returned. Ladder, full
    width and the all-plain ladder against the exact per-row answer, CSR
    and sort-merge counts against it; times of the four.
23. Slice 7's kernel, the fused drain (#10), against its plain version at
    small shapes, exactly (total, cache counts, work, rows, live cache
    prefixes): the JAX-parity cases of tests/test_torch_drain.py and 24
    random (L, block, fanouts, thresholds); more than 64 drain paths must
    raise.
24. Config 3 on the sorted-chunk executor at full size (phase 8's data,
    block 2048) under NONE, FULL and BINARY, preloaded and streamed,
    counters zeroed just before each: count 62,667, equal to the oracle
    and phase 8's `bulk_count`, also on the torch drain route
    (`use_kernel=False`); #10 launched once a preloaded run and once a
    streamed segment, the rank pass's #6-#8 launched. run() seconds
    (median of 5, min, max), the device idle share of the timed work, the
    torch drain's seconds.
25. #10 at config 3's shapes (the FULL run's mult planes, zero caches)
    against its plain version, exactly; both timed with CUDA events, beside
    the bound. Then #10 read apart (`bench.kernel_split.split`) at config
    3's 489 chunks under FULL and NONE thresholds, its first 64 (a
    streamed segment) and config 7's 977 chunks under FULL: one-call and
    chained CUDA-event times, the host's enqueue, the device time, one
    launch a call asserted, the cooperative grid (more than one block
    asserted) and the bound of each.
26. Config 7 at full size (2M x 4 levels, hit rates 0.95, 0.03, 1, 1, 50K
    build rows, block 2048): no_compaction, full_compaction and
    mixed_static, preloaded, count equal to the oracle and `bulk_count`,
    one #10 launch a run; times in interleaved rounds and idle shares.
27. Runs `config7_heterogeneous_levels` as the CLI would (phase 11's
    `config3_four_way` already ran the sorted executor's entries), and the
    CLI's known-good `pipeline` command (`[Result Rows] 2992`).
28. The fused drain's repair: #10 against its plain version at (L, block)
    = (6, 2048), (5, 4096), (9, 2048, fanouts 1) and (2, 8192), which its
    first version refused; then the CLI's `pipeline --join-num 6` over 1M
    probe rows and 50K build rows (sorted executor, FULL, preloaded), its
    count equal to `bulk_count` on the same data.
29. #10's occupancy variant against its plain version at small shapes,
    exactly (histograms, total, cache counts, work, rows, caches), branchy
    on and off.
30. #11, the per-chunk rank, against its plain version at small shapes
    (the cases of tests/test_torch_chunk_probe.py and random (m, block) up
    to block 4096): mult everywhere, start where mult > 0; then the edges of
    its index design (`bench.edge_cases.chunk_rank_cases`: tables of
    stride·k and stride·k ± 1 rows, the index's sampled keys, duplicate runs
    across leaf boundaries, a hot key of 12,000 rows, m = 2^21 and 2^24, the
    int64 extremes, m = 0 and 1): mult and start everywhere.
31. Config 3 in the chunk rank mode at full size (phase 8's data, block
    2048), NONE and FULL, preloaded, counters zeroed just before each: count
    62,667 with #11 launched; run() seconds beside the batched mode's; #11
    at config-3 shapes against its plain version, the two-searchsorted
    library call and its bound, with CUDA events; then both read apart on
    the host and the device (`bench.kernel_split`, in turns kernel,
    library, library, kernel): one-call and chained CUDA-event times, the
    host's enqueue, torch.profiler's device time and events a call, and the
    allocations a call (#11: one kernel, one allocation); and the host time
    of each step of #11's wrapper, timed apart.
32. Zebra at config 3: FULL and BINARY with `record_occupancy` on the fused
    route (#10's variant launched, counters zeroed just before) and on the
    torch drain, histograms equal bin for bin and count 62,667; a
    `zebra_profile` run (segments, totals equal to the histogram); the fused
    route's run() seconds with and without the histograms; the variant at
    config-3 shapes against its plain version, timed.
33. DYNAMIC at config 7's full size: the device tuner preloaded and
    streamed and the host tuner streamed, each counting 57,189 (the
    oracle's), counters zeroed just before (#10 and the rank pass
    launched); greedy thresholds, commits and selection counts; the host
    syncs a device-tuner segment makes (`torch.cuda.set_sync_debug_mode`);
    run() seconds beside phase 26's statics and phase 27's
    `dynamic_vs_best_static`; the device tuner's idle share and the ops
    with the most host time in one run (torch.profiler).
34. The CLI's known-good `pipeline` command with `--strategy dynamic`,
    `--record-occupancy` and `--zebra-profile` (`[Result Rows] 2992` each).
35. Slice 3b's kernels against their plain versions at small shapes,
    exactly: #15's generic entry (`merge_scan_stats`: INT64_MIN and
    INT64_MAX keys, runs across block boundaries, negative payloads, an
    all-probe and an all-build stream), #16 (`merge_scan_stats_packed` at
    pay_bits 2, 25 and 31), #4 (`merge_scan_build_counts`: duplicate
    builds, phantoms, `extra`) and #5 (`merge_sorted_i32`: ties, lengths 1
    to 10^5 a side, an empty side).
36. The full-range join (`config1_full_range_host`: 1M build rows x 2^24
    probes, keys over the whole int64 range) through `bulk_count`, counter
    zeroed just before: count and checksum against numpy and the all-plain
    route, #15's generic entry launched once; times (median of 20 with min
    and max), the device's idle share, the sort/scan split and the peak
    extra memory.
37. The small-probe route: config 1's table against 1, 100 and 8192
    probes through `sorted_match_totals` (numpy's counts; #5 and #4 once a
    call), 8193 on the tile route. At each of 1, 100 and 8192, outside the
    counted call, #5 and #4 on that call's own streams against their plain
    versions; their times in the kernel line are at 8192 probes, the
    path's widest shape, beside `torch.sort` of the concatenation and two
    `torch.searchsorted`; #4 and that library call read apart on the host
    and the device as in phase 31 (#4: one kernel, no memset). #4 against
    its plain version on the edges of its one-launch design
    (`bench.edge_cases.dense_counts_cases`: lengths at its tile multiple
    and one off, builds only, probes only, a 100K-probe hot key, phantoms,
    m below and past the builds, L = 1 and 0, more tiles than the grid),
    each into memory the allocator last held garbage in and from a view 4
    bytes past a 16-byte boundary.
38. #5 then #4 on config 1's own streams (the sorted 16M probe stream and
    the 1M build stream), and #16 on config 1's table packed as the JAX
    package's `table.pack` does: Σ bc / dot(bc, payloads) and Σ mult /
    Σ psum give config 1's count and checksum; #16 timed beside its plain
    version, and #5 and #4 at these 17M elements logged beside their
    8192-probe times.
39. #17, the compare-exchange stages of the roofline's calibration, against
    its plain version, exactly: n = 8192 and 3 x 8192 at K = 1, 3, 16, and
    n = 2^24 at K = 16, 32, 48 and 64 (kernel and plain times, the bound
    from bench/roofline.py's constants, and the shared-memory floor from
    the card's SMs and largest SM clock; the K-slope and the times' largest
    deviation from one line); then `roofline.measure_anchors()` in this
    process, #17's counter zeroed just before.
40. The slice through its entry point: `python -m ccve_tpu_torch.cli
    roofline --anchor --measured-ms <phase 5's bulk_count median>` in a
    process of its own: its operator rows, both anchors and the percent of
    the model's speed-of-light; the model's plan equal to config 1's run
    (tile, levels, runs) and each operator's speed-of-light beside phase
    5's kernel times. Then `DataCollection`: config 3's probe table through
    `fetch_chunk(..., device="cuda")` and `append_chunk`, chunk by chunk and
    through a selection vector, equal to the table.

41. #12 against its plain version, exactly, at the cursor probe's shape:
    2048 of config 3's keys gathered through a sparse selection vector
    (stale zeros past its count).
42. Config 3 on the cursor executor (`config3_four_way` with `table_kind`
    csr, then lp: `JoinPipeline`, 1M x 4 levels, block 2048, count only,
    streamed), NONE and FULL, each case read apart by the config's
    `timer`: its first run counted (#12's counter zeroed just before it,
    read just after), its count held to every timed run's and the
    oracle's 62,667; run() seconds (the median of 3 after that run where
    it took under 10 s, else that run itself), the steps a level, #12's
    launches, then the host syncs a step over the first 16 chunks
    (`torch.cuda.set_sync_debug_mode`) and the device idle share over the
    first 4 (torch.profiler); the sorted executor's times from the same
    call beside them.
43. Config 2 (`config2_filtered_join`, read apart as in phase 42): FULL,
    DYNAMIC (host tuner) and `sorted_full` against the numpy oracle over
    the kept rows.
44. Config 6 (`config6_mixed_selectivity`, read apart as in phase 42):
    NONE, FULL, DYNAMIC on the host and the device tuner against the
    oracle, the device tuner's greedy thresholds and commits.
45. The CLI: the known-good `pipeline` command on the cursor executor over
    CSR and LP (`[Result Rows] 2992`), `strategy-matrix` at 200K x 2
    levels (every strategy at the oracle's count) and `microbench` at 2^20
    keys (every variant's tuples equal to numpy's count): a check of its
    answers, not its measurement; at this size its times are mostly
    launches and host syncs (the measurement is `cli microbench` at its
    default 2^24 keys).
46. Config 4 at full size (`config4_zipf_pipeline`: 4M Zipf keys, alpha
    1.1, against the unique keys 0 .. 99,999): matches 4,000,000, n_groups
    94,963, the ORDER BY's last (sum, key) (5,450,084,928,405, 93,591), the
    16-way histogram and partition_skew_16 3.378732, each also asserted
    against numpy inside the config; then one counted query and histogram
    (#1, #2, #3 and #12's counters and the partitions' zeroed just before,
    every one launched, #1 as `sort_runs_narrowed` and not in its key-only
    form, a partition a merge level), its answer equal to the
    CPU path's on the same inputs; the same kernels at the run's shapes
    (#1 as `sort_runs_narrowed` on the int64 probe column and in its
    key-only form on the packed probes, #2 at each level and as `sort_runs`, #3
    against the 100K builds, #12 on the 4M keys) held exactly against their
    plain versions, into the kernels line's max |kernel - plain|; the
    histogram making no host sync; `run()`, its join aggregate, its
    `sorted_build_counts`, its ORDER BY and the histogram timed, and the
    device idle share of `run()`.
47. The aggregates on the card at the 4M Zipf keys with random values:
    `hash_aggregate` and `dense_aggregate` equal numpy's count, sum, min and
    max of every group, with the padding past n_groups; the card's
    `join_dense_aggregate` equal to the CPU path's field by field; times.
48. The LSD radix sort (`radix_sort_pairs`) at config 4's 100,000 (sum,
    key) pairs (bits 64) and at the 4M Zipf keys with row ids (bits 17),
    equal to a stable `torch.sort`; both timed.
49. `build_csr_device` on config 3's and config 2's build tables, equal to
    `build_csr` entry for entry, with no host sync; timed beside the host
    build.
50. `python -m ccve_tpu_torch.cli baseline --config 4` in a process of its
    own: rc 0, matches and n_groups as in phase 46.
51. Config 5 on one rank (NCCL, world 1, a group of its own) at full size
    (100K build rows, 1M probe rows): the flat shuffle on sorted, LP and
    CSR partitions, the ring on block partitions, bcast, PRPD on the Zipf
    probes (64 hot keys), then hier on a 1x1 mesh, each with the launch
    counters zeroed just before it: count 999,990 and checksum
    10,049,810,862,256 (PRPD 1,000,000 and 10,058,256,117,134), equal to
    numpy and the one-card `bulk_count`, skew 1.0, no overflow; every
    kernel launch of each counted run (#6-#8 on sorted partitions, #12 and
    #9 on LP, #12 on CSR) held against its plain version at the shapes of
    the plan's local probes, recorded in that run (`hold_probes`: the held
    launches equal the counted ones, kernel by kernel); times.
52. `dist_bulk_expand` at full size (999,990 triples, Σ payload = the
    checksum, 4096 sampled triples against numpy), `dist_pipeline_expand`
    over 2 levels with `level_caps` (total against numpy), each counted,
    its kernels held as in phase 51; `dist_aggregate` over config 4's 4M
    Zipf keys (94,963 groups, every group against numpy); times.
53. 2 and 4 ranks on the one card: `spawn_ranks` over gloo, every rank
    computing on cuda:0 with the library the parent built: flat, ring,
    bcast and PRPD at P = 2 and 4, hier at 1x2, 2x1 and 2x2, and
    `dryrun_multichip(2)`; every rank's counts and checksums equal phase
    51's, flat's skew equal to numpy's owner histogram (float32), each
    plan's kernels launched in every rank, and every launch held in its
    rank as in phase 51 (#12 of `_owner` too), into the kernels line's
    max |kernel - plain|; flat, hier and bcast's times (the slowest rank's)
    beside `dist_model`'s prediction and ranking (a record: the ranks share
    one card and the host's gloo).
54. The CLI in processes of their own: `baseline --config 5`, `dist
    --shuffle flat` (one NCCL rank, cross-checked), `dist --shuffle bcast
    --backend gloo` as two processes on the card (CCVE_* variables, a
    file:// rendezvous) and `roofline --dist --n-levels 2`.
55. The emission (#19, `emit_rows_i32`; `emit_phase`, runnable alone with
    config 1's table and probe column): config 1 through `bulk_materialize`
    on the int64 column, counter zeroed just before (rows and payload sum
    against numpy, one launch), then three levels at config 3's shape (1M
    probe rows, 50K keys a level; rows equal to the oracle's, three
    launches); the kernel against its plain version on config 1's
    compacted planes (16M rows, W = 1, F = 1) and at each of the three
    levels, exactly, and against the old torch emission at config 1; the
    kernel, its plain version and the old torch emission timed in turns,
    beside the kernel's byte bound.

Prints the per-kernel JSON line (26 kernels: `sort_runs_narrowed` is #1 on
the main paths and `sort_runs_narrowed_i64` #13 on the count side's, each
the narrowing tile sort with its ladder, timed as its tile sort alone on
the int64 column; `sort_tiles_i32` and `sort_tiles_i64`, their key-only
forms, run on no main path, so they read 0 launches, and are timed on the
packed, padded stream: each kernel's launches on its main paths,
#1-#3 and #12 with config 4's counted run among them, #6-#9 and #12 with
the distributed plans' counted runs (phases 51-53, one a plan),
max |kernel - plain|, its time, its plain version's, its bound and the
library call's), then the card line, then, only when every phase passed,
the last line `{"ok": true, "device": {...}}`. Any failure raises and
exits non-zero.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

# The run drives one card: only the first visible device is exposed, so
# the device count it reports is the count it used.
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The port comes from the checkout this script sits in; without it the
# script stops here, before any device work.
from ccve_tpu_torch.bench.configs import (  # noqa: E402
    TIME_REPS,
    check_sampled_triples,
    config4_data,
    config4_run,
    config4_zipf_pipeline,
    config1_materialize,
    config1_full_range_host,
    config1_single_join,
    config1_wide_host,
    config2_filtered_join,
    config3_data,
    config3_four_way,
    config6_data,
    config6_mixed_selectivity,
    config7_data,
    config7_heterogeneous_levels,
    median_run,
    numpy_totals,
)
from ccve_tpu_torch.config import CompactionStrategy, EngineConfig, PayloadMode  # noqa: E402
from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table  # noqa: E402
from ccve_tpu_torch.bench.profile_config1 import busy_window  # noqa: E402
from ccve_tpu_torch.bench import edge_cases, kernel_split, roofline  # noqa: E402
from ccve_tpu_torch.core import chunk as chunklib  # noqa: E402
from ccve_tpu_torch.core.collection import DataCollection  # noqa: E402
from ccve_tpu_torch.exec.bulk import (  # noqa: E402
    HASH_PLAIN,
    HashRoute,
    bulk_count,
    bulk_materialize,
    combine_levels,
    csr_match_stats,
    lp_match_stats,
)
from ccve_tpu_torch.exec.oracle import OracleBuildTable, oracle_join, oracle_pipeline  # noqa: E402
from ccve_tpu_torch.exec.sorted_pipeline import SortedPipeline  # noqa: E402
from ccve_tpu_torch.kernels import (  # noqa: E402
    _build,
    bigsort,
    ce_stages,
    compact,
    emit,
    merge_scan,
    murmur,
    pairsort,
)
from ccve_tpu_torch.kernels.chunk_probe import chunk_rank, chunk_rank_plain  # noqa: E402
from ccve_tpu_torch.kernels.drain import (  # noqa: E402
    MAX_PATHS,
    drain_segment,
    drain_segment_plain,
    occupancy_variant,
)
from ccve_tpu_torch.kernels.drain import grid as drain_grid  # noqa: E402
from ccve_tpu_torch.utils.profiler import ZebraProfiler  # noqa: E402
from ccve_tpu_torch.core.datagen import gen_microbench_keys, gen_zipf_keys  # noqa: E402
from ccve_tpu_torch.ops import aggregate  # noqa: E402
from ccve_tpu_torch.ops import sort as radix  # noqa: E402
from ccve_tpu_torch.ops import sort_merge as sm  # noqa: E402
from ccve_tpu_torch.ops.hash_table import (  # noqa: E402
    LPTable,
    build_csr,
    build_csr_device,
    build_lp,
)
from ccve_tpu_torch.ops.hashing import murmurhash64_np  # noqa: E402
from ccve_tpu_torch.parallel import distributed as pd  # noqa: E402
from ccve_tpu_torch.parallel.distributed import _owner  # noqa: E402

N_BUILD = 1_000_000
N_PROBE = 16_000_000
N_PROBE_WIDE = 1 << 24
REPS = 10
I32_MAX = 2**31 - 1
I64_MAX = 2**63 - 1


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = REPS) -> list[float]:
    """Per-call milliseconds of `reps` calls of `fn` by CUDA events, after
    one warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def med(ts) -> float:
    return float(np.median(ts))


def spread_ms(ts) -> str:
    return f"{med(ts):.4f} ms ({min(ts):.4f}, {max(ts):.4f})"


# slice 2's wrappers; #7's two entry points share one kernel source
NEW_WRAPPERS = {
    "sort_tiles_multi_i32": (pairsort.sort_tiles_multi_i32,),
    "merge_multi_i32": (pairsort.merge_level_multi_i32, pairsort.merge_two_multi_i32),
    "merge_stats_i32": (merge_scan.merge_stats_i32,),
    "compact_i32": (compact.compact_i32,),
    "expand_candidates_i32": (merge_scan.expand_candidates_i32,),
}


def candidates_view(out):
    """The expansion's candidates as their contract reads them: the
    planes on the valid slots, the mask, the total (elsewhere the kernel's
    payload plane holds 0, the plain version's a stale payload)."""
    planes, valid, total = out
    return planes[:, valid], valid, total


def candidates_work(L: int, fan_out: int) -> tuple[int, int]:
    """(bytes, integer operations) of the candidates over L elements: s and
    v read once, three int32 planes and a byte of mask written a slot; a
    few operations an element (tag, run start, the scan's combine)."""
    return 8 * L + 13 * fan_out * L, 8 * L


# the merge-path partition kernel that runs before each #7 merge level and
# merge of two and each count-side merge level (#2, #13; both key types):
# counted apart from the merges' launches
PARTITION = {"merge_partition": (pairsort.merge_partition,)}


def check_partitions(merge_launches: int, what: str) -> int:
    """The partition launches since PARTITION was zeroed, which must equal
    the merges' launches (one partition a #7 merge level and merge of two,
    and a count-side merge level)."""
    parts = read_counters(PARTITION)["merge_partition"]
    if parts != merge_launches:
        raise AssertionError(f"{what}: {parts} partition launches, {merge_launches} merges")
    return parts


# slice 3's wrappers, the int64 builds
WIDE_WRAPPERS = {
    "sort_runs_narrowed_i64": (bigsort.sort_runs_narrowed_i64,),
    "sort_tiles_i64": (bigsort.sort_tiles_i64,),
    "merge_level_i64": (bigsort.merge_level_i64,),
    "merge_counts_i64": (merge_scan.merge_counts_i64,),
    "sort_tiles_multi_i64": (pairsort.sort_tiles_multi_i64,),
    "merge_multi_i64": (pairsort.merge_level_multi_i64, pairsort.merge_two_multi_i64),
    "merge_stats_i64": (merge_scan.merge_stats_i64,),
}
# slice 4's kernel and the compaction it shares with slice 2, as the hash
# engines launch them
HASH_WRAPPERS = {
    "murmurhash64_i64": (murmur.murmurhash64_i64,),
    "compact_i32": (compact.compact_i32,),
}
# slice 3b's wrappers: #15's generic entry, #16, #4 and #5
SLICE_3B_WRAPPERS = {
    "merge_scan_stats_i64": (merge_scan.merge_scan_stats,),
    "merge_scan_stats_packed_i64": (merge_scan.merge_scan_stats_packed,),
    "merge_scan_build_counts_i32": (merge_scan.merge_scan_build_counts,),
    "merge_two_i32": (bigsort.merge_sorted_i32,),
}
SMALL_PROBE_NS = (1, 100, 8192)  # phase 37's probe counts on the small-probe route
HASH_OPS_PER_KEY = 10  # three shifts and xors, two 64-bit multiplies
PROFILED_CALLS = 5  # back-to-back calls in each idle-share trace
LADDER_HIT_PCTS = (5, 25, 50)  # hit rates of phase 22's probes, in percent
WIDE_COUNT = ("sort_runs_narrowed_i64", "merge_level_i64", "merge_counts_i64")
# the cases of `bench.edge_cases.merge_counts_case` whose slices outgrow
# #3 and #14's stage: a heavy key, and two tiles of one repeated key
SKEWED_COUNTS = ("one key holds most probes", "a tile of one key")
WIDE_STATS = ("sort_tiles_multi_i64", "merge_multi_i64", "merge_stats_i64")
# kernels whose plain version is itself the one PyTorch call that computes
# the same function (torch.sort per tile or run pair, torch.searchsorted):
# their library time is the plain time, not taken twice
LIBRARY_IS_PLAIN = {"sort_tiles_i32", "merge_level_i32", "sort_tiles_i64", "merge_level_i64"}
# kernels whose counters are read in a counted run and must read 0 there:
# #1's and #13's key-only tile sorts, which the count side's routes replaced
# by `sort_runs_narrowed` and `sort_runs_narrowed_i64` (kept for the tests,
# the measuring tools and `_count_side_bc`)
OFF_PATH = {"sort_tiles_i32", "sort_tiles_i64"}


def check_launched(launches: dict, what: str) -> None:
    """Raises unless every kernel of `launches` launched in the counted run
    `what`, but those of OFF_PATH, which must not have."""
    idle = [name for name, k in launches.items() if k == 0 and name not in OFF_PATH]
    if idle:
        raise AssertionError(f"kernels not launched by {what}: {idle}")
    ran = {name: launches[name] for name in OFF_PATH & launches.keys() if launches[name]}
    if ran:
        raise AssertionError(f"kernels of no main path launched by {what}: {ran}")


def counts_library(runs, run_len: int, b):
    """The merge counts' one-batch library yardstick: `torch.searchsorted`
    of b - 1 in the runs as [R, run_len] rows (padded with the key type's
    maximum, odd, so never equal to an even b - 1), right minus left,
    summed over the runs (`bench.kernel_split.merge_counts_cases`)."""
    rows = kernel_split._padded_view(runs, run_len)
    want = (b - 1).expand(rows.shape[0], -1).contiguous()
    return lambda: (torch.searchsorted(rows, want, right=True)
                    - torch.searchsorted(rows, want)).sum(0)


def zero_counters(wrappers: dict) -> None:
    for fns in wrappers.values():
        for fn in fns:
            fn.launches = 0


def read_counters(wrappers: dict) -> dict:
    return {name: sum(fn.launches for fn in fns) for name, fns in wrappers.items()}


def exact(max_err: dict):
    """The check `same`, keeping each kernel's largest difference in
    `max_err` (0 unless it raises)."""

    def same(name: str, got, want, what: str):
        """Exact equality of a kernel's output with its plain version's:
        a tensor, or a (keys, [planes]) / (a, b) structure of them."""
        if isinstance(want, (tuple, list)):
            if len(got) != len(want):
                raise AssertionError(f"{name} {what}: {len(got)} outputs vs {len(want)}")
            for g, w in zip(got, want):
                same(name, g, w, what)
            return
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {what}: {got.shape}/{got.dtype} "
                                 f"vs plain {want.shape}/{want.dtype}")
        err = 0
        if got.numel():
            err = int((got.long() - want.long()).abs().max())
        max_err[name] = max(max_err[name], err)
        if err:
            raise AssertionError(f"{name} {what}: max |kernel - plain| = {err}")

    return same


def stats_path(same, tbl, col, path, key="i32"):
    """The stats side's kernel route step by step at a path's shapes,
    on int32 (`key` "i32") or int64 ("i64") keys, each kernel against
    its plain version on the same input (`same`, from `exact`); returns
    the inputs, for the times."""
    tl = pairsort.TILE_LOG
    n = col.numel()
    pack = sm.stats_pack32_streams if key == "i32" else sm.stats_pack64_streams
    sort_tiles = getattr(pairsort, f"sort_tiles_multi_{key}")
    merge_level = getattr(pairsort, f"merge_level_multi_{key}")
    merge_two = getattr(pairsort, f"merge_two_multi_{key}")
    b32, p32 = pack(tbl, col)
    rows = torch.arange(n, dtype=torch.int32, device=col.device)
    pk, pv = pairsort.pad_to_tile(p32, [rows], tl)
    level_in = [sort_tiles(pk, pv, tl)]
    same(f"sort_tiles_multi_{key}", level_in[0], pairsort.sort_tiles_multi_plain(pk, pv, tl), path)
    for lv in range(max((pk.numel() >> tl) - 1, 0).bit_length()):
        k, v = level_in[-1]
        level_in.append(merge_level(k, v, tl + lv))
        same(f"merge_multi_{key}", level_in[-1],
             pairsort.merge_level_multi_plain(k, v, tl + lv), f"{path} level {tl + lv}")
    sk, sv = level_in.pop()
    two = (sk[:n], [x[:n] for x in sv], b32, [tbl.payloads.to(torch.int32)])
    merged = merge_two(*two)
    same(f"merge_multi_{key}", merged, pairsort.merge_two_multi_plain(*two), f"{path} merge two")
    return {"probe": (p32, rows), "tile": (pk, pv), "levels": level_in, "two": two,
            "merged": merged}


# (ms, what bounds it) of a kernel's bytes and integer operations, from the
# card's constants in bench/roofline.py
bound = roofline.bound_ms


def log2_ceil(x: int) -> int:
    return max(int(x) - 1, 0).bit_length()


def idle_share(fn) -> tuple[float, int]:
    """(the device's idle share, device events) over PROFILED_CALLS
    back-to-back calls of `fn` under torch.profiler: 1 - busy / window, as
    bench/profile_config1.py takes it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    events = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError("torch.profiler recorded no device events")
    busy, window = busy_window(events)
    return 1 - busy / window, len(events)


SYNC_PREFIX_CHUNKS = 16  # chunks of a cursor run read under the sync debug mode
IDLE_PREFIX_CHUNKS = 4  # chunks of a cursor run traced for the idle share


def host_syncs(fn):
    """(host syncs, result) of one call `fn()`, counted by
    `torch.cuda.set_sync_debug_mode`'s warnings."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            r = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's one-time "prototype feature" notice is no sync
    return sum("called a synchronizing" in str(w.message) for w in caught), r


def syncs_a_step(fn) -> tuple[int, int]:
    """(host syncs, work-loop steps) of one run `fn()` (a run's result)."""
    syncs, r = host_syncs(fn)
    return syncs, int(r["level_steps"].sum())


def cursor_timer(cells: dict):
    """A `timer` for the config functions (`median_run`'s signature) that
    reads each cursor case apart into `cells[name]`: its first run counted,
    #12's counter zeroed just before it and read just after (that run is
    also `median_run`'s warm-up, so its count is held to every timed run's
    and, by the config, to the oracle's); the timed runs (the median of 3
    after it where it took under 10 s, else that run itself); then, not
    counted, the host syncs a step over the stream's first
    SYNC_PREFIX_CHUNKS chunks (`torch.cuda.set_sync_debug_mode`) and the
    device idle share over its first IDLE_PREFIX_CHUNKS (torch.profiler)."""

    def timer(pipe, probe: np.ndarray, name: str = "", **run_kw) -> dict:
        murmur.murmurhash64_i64.launches = 0
        first = pipe.run(probe, **run_kw)
        launches = murmur.murmurhash64_i64.launches
        if not launches:
            raise AssertionError(f"{name}: #12 was not launched")
        r = median_run(pipe, probe, name=name, first=first, **run_kw)
        block = pipe.block
        syncs, steps = syncs_a_step(
            lambda: pipe.run(probe[: SYNC_PREFIX_CHUNKS * block], **run_kw))
        idle, n_ev = idle_share(lambda: pipe.run(probe[: IDLE_PREFIX_CHUNKS * block], **run_kw))
        cells[name] = {"first": first, "launches": launches, "times": r["all_seconds"],
                       "syncs": syncs, "sync_steps": steps, "idle": idle, "events": n_ev}
        return r

    return timer


def seconds_line(times) -> str:
    return (f"run() {med(times):.4f} s (median of {len(times)}: "
            f"{', '.join(f'{x:.4f}' for x in times)})")


def cursor_line(c: dict) -> str:
    """A `cursor_timer` cell's readings: its timed runs, steps and #12
    launches in its counted run, then its syncs and idle share."""
    steps = c["first"]["level_steps"].tolist()
    return (f"{seconds_line(c['times'])}; steps a level {steps} ({sum(steps)}), "
            f"{c['first']['seconds'] / max(sum(steps), 1) * 1e3:.4f} ms a step (counted run "
            f"{c['first']['seconds']:.4f} s); #12 launches {c['launches']}; host syncs a step "
            f"{c['syncs'] / c['sync_steps']:.3f} ({c['syncs']} in {c['sync_steps']} steps of the "
            f"first {SYNC_PREFIX_CHUNKS} chunks); device idle share {c['idle']:.4f} "
            f"({c['events']} device events in {PROFILED_CALLS} runs of the first "
            f"{IDLE_PREFIX_CHUNKS} chunks)")


def cursor_phases(card: str, same, host3: np.ndarray, want3: int) -> int:
    """Phases 41-44, slice 6's cursor executor (the module docstring says
    what each reads), on config 3's host probe table and oracle count.
    `same` holds a kernel against its plain version. Returns #12's
    launches in the counted runs: one run of each cursor case."""
    # ---- 41. #12 at the cursor probe's shape: 2048 keys through a sparse sel ---------
    rng41 = np.random.default_rng(41)
    n_sel41 = 700
    sel41 = np.concatenate([np.sort(rng41.choice(2048, n_sel41, replace=False)),
                            np.zeros(2048 - n_sel41, np.int64)])  # stale zeros past count
    picked41 = torch.from_numpy(host3[:2048, 0].copy()).cuda().gather(
        0, torch.from_numpy(sel41).cuda())
    same("murmurhash64_i64", murmur.murmurhash64_i64(picked41),
         murmur.murmurhash64_plain(picked41), "2048 keys through a sparse sel")
    log(f"phase #12 at the cursor probe's shape: ok, config 3's first 2048 level-0 keys "
        f"through a sel of {n_sel41} rows (stale zeros past count), equal to the plain version")

    cursor_launches = 0

    def cells_log(cells: dict, config: dict, extra=lambda entry: "") -> list[str]:
        nonlocal cursor_launches
        lines = []
        for name, c in cells.items():
            cursor_launches += c["launches"]
            case = name.split()[-1]
            lines.append(f"  {name}: {cursor_line(c)}{extra(config[case])}")
        return lines

    # ---- 42. config 3 on the cursor executor: CSR and LP, NONE and FULL --------------
    t0 = time.perf_counter()
    c42_log = []
    for kind in ("csr", "lp"):
        cells42: dict = {}
        config3 = config3_four_way(table_kind=kind, device="cuda", timer=cursor_timer(cells42))
        if config3["expected"] != want3:
            raise AssertionError(f"config 3: expected {config3['expected']}, oracle {want3}")
        c42_log += cells_log(cells42, config3)
    for strategy in (CompactionStrategy.NONE, CompactionStrategy.FULL):
        e = config3[f"sorted_{strategy.value}"]
        c42_log.append(f"  sorted executor {strategy.value}: streamed {e['seconds']:.4f} s, "
                       f"preloaded {e['preloaded_seconds']:.4f} s (best of {TIME_REPS})")
    log(f"phase config 3 cursor executor: ok ({time.perf_counter() - t0:.1f} s), 1M x 4 levels "
        f"x 50K, block 2048, count only, streamed: CSR and LP tables, NONE and FULL, count "
        f"{want3} each (the oracle's)")
    log(f"on [{card}], host clock around run() (synced):")
    for line in c42_log:
        log(line)

    # ---- 43. config 2: the filtered chaining join -----------------------------------
    t0 = time.perf_counter()
    host2 = gen_probe_table(1_000_000, 1, 100_000)
    keys2, pay2 = gen_rhs_table(100_000, 2)
    kept2 = host2[host2[:, 0] % 10 == 0]
    want2 = oracle_pipeline(kept2, [OracleBuildTable(keys2, pay2)], PayloadMode.REFERENCE).shape[0]
    cells43: dict = {}
    config2 = config2_filtered_join(device="cuda", timer=cursor_timer(cells43))
    if config2["expected"] != want2:
        raise AssertionError(f"config 2: expected {config2['expected']}, oracle {want2}")
    e = config2["sorted_full"]
    log(f"phase config 2: ok ({time.perf_counter() - t0:.1f} s), 1M probes behind key % 10 == 0 "
        f"x 100K builds (chunk factor 2), block 2048: FULL, DYNAMIC (host tuner) and "
        f"sorted_full count {want2} (the oracle's)")
    log(f"on [{card}], host clock around run() (synced):")
    for line in cells_log(cells43, config2):
        log(line)
    log(f"  sorted_full: streamed {e['seconds']:.4f} s, preloaded {e['preloaded_seconds']:.4f} s "
        f"(best of {TIME_REPS})")

    # ---- 44. config 6: phase-alternating selectivity ----------------------------------
    t0 = time.perf_counter()
    want6 = config6_data(2_000_000, 50_000, 2048, 128, 10)[3]
    cells44: dict = {}
    config6 = config6_mixed_selectivity(device="cuda", timer=cursor_timer(cells44))
    if config6["expected"] != want6:
        raise AssertionError(f"config 6: expected {config6['expected']}, oracle {want6}")

    def tuner_line(entry: dict) -> str:
        if "greedy_thresholds" not in entry:
            return ""
        return (f"; greedy thresholds {entry['greedy_thresholds']}, committed "
                f"{entry['bandit_committed']} at round {entry['bandit_commit_round']}")

    log(f"phase config 6: ok ({time.perf_counter() - t0:.1f} s), 2M x 2 levels x 50K behind key "
        f"% 10 == 0 in phases of 128 chunks, block 2048: NONE, FULL, DYNAMIC on the host and "
        f"the device tuner count {want6} (the oracle's); dynamic_vs_best_static "
        f"{config6['dynamic_vs_best_static']:.4f}")
    log(f"on [{card}], host clock around run() (synced):")
    for line in cells_log(cells44, config6, tuner_line):
        log(line)
    return cursor_launches


def cli_cursor_phase(card: str, known_good: tuple, cli_pipeline, repo_root: str) -> None:
    """Phase 45, the cursor executor through the CLI."""
    # ---- 45. the CLI: pipeline --executor pipeline, strategy-matrix, microbench -------
    t0 = time.perf_counter()
    cli45 = []
    for table in ("csr", "lp"):
        lines = cli_pipeline(*[a if a != "sorted" else table for a in known_good[:-2]],
                             "--strategy", "full")
        if " [Result Rows] 2992" not in lines or f"table: {table}, executor: pipeline" not in lines[0]:
            raise AssertionError(f"cli pipeline --table {table} --executor pipeline:\n"
                                 + "\n".join(lines))
        cli45.append(f"{table}: " + "; ".join(x.strip() for x in lines
                                              if "[Result Rows]" in x or "[Total Time]" in x))
    env45 = dict(os.environ, PYTHONPATH=repo_root)
    matrix_args = ("--join-num", "2", "--lhs-size", "200000", "--rhs-size", "20000")
    proc = subprocess.run([sys.executable, "-m", "ccve_tpu_torch.cli", "strategy-matrix",
                           *matrix_args], capture_output=True, text=True, timeout=600,
                          cwd=repo_root, env=env45)
    want45 = oracle_pipeline(gen_probe_table(200_000, 2, 20_000),
                             [OracleBuildTable(*gen_rhs_table(20_000, 2))] * 2).shape[0]
    lines = proc.stderr.splitlines()
    if proc.returncode != 0 or lines.count(f" [Result Rows] {want45}") != 4:
        raise AssertionError(f"cli strategy-matrix: rc {proc.returncode}\n{proc.stderr}")
    cli45.append("strategy-matrix " + " ".join(matrix_args) + ": " + "; ".join(
        x.strip() for x in lines if "==== strategy" in x or "[Total Time]" in x))
    n_micro = 1 << 20
    proc = subprocess.run([sys.executable, "-m", "ccve_tpu_torch.cli", "microbench",
                           "--n-keys", str(n_micro)], capture_output=True, text=True,
                          timeout=600, cwd=repo_root, env=env45)
    micro_keys = gen_microbench_keys(n_micro, 128, 1)
    micro_build = gen_rhs_table(128, 1)[0]
    want_micro = int(np.searchsorted(np.sort(micro_build), micro_keys, side="right").sum()
                     - np.searchsorted(np.sort(micro_build), micro_keys, side="left").sum())
    lines = [x for x in proc.stderr.splitlines() if "#tuples" in x]
    if proc.returncode != 0 or len(lines) != 6 or any(
            x.split("#tuples")[1].split()[0] != str(want_micro) for x in lines):
        raise AssertionError(f"cli microbench: rc {proc.returncode}, numpy {want_micro}\n"
                             f"{proc.stderr}")
    cli45.append(f"microbench --n-keys {n_micro} (numpy {want_micro} tuples; a check, its "
                 f"times mostly launches and host syncs at this size):\n"
                 + "\n".join(proc.stderr.rstrip().splitlines()))
    log(f"phase cli cursor executor: ok ({time.perf_counter() - t0:.1f} s) on [{card}]:\n  "
        + "\n  ".join(cli45))


# config 4 at its full size (BASELINE.json configs[3]) and the answers
# numpy gives for the JAX package's generators there
CONFIG4 = dict(n_probe=4_000_000, domain=100_000, alpha=1.1)
CONFIG4_WANT = {
    "matches": 4_000_000,
    "n_groups": 94_963,
    "top_group": [5_450_084_928_405, 93_591],
    "partition_hist_16": [240025, 128817, 186030, 190337, 130254, 165008, 844683, 160400,
                          164349, 251715, 196425, 430685, 201314, 174876, 151089, 383993],
}
CONFIG4_SKEW = 3.378732  # partition_skew_16, to 6 decimals
# the kernels config 4's query and histogram launch: the count side (#1-#3)
# through `sorted_build_counts` and #12 through `partition_histogram`
CONFIG4_WRAPPERS = {
    "sort_runs_narrowed": (bigsort.sort_runs_narrowed,),
    "sort_tiles_i32": (bigsort.sort_tiles_i32,),
    "merge_level_i32": (bigsort.merge_level_i32,),
    "merge_counts_i32": (merge_scan.merge_counts_i32,),
    "murmurhash64_i64": (murmur.murmurhash64_i64,),
}


def groups_numpy(keys: np.ndarray, vals: np.ndarray):
    """(group keys, count, sum, min, max) of a group-by in numpy."""
    order = np.argsort(keys, kind="stable")
    sk, sv = keys[order], vals[order]
    uniq, starts = np.unique(sk, return_index=True)
    counts = np.diff(np.append(starts, sk.size))
    return (uniq, counts, np.add.reduceat(sv, starts), np.minimum.reduceat(sv, starts),
            np.maximum.reduceat(sv, starts))


def config4_phases(card: str, repo_root: str, same) -> dict:
    """Phases 46-50, slice 8 (the module docstring says what each reads).
    Returns the launches of #1, #2, #3 and #12 in config 4's counted run
    (one query and one histogram). `same` holds a kernel's output against
    its plain version's and records the error on the kernels line."""
    cuda = torch.device("cuda")
    domain = CONFIG4["domain"]

    # ---- 46. config 4 at full size ------------------------------------------------------
    t0 = time.perf_counter()
    c4 = config4_zipf_pipeline(device="cuda", **CONFIG4)
    got = {key: c4[key] for key in CONFIG4_WANT}
    if got != CONFIG4_WANT or round(c4["partition_skew_16"], 6) != CONFIG4_SKEW:
        raise AssertionError(f"config 4: {got}, skew {c4['partition_skew_16']}; "
                             f"want {CONFIG4_WANT}, {CONFIG4_SKEW}")
    table4, probe4, host4 = config4_data(device=cuda, **CONFIG4)
    torch.cuda.synchronize()
    zero_counters(CONFIG4_WRAPPERS)
    zero_counters(PARTITION)
    out4 = config4_run(table4, probe4, domain)
    hist4 = aggregate.partition_histogram(probe4, 16)
    torch.cuda.synchronize()
    launches4 = read_counters(CONFIG4_WRAPPERS)
    parts4 = check_partitions(launches4["merge_level_i32"], "config 4 run()")
    check_launched(launches4, "config 4's run and histogram")
    got4 = [int(x) for x in out4]
    want4 = [CONFIG4_WANT["matches"], CONFIG4_WANT["n_groups"], *CONFIG4_WANT["top_group"]]
    if got4 != want4 or hist4.tolist() != CONFIG4_WANT["partition_hist_16"]:
        raise AssertionError(f"config 4's counted run: {got4}, {hist4.tolist()}")
    # the counted run's kernels at its shapes, each against its plain version
    p4, b4 = sm.pack32_streams(table4, probe4)
    n4, m4 = p4.numel(), b4.numel()
    n_pad4, run_log4 = sm.count_side_plan(n4, m4, bigsort.TILE_LOG)
    padded4 = torch.cat([p4, p4.new_full((n_pad4 - n4,), I32_MAX)])
    runs4 = bigsort.sort_tiles_i32(padded4, bigsort.TILE_LOG)
    same("sort_tiles_i32", runs4, bigsort.sort_tiles_plain(padded4, bigsort.TILE_LOG),
         "config 4")
    levels4 = range(bigsort.TILE_LOG, bigsort.TILE_LOG + launches4["merge_level_i32"])
    for lv in levels4:
        out = bigsort.merge_level_i32(runs4, lv)
        same("merge_level_i32", out, bigsort.merge_level_plain(runs4, lv),
             f"config 4 run_log={lv}")
        runs4 = out
    same("merge_level_i32", bigsort.sort_runs(padded4, run_log4),
         bigsort.sort_runs_plain(padded4, run_log4), "config 4 sort_runs")
    bounds4 = sm._narrow_bounds(table4)
    same("sort_runs_narrowed", bigsort.sort_runs_narrowed(probe4, *bounds4, n_pad4, run_log4),
         bigsort.sort_runs_narrowed_plain(probe4, *bounds4, n_pad4, run_log4), "config 4")
    bc4 = merge_scan.merge_counts_i32(runs4, 1 << run_log4, n4, b4, m4)
    same("merge_counts_i32", bc4,
         merge_scan.merge_counts_plain(runs4, 1 << run_log4, n4, b4, m4), "config 4")
    same("murmurhash64_i64", murmur.murmurhash64_i64(probe4), murmur.murmurhash64_plain(probe4),
         "config 4's probe keys")
    if int(bc4.sum()) != CONFIG4_WANT["matches"]:
        raise AssertionError(f"config 4's counts at its shapes sum to {int(bc4.sum())}")
    hist_syncs, _ = host_syncs(lambda: aggregate.partition_histogram(probe4, 16))
    if hist_syncs:
        raise AssertionError(f"partition_histogram read back from the card {hist_syncs} times")
    log(f"phase config 4 kernels at its shapes: ok, equal to their plain versions: "
        f"sort_runs_narrowed on the {n4} int64 probe keys, "
        f"sort_tiles_i32 on {n_pad4} packed probes, merge_level_i32 at run_log "
        f"{list(levels4)} and sort_runs to runs of 2^{run_log4}, merge_counts_i32 against "
        f"{m4} builds, murmurhash64_i64 on {probe4.numel()} keys; partition_histogram "
        f"reads nothing back")
    run_ms = cuda_ms(lambda: config4_run(table4, probe4, domain))
    agg_ms = cuda_ms(lambda: aggregate.join_dense_aggregate(table4, probe4, domain))
    bc_ms = cuda_ms(lambda: sm.sorted_build_counts(table4, probe4))
    agg4, _ = aggregate.join_dense_aggregate(table4, probe4, domain)
    order_ms = cuda_ms(lambda: radix.xla_sort_pairs(agg4.sum, agg4.keys))
    hist_ms = cuda_ms(lambda: aggregate.partition_histogram(probe4, 16))
    owner4 = _owner(probe4, 16)
    bincount_ms = cuda_ms(lambda: torch.bincount(owner4, minlength=16))  # reads back
    idle_run4, ev4 = idle_share(lambda: config4_run(table4, probe4, domain))
    table4_cpu = sm.build_sorted(*gen_rhs_table(domain, 1), device="cpu")
    probe4_cpu = torch.from_numpy(host4)
    t_plain = time.perf_counter()
    plain4 = [int(x) for x in config4_run(table4_cpu, probe4_cpu, domain)]
    plain4_s = time.perf_counter() - t_plain
    if plain4 != want4:
        raise AssertionError(f"config 4 on the CPU path: {plain4}")
    log(f"phase config 4: ok ({time.perf_counter() - t0:.1f} s), {json.dumps(c4)}")
    log(f"  config4_zipf_pipeline on [{card}]: seconds {c4['seconds']!r} (CUDA events, best of "
        f"{TIME_REPS} after a warm-up), rows_per_s {c4['rows_per_s']!r}; counted run (one "
        f"query, one histogram): launches {launches4}, partitions {parts4}; matches, n_groups "
        f"and the ORDER BY's last (sum, key) {got4}, the histogram and the CPU path's answer "
        f"{plain4} ({plain4_s:.3f} s on the host) equal numpy's")
    log(f"  CUDA events, median (min, max) of {REPS}: run() {med(run_ms):.4f} ms "
        f"({min(run_ms):.4f}, {max(run_ms):.4f}); join_dense_aggregate {med(agg_ms):.4f}, "
        f"of it sorted_build_counts {med(bc_ms):.4f}; ORDER BY (xla_sort_pairs of "
        f"{domain} pairs) {med(order_ms):.4f}; partition_histogram(16) {med(hist_ms):.4f} "
        f"(a bincount of its owners alone, with its read-back, {med(bincount_ms):.4f}); "
        f"device idle share of run() {idle_run4:.4f} ({ev4} device events in "
        f"{PROFILED_CALLS} calls)")

    # ---- 47. the aggregates on the card at 4M Zipf keys ------------------------------
    t0 = time.perf_counter()
    vals47 = np.random.default_rng(47).integers(-(2**40), 2**40, host4.size, dtype=np.int64)
    vals47_d = torch.from_numpy(vals47).to(cuda)
    gk, gc, gs, gmn, gmx = groups_numpy(host4, vals47)
    ng = gk.size
    if ng != CONFIG4_WANT["n_groups"]:
        raise AssertionError(f"numpy's groups {ng}")
    pad = host4.size - ng
    want_h = (np.concatenate([gk, np.zeros(pad, np.int64)]),
              np.concatenate([gc, np.zeros(pad, np.int64)]),
              np.concatenate([gs, np.zeros(pad, np.int64)]),
              np.concatenate([gmn, np.full(pad, I64_MAX, np.int64)]),
              np.concatenate([gmx, np.full(pad, -I64_MAX - 1, np.int64)]))
    dense = [np.zeros(domain, np.int64), np.zeros(domain, np.int64),
             np.full(domain, I64_MAX, np.int64), np.full(domain, -I64_MAX - 1, np.int64)]
    for col, v in zip(dense, (gc, gs, gmn, gmx)):
        col[gk] = v
    want_d = (np.arange(domain, dtype=np.int64), *dense)
    fields = ("keys", "count", "sum", "min", "max")
    for name, res, want in (
            ("hash_aggregate", aggregate.hash_aggregate(probe4, vals47_d), want_h),
            ("dense_aggregate", aggregate.dense_aggregate(probe4, vals47_d, domain), want_d)):
        for field, w in zip(fields, want):
            if not np.array_equal(getattr(res, field).cpu().numpy(), w):
                raise AssertionError(f"{name}.{field} differs from numpy's")
        if int(res.n_groups) != ng:
            raise AssertionError(f"{name}.n_groups {int(res.n_groups)}, numpy {ng}")
    jd, jd_total = aggregate.join_dense_aggregate(table4, probe4, domain)
    jp, jp_total = aggregate.join_dense_aggregate(table4_cpu, probe4_cpu, domain)
    for field in (*fields, "n_groups"):
        if not torch.equal(getattr(jd, field).cpu(), getattr(jp, field)):
            raise AssertionError(f"join_dense_aggregate.{field}: the card's differs from "
                                 "the CPU path's")
    if int(jd_total) != int(jp_total):
        raise AssertionError(f"join_dense_aggregate: matches {int(jd_total)}, CPU {int(jp_total)}")
    hash_ms = cuda_ms(lambda: aggregate.hash_aggregate(probe4, vals47_d))
    dense_ms = cuda_ms(lambda: aggregate.dense_aggregate(probe4, vals47_d, domain))
    log(f"phase aggregates at 4M Zipf keys: ok ({time.perf_counter() - t0:.1f} s), "
        f"hash_aggregate and dense_aggregate equal numpy's count, sum, min and max of each of "
        f"{ng} groups, with the padding; join_dense_aggregate equal to the CPU path field by "
        f"field")
    log(f"  on [{card}], CUDA events, median (min, max) of {REPS}: hash_aggregate "
        f"{med(hash_ms):.4f} ms ({min(hash_ms):.4f}, {max(hash_ms):.4f}), dense_aggregate "
        f"{med(dense_ms):.4f} ({min(dense_ms):.4f}, {max(dense_ms):.4f}), "
        f"join_dense_aggregate {med(agg_ms):.4f} (phase 46)")

    # ---- 48. the LSD radix sort on the card ---------------------------------------------
    t0 = time.perf_counter()
    radix_log = []
    for what, keys48, vals48, bits in (
            (f"config 4's {domain} (sum, key) pairs", agg4.sum, agg4.keys, 64),
            (f"{host4.size} Zipf keys with their row ids", probe4,
             torch.arange(host4.size, device=cuda), 17)):
        got48 = radix.radix_sort_pairs(keys48, vals48, bits=bits)
        want48 = radix.xla_sort_pairs(keys48, vals48)
        if not all(torch.equal(g, w) for g, w in zip(got48, want48)):
            raise AssertionError(f"radix_sort_pairs on {what} differs from a stable torch.sort")
        r_ms = cuda_ms(lambda: radix.radix_sort_pairs(keys48, vals48, bits=bits))
        t_ms = cuda_ms(lambda: radix.xla_sort_pairs(keys48, vals48))
        radix_log.append(f"  {what}, bits {bits}: radix_sort_pairs {med(r_ms):.4f} ms "
                         f"({min(r_ms):.4f}, {max(r_ms):.4f}), stable torch.sort and a gather "
                         f"{med(t_ms):.4f} ({min(t_ms):.4f}, {max(t_ms):.4f})")
    log(f"phase radix_sort_pairs: ok ({time.perf_counter() - t0:.1f} s), equal to a stable "
        f"torch.sort on both inputs; on [{card}], CUDA events, median (min, max) of {REPS}:")
    for line in radix_log:
        log(line)

    # ---- 49. build_csr_device on the card -------------------------------------------------
    t0 = time.perf_counter()
    csr_log = []
    for what, (keys49, pays49) in (("config 3's build table (50K unique keys)",
                                    gen_rhs_table(50_000, 1)),
                                   ("config 2's (100K rows, 2 a key)", gen_rhs_table(100_000, 2))):
        t_host = time.perf_counter()
        host49 = build_csr(keys49, pays49, device="cuda")
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t_host
        k49, p49 = torch.from_numpy(keys49).to(cuda), torch.from_numpy(pays49).to(cuda)
        syncs49, dev49 = host_syncs(
            lambda: build_csr_device(k49, p49, host49.n_buckets, host49.max_len))
        if syncs49:
            raise AssertionError(f"build_csr_device on {what} read back {syncs49} times")
        for field in ("offsets", "entry_keys", "entry_payloads"):
            if not torch.equal(getattr(dev49, field), getattr(host49, field)):
                raise AssertionError(f"build_csr_device.{field} on {what} differs from build_csr")
        c_ms = cuda_ms(lambda: build_csr_device(k49, p49, host49.n_buckets, host49.max_len))
        csr_log.append(f"  {what}: build_csr_device {med(c_ms):.4f} ms ({min(c_ms):.4f}, "
                       f"{max(c_ms):.4f}); build_csr on the host and its upload "
                       f"{host_s * 1e3:.1f} ms (host clock, one call)")
    log(f"phase build_csr_device: ok ({time.perf_counter() - t0:.1f} s), equal to build_csr "
        f"entry for entry, nothing read back; on [{card}], CUDA events, median (min, max) "
        f"of {REPS}:")
    for line in csr_log:
        log(line)

    # ---- 50. the CLI: baseline --config 4 -------------------------------------------------
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ccve_tpu_torch.cli", "baseline", "--config",
                           "4"], capture_output=True, text=True, timeout=600, cwd=repo_root,
                          env=dict(os.environ, PYTHONPATH=repo_root))
    if proc.returncode != 0:
        raise AssertionError(f"cli baseline --config 4: rc {proc.returncode}\n{proc.stderr}")
    cli4 = json.loads(proc.stdout.strip().splitlines()[-1])
    if (cli4["matches"], cli4["n_groups"]) != (c4["matches"], c4["n_groups"]):
        raise AssertionError(f"cli baseline --config 4: {cli4}")
    log(f"phase cli baseline --config 4: ok ({time.perf_counter() - t0:.1f} s), "
        f"{json.dumps(cli4)}")
    return launches4


# ---- slice 9: the distributed tier at config 5 ----------------------------------------

# config 5 at its full size (JAX's defaults, none cut) and the answers numpy
# gives for the generators there: the uniform probes, and the Zipf probes of
# the PRPD plan (`bootstrap.run_dist_join`'s, seed 11)
CONFIG5 = dict(n_build=100_000, n_probe=1_000_000)
CONFIG5_WANT = (999_990, [10_049_810_862_256])
CONFIG5_PRPD_WANT = (1_000_000, [10_058_256_117_134])
# the flat plan's skew of the uniform probes: the largest owner's keys over
# the mean, in float32 (P = 2: [499,973, 500,027]; P = 4: [249,567, 250,406,
# 249,561, 250,466])
CONFIG5_SKEW = {1: 1.0, 2: float(np.float32(500_027) / np.float32(500_000)),
                4: float(np.float32(250_466) / np.float32(250_000))}
HIER_SHAPES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
# the kernels the distributed plans launch: the stats side (#6-#8) on sorted
# partitions, #12 in `_owner` (P > 1) and the hash drains, #9 on the LP
# ladder and in `sorted_expand`
DIST_WRAPPERS = {
    "sort_tiles_multi_i32": (pairsort.sort_tiles_multi_i32,),
    "merge_multi_i32": (pairsort.merge_level_multi_i32, pairsort.merge_two_multi_i32),
    "merge_stats_i32": (merge_scan.merge_stats_i32,),
    "compact_i32": (compact.compact_i32,),
    "murmurhash64_i64": (murmur.murmurhash64_i64,),
    "expand_candidates_i32": (merge_scan.expand_candidates_i32,),
}
STATS_SIDE = ("sort_tiles_multi_i32", "merge_multi_i32", "merge_stats_i32")


def config5_data():
    """(build keys, payloads, uniform probe [n, 1], Zipf probe [n, 1], its
    hot keys): config 5's inputs, as `bootstrap.run_dist_join` makes them."""
    keys, payloads = gen_rhs_table(CONFIG5["n_build"], 1)
    probe = gen_probe_table(CONFIG5["n_probe"], 1, CONFIG5["n_build"])
    zipf = gen_zipf_keys(CONFIG5["n_probe"], CONFIG5["n_build"], 1.1, seed=11)[:, None]
    return keys, payloads, probe, zipf, pd.detect_heavy_hitters(zipf[:262_144])


def summary(res) -> tuple:
    return (int(res.count), res.payload_checksums.tolist(), float(res.skew), bool(res.overflow))


def counted_calls(run, names=("match_stats", "sorted_expand", "_owner")):
    """(run()'s result, its launches of DIST_WRAPPERS, (name, args) of
    every `names` call it made), all of one run: every counter set to 0
    just before and read just after; the calls are the plans' local probes
    and owner hashes, to hold their kernels at these shapes. The recording
    wraps the names in `parallel.distributed` for this call only."""
    seen = []
    real = {name: getattr(pd, name) for name in names}

    def recorder(name):
        def call(*args, **kw):
            seen.append((name, args))
            return real[name](*args, **kw)
        return call

    torch.cuda.synchronize()
    zero_counters(DIST_WRAPPERS)
    try:
        for name in names:
            setattr(pd, name, recorder(name))
        out = run()
    finally:
        for name, fn in real.items():
            setattr(pd, name, fn)
    torch.cuda.synchronize()
    return out, read_counters(DIST_WRAPPERS), seen


def config5_rank(device: str) -> dict:
    """Phase 53 on one rank of a gloo group whose ranks all compute on
    `device` (one card): every plan at config 5's full size, each with the
    launch counters zeroed just before it, its answer, its launches and
    its time (`configs.time_call`: CUDA events, best of TIME_REPS after a
    warm-up); each kernel the plan launched in this rank held against its
    plain version at the rank's shapes (`hold_probes`); then the dry run.
    The same on every rank but the launches, the held probes and the
    kernels' largest differences."""
    from ccve_tpu_torch.bench.configs import time_call
    from ccve_tpu_torch.parallel.dryrun import dryrun_multichip

    P = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    keys, payloads, probe, zipf, hot = config5_data()
    out, launches, ms, held = {}, {}, {}, {}
    max_err = dict.fromkeys(DIST_WRAPPERS, 0)
    same = exact(max_err)

    def run_plan(name, run):
        res, launches[name], calls = counted_calls(run)
        out[name] = summary(res)
        held[name] = hold_probes(calls, launches[name], same, f"P = {P} rank {rank} {name}")

    with pd.make_join_mesh(P, device, "gloo") as mesh:
        dev = mesh.device
        probe_d, zipf_d = (torch.from_numpy(x).to(dev) for x in (probe, zipf))
        parts = [pd.partition_tables(keys, payloads, P, "sorted", mesh)]
        blocks = [pd.partition_tables_block(keys, payloads, P, "sorted", mesh)]
        reps = [pd.replicate_tables(keys, payloads, "sorted", mesh)]
        split = [pd.partition_tables_split(keys, payloads, P, hot, "sorted", mesh)]
        plans = {
            "flat": lambda: pd.dist_bulk_count(mesh, parts, probe_d),
            "ring": lambda: pd.dist_bulk_count_ring(mesh, blocks, probe_d),
            "bcast": lambda: pd.dist_bulk_count_bcast(mesh, reps, probe_d),
            "prpd": lambda: pd.dist_bulk_count(mesh, split, zipf_d),
        }
        for name, run in plans.items():
            run_plan(name, run)
        for name in ("flat", "bcast"):
            ms[name] = time_call(plans[name], dev)[0] * 1e3
    for shape in HIER_SHAPES[P]:
        name = f"hier_{shape[0]}x{shape[1]}"
        with pd.make_join_mesh_2d(*shape, device, "gloo") as mesh2:
            tables = [pd.partition_tables(keys, payloads, P, "sorted", mesh2)]
            probe_d = torch.from_numpy(probe).to(mesh2.device)
            run = lambda: pd.dist_bulk_count_hier(mesh2, tables, probe_d)  # noqa: E731
            run_plan(name, run)
            ms[name] = time_call(run, mesh2.device)[0] * 1e3
    out["dryrun"] = dryrun_multichip(P, device) if P == 2 else None
    return {"results": out, "launches": launches, "ms": ms, "held": held, "max_err": max_err}


def hold_probes(calls, launches, same, what: str) -> list[int]:
    """Each kernel launch of a plan's run, against the kernel's plain
    version at the shapes the plan gave it: the stats side's sort, merges
    and scan (#6-#8) on sorted tables, #9 of `sorted_expand`, the hash
    drains' #12 and #9 (replayed on a route that records their inputs),
    #12 of `_owner` for more than one part. `calls` and `launches` are of
    one run; the held launches must equal `launches` kernel by kernel, so
    that none goes unheld. Returns the sizes of the probes held."""
    held = dict.fromkeys(launches, 0)

    def check(name, got, want, tag):
        held[name] += 1
        same(name, got, want, tag)

    probes = [(name, args[0], args[1].contiguous()) for name, args in calls
              if name != "_owner" and args[1].numel()]
    owners = [args[0] for name, args in calls
              if name == "_owner" and args[1] > 1 and args[0].numel()]
    hashed, stages = [], []

    def hash_rec(keys):
        hashed.append(keys)
        return murmur.murmurhash64_i64(keys)

    def compact_rec(planes, mask):
        stages.append((planes, mask))
        return compact.compact_i32(planes, mask)

    recording = HashRoute(hash_rec, compact_rec)
    for name, table, keys in probes:
        tag = f"{what}: {name} of {keys.numel()} keys"
        if isinstance(table, sm.SortedTable):
            if sm.stats_key_type(table) != torch.int32:
                raise AssertionError(f"{tag}: a config-5 table off the int32 kernel route")
            inputs = stats_path(check, table, keys, tag)
            if name == "sorted_expand":
                s, (v,) = inputs["merged"]
                fan_out = max(int(table.max_mult), 1)
                check("expand_candidates_i32",
                      candidates_view(merge_scan.expand_candidates_i32(s, v, fan_out)),
                      candidates_view(merge_scan.expand_candidates_plain(s, v, fan_out)), tag)
                planes, valid, _ = sm.expand_candidates(table, keys)
                check("compact_i32", compact.compact_i32(planes, valid),
                      compact.compact_plain(planes, valid), tag)
            else:
                s, (v,) = inputs["merged"]
                check("merge_stats_i32", merge_scan.merge_stats_i32(s, v, keys.numel()),
                      merge_scan.merge_stats_plain(s, v, keys.numel()), tag)
            continue
        drain = lp_match_stats if isinstance(table, LPTable) else csr_match_stats
        drain(table, keys.to(torch.int64), route=recording)
    for keys in [*owners, *hashed]:
        k64 = keys.to(torch.int64).contiguous()
        check("murmurhash64_i64", murmur.murmurhash64_i64(k64), murmur.murmurhash64_plain(k64),
              f"{what}: the hash of {keys.numel()} keys")
    for planes, mask in stages:
        check("compact_i32", compact.compact_i32(planes, mask),
              compact.compact_plain(planes, mask), f"{what}: a hash drain's stage")
    if not probes or held != launches:
        raise AssertionError(f"{what}: launches {launches}, held {held} ({len(probes)} "
                             f"probes, {len(owners)} owner hashes recorded)")
    return [keys.numel() for _, _, keys in probes]


def dist_phases(card: str, repo_root: str, max_err: dict) -> dict:
    """Phases 51-54, slice 9 (the module docstring says what each reads).
    Returns the launches of DIST_WRAPPERS in the counted runs (one a plan;
    phase 53's summed over its ranks); every one of them is held against
    its plain version into `max_err`."""
    from ccve_tpu_torch.bench.dist_model import predict, ranking
    from ccve_tpu_torch.parallel import bootstrap
    from ccve_tpu_torch.parallel.dist_aggregate import collect_groups, dist_aggregate

    total = dict.fromkeys(DIST_WRAPPERS, 0)
    same = exact(max_err)

    def add(launches):
        for name, k in launches.items():
            total[name] += k

    # ---- 51. config 5 on one rank (NCCL, world 1) -----------------------------------
    t0 = time.perf_counter()
    keys, payloads, probe, zipf, hot = config5_data()
    want = numpy_totals(keys, payloads, probe[:, 0])
    want_z = numpy_totals(keys, payloads, zipf[:, 0])
    if (want[0], [want[1]]) != CONFIG5_WANT or (want_z[0], [want_z[1]]) != CONFIG5_PRPD_WANT:
        raise AssertionError(f"numpy: {want}, PRPD {want_z}")
    table = sm.build_sorted(keys, payloads, device="cuda")
    probe_d = torch.from_numpy(probe).cuda()
    zipf_d = torch.from_numpy(zipf).cuda()
    one = bulk_count([table], probe_d)
    if (int(one.count), one.payload_checksums.tolist()) != CONFIG5_WANT:
        raise AssertionError(f"config 5's one-card bulk_count: {int(one.count)}")
    lines51 = []
    with pd.make_join_mesh(1, "cuda") as mesh:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError(f"phase 51 runs on {torch.distributed.get_backend()}")
        tables = {kind: [pd.partition_tables(keys, payloads, 1, kind, mesh)]
                  for kind in ("sorted", "lp", "csr")}
        blocks = [pd.partition_tables_block(keys, payloads, 1, "sorted", mesh)]
        reps = [pd.replicate_tables(keys, payloads, "sorted", mesh)]
        split = [pd.partition_tables_split(keys, payloads, 1, hot, "sorted", mesh)]
        plans = {
            **{f"flat {kind}": (lambda t=t: pd.dist_bulk_count(mesh, t, probe_d), CONFIG5_WANT,
                                STATS_SIDE if kind == "sorted" else
                                ("murmurhash64_i64", "compact_i32") if kind == "lp" else
                                ("murmurhash64_i64",))
               for kind, t in tables.items()},
            "ring": (lambda: pd.dist_bulk_count_ring(mesh, blocks, probe_d), CONFIG5_WANT,
                     STATS_SIDE),
            "bcast": (lambda: pd.dist_bulk_count_bcast(mesh, reps, probe_d), CONFIG5_WANT,
                      STATS_SIDE),
            "prpd": (lambda: pd.dist_bulk_count(mesh, split, zipf_d), CONFIG5_PRPD_WANT,
                     STATS_SIDE),
        }
        for name, (run, want_plan, needed) in plans.items():
            res, launches, calls = counted_calls(run)
            got = summary(res)
            if got != (*want_plan, 1.0, False):
                raise AssertionError(f"config 5 {name} on one rank: {got}")
            idle = [k for k in needed if not launches[k]]
            if idle:
                raise AssertionError(f"config 5 {name}: kernels not launched: {idle}")
            add(launches)
            sizes = hold_probes(calls, launches, same, f"config 5 {name}")
            ms = cuda_ms(run)
            lines51.append(f"  {name}: {spread_ms(ms)}; launches {launches}; "
                           f"{len(sizes)} local probe(s) of {sizes} keys")
    with pd.make_join_mesh_2d(1, 1, "cuda") as mesh2:
        tables2 = [pd.partition_tables(keys, payloads, 1, "sorted", mesh2)]
        run = lambda: pd.dist_bulk_count_hier(mesh2, tables2, probe_d)  # noqa: E731
        res, launches, calls = counted_calls(run)
        if summary(res) != (*CONFIG5_WANT, 1.0, False):
            raise AssertionError(f"config 5 hier 1x1: {summary(res)}")
        if not all(launches[k] for k in STATS_SIDE):
            raise AssertionError(f"config 5 hier 1x1: launches {launches}")
        add(launches)
        sizes = hold_probes(calls, launches, same, "config 5 hier 1x1")
        lines51.append(f"  hier 1x1: {spread_ms(cuda_ms(run))}; launches {launches}; "
                       f"local probe of {sizes} keys (caps unclamped, as in JAX)")
    one_ms = cuda_ms(lambda: bulk_count([table], probe_d))
    if torch.distributed.is_initialized():
        raise AssertionError("a one-rank mesh left its process group behind")
    log(f"phase config 5 on one rank (NCCL, world 1): ok ({time.perf_counter() - t0:.1f} s), "
        f"count {CONFIG5_WANT[0]} checksum {CONFIG5_WANT[1][0]} on every uniform plan, PRPD "
        f"({hot.size} hot keys) {CONFIG5_PRPD_WANT[0]} / {CONFIG5_PRPD_WANT[1][0]}, skew 1.0, "
        f"no overflow, equal to numpy and the one-card bulk_count; every kernel launched held "
        f"against its plain version at the plan's shapes; on [{card}], CUDA events, median "
        f"(min, max) of {REPS}, one-card bulk_count {spread_ms(one_ms)}:")
    for line in lines51:
        log(line)

    # ---- 52. the expansions and the aggregate on one rank ---------------------------
    t0 = time.perf_counter()
    probe2 = gen_probe_table(CONFIG5["n_probe"], 2, CONFIG5["n_build"])
    lo = np.searchsorted(np.sort(keys), probe2, "left")
    hi = np.searchsorted(np.sort(keys), probe2, "right")
    live0 = int((hi[:, 0] - lo[:, 0]).sum())
    want2 = int(((hi[:, 0] - lo[:, 0]) * (hi[:, 1] - lo[:, 1])).sum())
    caps2 = [live0 + 4096, want2 + 4096]  # a cardinality estimate with slack
    vals = np.random.default_rng(52).integers(-(2**40), 2**40, CONFIG4["n_probe"], dtype=np.int64)
    zipf4 = gen_zipf_keys(CONFIG4["n_probe"], CONFIG4["domain"], CONFIG4["alpha"])
    with pd.make_join_mesh(1, "cuda") as mesh:
        part = pd.partition_tables(keys, payloads, 1, "sorted", mesh)
        run_e = lambda: pd.dist_bulk_expand(mesh, part, probe_d[:, 0])  # noqa: E731
        res_e, launches_e, calls = counted_calls(run_e)
        trip = res_e.triples()
        by_key = dict(zip(keys.tolist(), payloads.tolist()))
        sample = trip[np.random.default_rng(52).choice(trip.shape[0], 4096, replace=False)]
        if (int(res_e.total), trip.shape[0], int(trip[:, 2].sum())) != (
                CONFIG5_WANT[0], CONFIG5_WANT[0], CONFIG5_WANT[1][0]) or bool(res_e.overflow):
            raise AssertionError(f"dist_bulk_expand: total {int(res_e.total)}, "
                                 f"{trip.shape[0]} triples, Σ payload {int(trip[:, 2].sum())}")
        if not all(probe[r, 0] == k and by_key[k] == p for r, k, p in sample.tolist()):
            raise AssertionError("dist_bulk_expand: a sampled triple differs from numpy's")
        if not all(launches_e[k] for k in ("sort_tiles_multi_i32", "merge_multi_i32",
                                           "compact_i32")):
            raise AssertionError(f"dist_bulk_expand: launches {launches_e}")
        add(launches_e)
        hold_probes(calls, launches_e, same, "config 5 dist_bulk_expand")
        e_ms = cuda_ms(run_e)
        levels = [pd.partition_tables(keys, payloads, 1, "sorted", mesh) for _ in range(2)]
        probe2_d = torch.from_numpy(probe2).cuda()
        run_p = lambda: pd.dist_pipeline_expand(mesh, levels, probe2_d,  # noqa: E731
                                                level_caps=caps2)
        res_p, launches_p, calls = counted_calls(run_p)
        if (int(res_p.total), bool(res_p.overflow)) != (want2, False):
            raise AssertionError(f"dist_pipeline_expand: {int(res_p.total)}, numpy {want2}")
        add(launches_p)
        hold_probes(calls, launches_p, same, "config 5 dist_pipeline_expand")
        p_ms = cuda_ms(run_p)
        zipf4_d, vals_d = torch.from_numpy(zipf4).cuda(), torch.from_numpy(vals).cuda()
        run_a = lambda: dist_aggregate(mesh, zipf4_d, vals_d)  # noqa: E731
        res_a = run_a()
        got_a = collect_groups(res_a)
        want_a = np.stack(groups_numpy(zipf4, vals), axis=1)
        if int(res_a.n_groups) != CONFIG4_WANT["n_groups"] or not np.array_equal(got_a, want_a):
            raise AssertionError(f"dist_aggregate: {int(res_a.n_groups)} groups")
        a_ms = cuda_ms(run_a)
    log(f"phase config 5 expansions and aggregate on one rank: ok "
        f"({time.perf_counter() - t0:.1f} s); dist_bulk_expand {trip.shape[0]} triples, "
        f"Σ payload {int(trip[:, 2].sum())}, 4096 sampled triples equal numpy's, launches "
        f"{launches_e}; dist_pipeline_expand over 2 levels, level_caps {caps2}: total "
        f"{int(res_p.total)} (numpy {want2}), launches {launches_p}; dist_aggregate over "
        f"config 4's {zipf4.size} Zipf keys: {int(res_a.n_groups)} groups equal numpy's; on "
        f"[{card}], CUDA events, median (min, max) of {REPS}: expand {spread_ms(e_ms)}, "
        f"pipeline {spread_ms(p_ms)}, aggregate {spread_ms(a_ms)}")
    del probe2_d, zipf4_d, vals_d, res_e, res_p, res_a

    # ---- 53. 2 and 4 ranks on the one card (gloo) ---------------------------------
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    store = os.path.join(repo_root, "chiprun_out")
    os.makedirs(store, exist_ok=True)
    for P in (2, 4):
        ranks = bootstrap.spawn_ranks(config5_rank, P, args=("cuda",), store_dir=store,
                                      timeout=300)
        res0 = ranks[0]["results"]
        for rank, r in enumerate(ranks):
            if r["results"] != res0:
                raise AssertionError(f"P = {P}: rank {rank} differs: {r['results']}")
        for name, got in res0.items():
            if name == "dryrun":
                continue
            want_plan = CONFIG5_PRPD_WANT if name == "prpd" else CONFIG5_WANT
            skew = CONFIG5_SKEW[P] if name == "flat" else None
            if got[:2] != want_plan or got[3] or (skew is not None and got[2] != skew):
                raise AssertionError(f"P = {P} {name}: {got}; want {want_plan}, skew {skew}")
        if P == 2 and (res0["dryrun"] is None or res0["dryrun"]["flat"] !=
                       res0["dryrun"]["bulk_count"]):
            raise AssertionError(f"dryrun_multichip(2): {res0['dryrun']}")
        for name in res0:
            if name == "dryrun":
                continue
            summed = {k: sum(r["launches"][name][k] for r in ranks) for k in DIST_WRAPPERS}
            needed = (*STATS_SIDE, "murmurhash64_i64") if name != "ring" and name != "bcast" \
                else STATS_SIDE
            if any(not all(r["launches"][name][k] for k in needed) for r in ranks):
                raise AssertionError(f"P = {P} {name}: a rank launched none of a kernel: "
                                     f"{[r['launches'][name] for r in ranks]}")
            add(summed)
        for r in ranks:
            for k, err in r["max_err"].items():
                max_err[k] = max(max_err[k], err)
        held = [sum(len(r["held"][name]) for r in ranks) for name in ranks[0]["held"]]
        # a collective plan ends when its slowest rank does
        ms = {k: max(r["ms"][k] for r in ranks) for k in ranks[0]["ms"]}
        hier = [k for k in ms if k.startswith("hier")][-1]
        shape = tuple(int(x) for x in hier[5:].split("x"))
        model = {"flat": predict(*CONFIG5.values(), topologies=((1, P),), shuffle="flat")[0],
                 "bcast": predict(*CONFIG5.values(), topologies=((1, P),), shuffle="bcast")[0],
                 hier: predict(*CONFIG5.values(), topologies=(shape,), shuffle="hier")[0]}
        measured = sorted(model, key=lambda k: ms[k])
        log(f"phase config 5 on {P} gloo ranks sharing [{card}]: ok, flat, ring, bcast, PRPD "
            f"and hier {[f'{d}x{i}' for d, i in HIER_SHAPES[P]]} give config 5's counts and "
            f"checksums on every rank, flat's skew {res0['flat'][2]!r}"
            + (", dryrun_multichip(2) passed every plan" if P == 2 else "")
            + f"; every launch held against its plain version in its rank ({sum(held)} "
            f"probes); launches summed over the ranks {dict(total)} so far")
        log(f"  times (ranks sharing one card over gloo, CUDA events, best of 3 after a "
            f"warm-up, the slowest rank): " + ", ".join(f"{k} {ms[k]:.3f} ms" for k in ms)
            + f"; measured order {measured}; the model's t_total at this P on H100 links "
            + ", ".join(f"{k} {model[k].t_total * 1e3:.4f} ms" for k in model)
            + f", its ranking at 1x{P} {ranking(*CONFIG5.values(), 1, P)} (a record, not a "
            f"pass condition: the ranks share one card and the host's gloo)")
    log(f"phase config 5 on 2 and 4 ranks: ok ({time.perf_counter() - t0:.1f} s)")

    # ---- 54. the CLI as users run it ----------------------------------------------
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=repo_root)

    def cli(*args, extra_env=None):
        return subprocess.Popen([sys.executable, "-m", "ccve_tpu_torch.cli", *args],
                                cwd=repo_root, env=dict(env, **(extra_env or {})),
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(proc, what):
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{what}: rc {proc.returncode}\n{err[-4000:]}")
        return out

    base = json.loads(result(cli("baseline", "--config", "5"), "cli baseline --config 5")
                      .strip().splitlines()[-1])
    if (base["count"], base["payload_checksums"]) != CONFIG5_WANT or base["overflow"]:
        raise AssertionError(f"cli baseline --config 5: {base}")
    flat1 = json.loads(result(cli("dist", "--shuffle", "flat"), "cli dist --shuffle flat")
                       .strip().splitlines()[-1])
    rendezvous = f"file://{store}/cli-dist-{os.getpid()}"
    pair = [cli("dist", "--shuffle", "bcast", "--backend", "gloo",
                extra_env={"CCVE_COORDINATOR": rendezvous, "CCVE_NUM_PROCESSES": "2",
                           "CCVE_PROCESS_ID": str(rank)}) for rank in (0, 1)]
    bcast2 = [json.loads(result(p, "cli dist --shuffle bcast").strip().splitlines()[-1])
              for p in pair]
    for r in (flat1, *bcast2):
        if (r["count"], r["payload_checksums"]) != CONFIG5_WANT or r["overflow"]:
            raise AssertionError(f"cli dist: {r}")
    if [r["num_processes"] for r in bcast2] != [2, 2] or flat1["cross_checked"] is not True:
        raise AssertionError(f"cli dist: {flat1}, {bcast2}")
    roof = result(cli("roofline", "--dist", "--n-levels", "2"), "cli roofline --dist")
    if "distributed shuffle cost model" not in roof or "x 2 level(s)" not in roof:
        raise AssertionError(f"cli roofline --dist --n-levels 2:\n{roof}")
    log(f"phase cli (config 5): ok ({time.perf_counter() - t0:.1f} s); baseline --config 5 "
        f"{json.dumps(base)}")
    log(f"  cli dist --shuffle flat (one NCCL rank, cross-checked): {json.dumps(flat1)}")
    log(f"  cli dist --shuffle bcast --backend gloo, two processes on the card (CCVE_*): "
        f"{json.dumps(bcast2[0])}")
    log("  cli roofline --dist --n-levels 2:\n" + roof.rstrip())
    return total


def emit_work(n_keep: int, width: int) -> tuple[int, int]:
    """(bytes, integer operations) of the emission of n_keep rows from a
    state W wide: key' and payload read a row (and the row id and the W - 1
    gathered columns when W > 1), W + 2 int64 words written a row; a few
    operations a row."""
    read = 8 + (4 + 8 * (width - 1) if width > 1 else 0)
    return n_keep * (read + 8 * (width + 2)), 4 * n_keep


def old_emission(planes, total, kmin: int, probe: torch.Tensor, src: torch.Tensor):
    """The one-level emission at F = 1 as `bulk_materialize` and
    `sorted_expand` ran it before the emission kernel (the span
    `expand.emit`, twice): `_fit` at full capacity, then the host's read
    of the total, the slices, the gathers of `src` and the empty
    `appended`, the stack and the `cat`s."""
    rows, ck, cp, total = sm._fit(planes[0], (planes[1].to(torch.int64) - 1) + kmin,
                                  planes[2].to(torch.int64), total, probe.shape[0])
    n_keep = int(total)
    row_of = rows[:n_keep].to(torch.int64)
    ck, cp = ck[:n_keep], cp[:n_keep]
    appended = torch.zeros((0, probe.shape[0]), dtype=torch.int64, device=probe.device)
    src, appended = src[row_of], appended[:, row_of]
    appended = torch.cat([appended, torch.stack([ck, cp])])
    return torch.cat([probe[src], appended.T], dim=1)


def emit_phase(card: str, same, table, col: torch.Tensor, want: tuple) -> dict:
    """Phase 55, runnable alone with config 1's table and int32 probe column
    on the card, `want` its numpy (count, checksum), and any exact `same`:
    #19 counted in `bulk_materialize` at the cell's shape and over three
    levels, held against its plain version at each, and timed. Returns
    {"launches", "ms", "work"} for the kernels line."""
    t0 = time.perf_counter()
    emit.emit_rows_i32.launches = 0
    probe = col.to(torch.int64)[:, None].contiguous()
    out = bulk_materialize([table], probe, PayloadMode.FULL)
    torch.cuda.synchronize()
    launches = emit.emit_rows_i32.launches
    got = (out.shape[0], int(out[:, 2].sum()))
    if got != want or launches != 1 or not torch.equal(out[:, 0], out[:, 1]):
        raise AssertionError(f"bulk_materialize config 1: (rows, payload sum) {got}, numpy "
                             f"{want}; {launches} emission launch(es)")
    del out
    kmin = table.pack32[0]
    planes, total = sm.expand_compacted(table, probe[:, 0])
    n_keep = int(total)
    kernel = lambda: emit.emit_rows_i32(planes, n_keep, kmin, probe, 0, True)  # noqa: E731
    plain = lambda: emit.emit_rows_plain(planes, n_keep, kmin, probe, 0, True)  # noqa: E731
    same("emit_rows_i32", kernel(), plain(), "config 1 (16M rows, W = 1, F = 1)")
    src = torch.arange(probe.shape[0], device=probe.device)
    old = lambda: old_emission(planes, total, kmin, probe, src)  # noqa: E731
    if not torch.equal(old(), kernel()):
        raise AssertionError("the emission kernel and the old torch emission differ")
    torch.cuda.synchronize()
    # three levels: config 3's shape (1M probe rows, 50K build keys a level)
    keys3, pays3 = gen_rhs_table(50_000, 1)
    probe3 = torch.from_numpy(gen_probe_table(1_000_000, 3, 100_000)).cuda()
    table3 = sm.build_sorted(keys3, pays3, device="cuda")
    emit.emit_rows_i32.launches = 0
    out3 = bulk_materialize([table3] * 3, probe3, PayloadMode.FULL)
    torch.cuda.synchronize()
    launches3 = emit.emit_rows_i32.launches
    want3 = oracle_pipeline(probe3.cpu().numpy(), [OracleBuildTable(keys3, pays3)] * 3,
                            PayloadMode.FULL)
    got3 = out3.cpu().numpy()
    if launches3 != 3 or got3.shape != want3.shape or not np.array_equal(
            got3[np.lexsort(got3.T[::-1])], want3[np.lexsort(want3.T[::-1])]):
        raise AssertionError(f"bulk_materialize over three levels: {got3.shape} rows against "
                             f"the oracle's {want3.shape}; {launches3} emission launches")
    state, widths = probe3, []
    for level in range(3):
        p3, t3 = sm.expand_compacted(table3, state[:, level])
        k3 = int(t3)
        nxt = emit.emit_rows_i32(p3, k3, table3.pack32[0], state, level, True)
        same("emit_rows_i32", nxt, emit.emit_rows_plain(p3, k3, table3.pack32[0], state, level,
                                                        True), f"three levels, level {level}")
        widths.append((state.shape[1], k3))
        state = nxt
    torch.cuda.synchronize()
    log(f"phase emission (#19): ok ({time.perf_counter() - t0:.1f} s); config 1 through "
        f"bulk_materialize: {want[0]} rows, payload sum {want[1]} (numpy agrees), {launches} "
        f"launch; three levels (1M probe rows, 50K keys a level): {got3.shape[0]} rows equal to "
        f"the oracle's, {launches3} launches; the kernel equal to its plain version at config 1 "
        f"and at each level (W, rows) {widths}, and to the old torch emission at config 1")
    ms = {}
    for _ in range(2):  # in turns: kernel, plain, old torch emission
        for name, fn in (("kernel", kernel), ("plain", plain), ("old", old)):
            ms.setdefault(name, []).extend(cuda_ms(fn))
    b_ms, b_by = bound(*emit_work(n_keep, 1))
    k_ms = med(ms["kernel"])
    log(f"  emit_rows_i32 at config 1 ({n_keep} rows, W = 1, F = 1) on [{card}], CUDA events, "
        f"medians of {2 * REPS}: kernel {spread_ms(ms['kernel'])}, bound {b_ms:.4f} ms "
        f"({b_by}; {k_ms / b_ms:.2f}x the bound), plain {spread_ms(ms['plain'])}, the old torch "
        f"emission (_fit, int(total), the gathers, the stack and the cats) {spread_ms(ms['old'])}")
    return {"launches": launches + launches3, "ms": (k_ms, med(ms["plain"]), med(ms["old"])),
            "work": emit_work(n_keep, 1)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        raise AssertionError(f"{torch.cuda.device_count()} devices visible, expected 1")

    # ---- 1. device -------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    log(f"phase build: ok ({time.perf_counter() - t0:.1f} s, {_build.LIB_PATH.name})")

    wrappers = {
        "sort_runs_narrowed": bigsort.sort_runs_narrowed,
        "sort_tiles_i32": bigsort.sort_tiles_i32,
        "merge_level_i32": bigsort.merge_level_i32,
        "merge_counts_i32": merge_scan.merge_counts_i32,
    }
    max_err = dict.fromkeys([*wrappers, *NEW_WRAPPERS, *WIDE_WRAPPERS, *HASH_WRAPPERS,
                             "drain_segment", "drain_segment_occ", "chunk_rank",
                             *SLICE_3B_WRAPPERS, "ce_stages_i32", "emit_rows_i32"], 0)

    same = exact(max_err)

    # ---- 3. kernels against plain versions, small ragged shapes ------------
    rng = np.random.default_rng(0)

    def values(n, dom=None):
        if dom is None:
            v = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64)
        else:
            v = rng.integers(0, dom, n)
        return torch.from_numpy(v.astype(np.int32)).cuda()

    for tile_log in (bigsort.TILE_LOG, 11, 4, 1):
        for nt in (1, 3, 13):
            for dom in (None, 7):
                x = values(nt << tile_log, dom)
                same("sort_tiles_i32", bigsort.sort_tiles_i32(x, tile_log),
                     bigsort.sort_tiles_plain(x, tile_log),
                     f"tile_log={tile_log} nt={nt}")
    for n in (1, 5, 2049, 10_000, 13 << 11):
        for dom in (None, 3):
            runs = values(n, dom)  # runs of one value are sorted
            for run_log in range(0, 16):
                same("merge_level_i32", bigsort.merge_level_i32(runs, run_log),
                     bigsort.merge_level_plain(runs, run_log),
                     f"n={n} run_log={run_log}")
                runs = bigsort.merge_level_plain(runs, run_log)
    for nt in (1, 2, 3, 5, 13):
        x = values(nt << bigsort.TILE_LOG)
        for run_log in range(bigsort.TILE_LOG, bigsort.TILE_LOG + 5):
            same("merge_level_i32", bigsort.sort_runs(x, run_log),
                 bigsort.sort_runs_plain(x, run_log),
                 f"sort_runs nt={nt} run_log={run_log}")

    def counts_edge(name, dtype, kind):
        """#3 or #14 on a case of `bench.edge_cases.merge_counts_case`."""
        runs_e, run_len_e, n_e, b_e = (
            torch.from_numpy(a).cuda() if isinstance(a, np.ndarray) else a
            for a in edge_cases.merge_counts_case(rng, dtype, kind))
        same(name, merge_scan.MERGE_COUNTS[runs_e.dtype](runs_e, run_len_e, n_e, b_e, b_e.numel()),
             merge_scan.merge_counts_plain(runs_e, run_len_e, n_e, b_e, b_e.numel()), kind)

    def counts_case(n, m, run_log, dom, builds, what):
        probes = rng.integers(0, dom + 8, n).astype(np.int64) * 2  # some above every build
        probes[: min(n, 5)] = 0  # clamped-low probes
        tile = 1 << 11
        n_pad = n + (-n) % tile
        p = torch.from_numpy(
            np.concatenate([probes, np.full(n_pad - n, I32_MAX)]).astype(np.int32)
        ).cuda()
        runs = bigsort.sort_runs_plain(p, run_log, 11)
        b32 = torch.from_numpy((np.sort(builds) * 2 + 3).astype(np.int32)).cuda()
        same("merge_counts_i32",
             merge_scan.merge_counts_i32(runs, 1 << run_log, n, b32, m),
             merge_scan.merge_counts_plain(runs, 1 << run_log, n, b32, m), what)
        return runs, 1 << run_log, n, b32, m

    counts_case(100_000, 30_000, 11, 40_000, rng.choice(40_000, 30_000, replace=False), "many runs")
    counts_case(40_000, 70_000, 13, 50_000, rng.integers(0, 50_000, 70_000), "dup builds, m > n")
    counts_case(33_333, 100, 14, 1000, rng.integers(0, 1000, 100), "ragged n")
    clustered = counts_case(300_000, 5_000, 16, 200_000, rng.integers(40_000, 40_500, 5_000),
                            "clustered builds")
    uniform = counts_case(300_000, 5_000, 16, 200_000, rng.choice(200_000, 5_000, replace=False),
                          "uniform builds")
    counts_case(0, 10, 11, 50, np.arange(10), "no probes")
    counts_case(4096, 1, 11, 3, np.array([1]), "one build")
    for kind in SKEWED_COUNTS:
        counts_edge("merge_counts_i32", np.int32, kind)
    torch.cuda.synchronize()
    skew_ms = {what: med(cuda_ms(lambda a=a: merge_scan.merge_counts_i32(*a)))
               for what, a in (("clustered", clustered), ("uniform", uniform))}
    log(f"merge_counts_i32 at 300,000 probes in 5 runs and 5,000 builds on [{card}], CUDA "
        f"events, median of {REPS}: builds clustered on 500 keys {skew_ms['clustered']:.4f} ms, "
        f"spread over 200,000 keys {skew_ms['uniform']:.4f} ms")
    log(f"phase kernels (small shapes): ok, max |kernel - plain| {max_err}")

    # ---- 4. the config-1 slice through bulk_count --------------------------
    t0 = time.perf_counter()
    keys, payloads = gen_rhs_table(N_BUILD, 1)
    probe = gen_probe_table(N_PROBE, 1, N_BUILD)
    order = np.argsort(keys, kind="stable")
    prefix = np.concatenate([[0], np.cumsum(payloads[order])])
    lo = np.searchsorted(keys[order], probe[:, 0], side="left")
    hi = np.searchsorted(keys[order], probe[:, 0], side="right")
    want_count = int((hi - lo).sum())
    want_checksum = int((prefix[hi] - prefix[lo]).sum())
    log(f"phase data: ok ({time.perf_counter() - t0:.1f} s), numpy count "
        f"{want_count}, checksum {want_checksum}")

    table = sm.build_sorted(keys, payloads, device="cuda")
    probe_dev = torch.from_numpy(probe.astype(np.int32)).cuda()
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    zero_counters(PARTITION)
    res = bulk_count([table], probe_dev)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    parts1 = check_partitions(launches["merge_level_i32"], "config 1 bulk_count")
    count, checksum = int(res.count), int(res.payload_checksums[0])
    if (count, checksum) != (want_count, want_checksum):
        raise AssertionError(f"bulk_count gave ({count}, {checksum}), numpy "
                             f"({want_count}, {want_checksum})")
    check_launched(launches, "bulk_count")

    col = probe_dev[:, 0].contiguous()
    p32, b32 = sm.pack32_streams(table, col)
    n, m = p32.numel(), b32.numel()
    n_pad, run_log = sm.count_side_plan(n, m, bigsort.TILE_LOG)
    padded = torch.cat([p32, p32.new_full((n_pad - n,), I32_MAX)])

    def plain_totals():
        runs = bigsort.sort_runs_plain(padded, run_log)
        bc = merge_scan.merge_counts_plain(runs, 1 << run_log, n, b32, m).long()
        return bc.sum(), (bc * table.payloads).sum()

    pc, ps = plain_totals()
    if (int(pc), int(ps)) != (want_count, want_checksum):
        raise AssertionError(f"plain path gave ({int(pc)}, {int(ps)})")
    n_runs = -(-n_pad // (1 << run_log))
    log(f"phase slice: ok, bulk_count count {count} checksum {checksum} "
        f"(numpy and plain path agree); launches {launches}, partitions {parts1}; "
        f"{n_runs} runs of 2^{run_log}, n_pad {n_pad}")

    # ---- 5. kernels at the slice's shapes, and times -----------------------
    tile_log = bigsort.TILE_LOG
    levels = list(range(tile_log, tile_log + launches["merge_level_i32"]))
    # #1's narrowing load, the main path's tile sort, on the int32 column
    # and on the int64 column the benchmark hands over: the tile sort
    # alone (run_log = tile_log) and the whole ladder, against the plain twin
    bounds = sm._narrow_bounds(table)
    col64 = col.to(torch.int64)
    for c in (col, col64):
        for rl in (tile_log, run_log):
            same("sort_runs_narrowed", bigsort.sort_runs_narrowed(c, *bounds, n_pad, rl),
                 bigsort.sort_runs_narrowed_plain(c, *bounds, n_pad, rl),
                 f"config 1 {c.dtype} run_log={rl}")
    tiles = bigsort.sort_tiles_i32(padded, tile_log)
    same("sort_tiles_i32", tiles, bigsort.sort_tiles_plain(padded, tile_log), "config 1")
    level_in = [tiles]
    for lv in levels:
        out = bigsort.merge_level_i32(level_in[-1], lv)
        same("merge_level_i32", out,
             bigsort.merge_level_plain(level_in[-1], lv), f"config 1 run_log={lv}")
        level_in.append(out)
    runs = level_in.pop()
    same("merge_counts_i32",
         merge_scan.merge_counts_i32(runs, 1 << run_log, n, b32, m),
         merge_scan.merge_counts_plain(runs, 1 << run_log, n, b32, m), "config 1")
    torch.cuda.synchronize()
    log(f"phase kernels (config-1 shapes): ok, max |kernel - plain| {max_err}")

    def level_ms(fn, level_in=level_in, levels=levels):
        """ms of one call's levels back to back in one CUDA-event window, as
        the ladder enqueues them: no level waits on the host."""
        return med(cuda_ms(lambda: [fn(x, lv) for x, lv in zip(level_in, levels)]))

    narrowed_ms = {
        (str(c.dtype), rl): (
            med(cuda_ms(lambda c=c, rl=rl: bigsort.sort_runs_narrowed(c, *bounds, n_pad, rl))),
            med(cuda_ms(lambda c=c, rl=rl: bigsort.sort_runs_narrowed_plain(
                c, *bounds, n_pad, rl))),
        )
        for c in (col, col64) for rl in (tile_log, run_log)
    }
    kernel_ms = {
        # the narrowing tile sort alone, on the int64 column
        "sort_runs_narrowed": narrowed_ms[(str(torch.int64), tile_log)],
        "sort_tiles_i32": (
            med(cuda_ms(lambda: bigsort.sort_tiles_i32(padded, tile_log))),
            med(cuda_ms(lambda: bigsort.sort_tiles_plain(padded, tile_log))),
        ),
        "merge_level_i32": (
            level_ms(bigsort.merge_level_i32), level_ms(bigsort.merge_level_plain)
        ),
        "merge_counts_i32": (
            med(cuda_ms(lambda: merge_scan.merge_counts_i32(runs, 1 << run_log, n, b32, m))),
            med(cuda_ms(lambda: merge_scan.merge_counts_plain(runs, 1 << run_log, n, b32, m))),
            med(cuda_ms(counts_library(runs, 1 << run_log, b32))),
        ),
    }
    # (bytes, operations) of each kernel's work in one bulk_count: keys read
    # and written once per launch; tile_log compares per key in the tile
    # sort, one per key and level in the merges; in the counts, the real
    # probes and b read once and bc written once, a compare a probe and two
    # a build row and run (its two bounds)
    work = {
        "sort_runs_narrowed": (8 * n + 4 * n_pad, n_pad * tile_log),
        "sort_tiles_i32": (8 * n_pad, n_pad * tile_log),
        "merge_level_i32": (8 * n_pad * len(levels), n_pad * len(levels)),
        "merge_counts_i32": (4 * (n + 2 * m), n + 2 * m * n_runs),
    }
    # config 1's count-side shape, for phase 40's model
    plan1 = roofline.CountSidePlan(n_pad, tile_log, run_log, len(levels), n_runs)
    # end to end, in turns: plain, kernel, kernel, plain
    e2e = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = plain_totals if which == "plain" else (lambda: bulk_count([table], probe_dev))
        e2e[which] += cuda_ms(fn)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    bulk_count([table], probe_dev)
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    k_ms, p_ms = med(e2e["kernel"]), med(e2e["plain"])
    log(f"times on [{card}], CUDA events, median of {2 * REPS}:")
    log(f"  bulk_count config 1 (1M build x 16M probe), kernel path: {k_ms:.4f} ms "
        f"= {N_PROBE / k_ms / 1e3:.1f}M probe rows/s "
        f"(min {min(e2e['kernel']):.4f}, max {max(e2e['kernel']):.4f}); "
        f"peak extra device memory {peak_mib:.1f} MiB")
    log(f"  all-plain torch path: {p_ms:.4f} ms = {N_PROBE / p_ms / 1e3:.1f}M probe rows/s "
        f"(min {min(e2e['plain']):.4f}, max {max(e2e['plain']):.4f})")
    for name, (kt, pt, *lib) in kernel_ms.items():
        log(f"  {name}: kernel {kt:.4f} ms, plain {pt:.4f} ms"
            + (f", library {lib[0]:.4f} ms" if lib else "")
            + f" ({launches[name]} launch(es) per bulk_count)"
            + (" (the narrowing tile sort alone, int64 column; its plain twin narrows, "
               "pads and sorts the tiles)" if name == "sort_runs_narrowed" else
               " (on the packed, padded probes, off the main path)"
               if name == "sort_tiles_i32" else ""))
    for (dtype, rl), (kt, pt) in narrowed_ms.items():
        log(f"  sort_runs_narrowed, {dtype} column, run_log {rl} "
            f"({rl - tile_log} levels): kernel {kt:.4f} ms, plain {pt:.4f} ms")
    glue = k_ms - narrowed_ms[(str(torch.int32), tile_log)][0] - sum(
        kernel_ms[k][0] for k in ("merge_level_i32", "merge_counts_i32"))
    log(f"  outside the kernels (build stream, sums, allocation): {glue:.4f} ms")

    # ---- 6. the benchmark entry point --------------------------------------
    result = config1_single_join(device="cuda")
    log(f"phase config1_single_join: ok {json.dumps(result)}")

    # ---- 7. slice 2's kernels against plain versions, small ragged shapes --
    t0 = time.perf_counter()

    def planes_of(n, count, dom=None):
        return [values(n, dom) for _ in range(count)]

    for tile_log in (pairsort.TILE_LOG, 11, 4, 1):
        for n_planes in (1, 2, 3):
            for dom in (None, 3):
                keys_s, vals_s = values(3 << tile_log, dom), planes_of(3 << tile_log, n_planes)
                same("sort_tiles_multi_i32",
                     pairsort.sort_tiles_multi_i32(keys_s, vals_s, tile_log),
                     pairsort.sort_tiles_multi_plain(keys_s, vals_s, tile_log),
                     f"tile_log={tile_log} P={n_planes}")
    for n in (1, 5, 2049, 10_000, 3 << 13):
        for n_planes in (1, 3):
            keys_s, vals_s = values(n, 3), planes_of(n, n_planes)  # runs of one value are sorted
            for run_log in range(16):
                same("merge_multi_i32", pairsort.merge_level_multi_i32(keys_s, vals_s, run_log),
                     pairsort.merge_level_multi_plain(keys_s, vals_s, run_log),
                     f"level n={n} P={n_planes} run_log={run_log}")
                keys_s, vals_s = pairsort.merge_level_multi_plain(keys_s, vals_s, run_log)
    for na, nb in ((0, 0), (0, 9), (9, 0), (3000, 2100), (1, 70_000), (100_003, 17)):
        for n_planes in (1, 2, 3):
            ak, bk = values(na, 50).sort().values, values(nb, 50).sort().values
            avs, bvs = planes_of(na, n_planes), planes_of(nb, n_planes)
            same("merge_multi_i32", pairsort.merge_two_multi_i32(ak, avs, bk, bvs),
                 pairsort.merge_two_multi_plain(ak, avs, bk, bvs),
                 f"merge two {na}+{nb} P={n_planes}")
    for n in (1, 8191, 8193, 100_000):
        keys_s, vals_s = values(n), planes_of(n, 2)
        same("sort_tiles_multi_i32", pairsort.sort_multi_i32(keys_s, vals_s),
             pairsort.sort_multi_plain(keys_s, vals_s), f"sort_multi n={n}")
        for run_log in (pairsort.TILE_LOG, pairsort.TILE_LOG + 2):
            same("merge_multi_i32", pairsort.sort_multi_i32_runs(keys_s, vals_s, run_log),
                 pairsort.sort_multi_runs_plain(keys_s, vals_s, run_log),
                 f"sort_multi_runs n={n} run_log={run_log}")

    def stats_case(n, m, dom, pay_lo, pay_hi, what, pad=0):
        builds = np.sort(rng.integers(0, dom, m))
        probes = rng.integers(0, dom + 3, n)  # some above every build
        s_np = np.concatenate([builds * 2, probes * 2 + 1])
        v_np = np.concatenate([rng.integers(pay_lo, pay_hi, m), np.arange(n)])
        order = np.argsort(s_np, kind="stable")
        s_np = np.concatenate([s_np[order], np.full(pad, I32_MAX)])
        v_np = np.concatenate([v_np[order], np.zeros(pad, np.int64)])
        s_d = torch.from_numpy(s_np.astype(np.int32)).cuda()
        v_d = torch.from_numpy(v_np.astype(np.int32)).cuda()
        same("merge_stats_i32", merge_scan.merge_stats_i32(s_d, v_d, n),
             merge_scan.merge_stats_plain(s_d, v_d, n), what)

    stats_case(0, 10, 5, 0, 9, "no probes")
    stats_case(10, 0, 5, 0, 9, "no builds")
    stats_case(50_000, 30_000, 5000, 0, 2**20, "duplicate builds")
    stats_case(70_000, 2000, 300, 2**29, 2**30, "psum past 2^31")
    stats_case(40_000, 15_000, 700, -(2**31), 2**31 - 1, "negative payloads")
    stats_case(300_000, 5, 2, 0, 1, "zero payloads, long runs")
    stats_case(30_000, 9000, 1000, 0, 100, "sort padding at the end", pad=777)
    for n_planes in (1, 2, 3):
        for n in (1, 2047, 2049, 100_003):
            for fill in ("all", "none", "random"):
                planes_c = torch.stack(planes_of(n, n_planes))
                mask_np = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
                           "random": rng.random(n) < 0.4}[fill]
                mask_c = torch.from_numpy(mask_np).cuda()
                same("compact_i32", compact.compact_i32(planes_c, mask_c),
                     compact.compact_plain(planes_c, mask_c), f"C={n_planes} n={n} {fill}")
    torch.cuda.synchronize()
    log(f"phase slice-2 kernels (small shapes): ok ({time.perf_counter() - t0:.1f} s), "
        f"max |kernel - plain| {max_err}")

    path_kernels = functools.partial(stats_path, same)

    def path_ms(inputs, key="i32"):
        """(kernel ms, plain ms) of the sort and merges of one call."""
        tl = pairsort.TILE_LOG
        pk, pv = inputs["tile"]
        two = inputs["two"]
        sort_tiles = getattr(pairsort, f"sort_tiles_multi_{key}")
        merge_level = getattr(pairsort, f"merge_level_multi_{key}")
        merge_two = getattr(pairsort, f"merge_two_multi_{key}")

        def levels(fn):
            return sum(med(cuda_ms(lambda k=k, v=v, r=tl + i: fn(k, v, r)))
                       for i, (k, v) in enumerate(inputs["levels"]))

        return {
            f"sort_tiles_multi_{key}": (
                med(cuda_ms(lambda: sort_tiles(pk, pv, tl))),
                med(cuda_ms(lambda: pairsort.sort_tiles_multi_plain(pk, pv, tl))),
            ),
            f"merge_multi_{key}": (
                levels(merge_level) + med(cuda_ms(lambda: merge_two(*two))),
                levels(pairsort.merge_level_multi_plain)
                + med(cuda_ms(lambda: pairsort.merge_two_multi_plain(*two))),
            ),
        }

    def path_work(inputs):
        """(bytes, operations) of the multi-plane sort and of the merges of
        one call: each key and plane read and written once per launch; a
        tile sort's tile_log compares per key, a merge's one."""
        tl = pairsort.TILE_LOG
        pk, pv = inputs["tile"]
        width = pk.element_size() + 4 * len(pv)
        n_pad, n_levels = pk.numel(), len(inputs["levels"])
        merged = inputs["merged"][0].numel()
        return {
            "sort": (2 * n_pad * width, n_pad * tl),
            "merge": (2 * (n_levels * n_pad + merged) * width, n_levels * n_pad + merged),
        }

    def in_turns(kernel_fn, plain_fn):
        """CUDA-event ms of both, in turns plain, kernel, kernel, plain."""
        e = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            e[which] += cuda_ms(plain_fn if which == "plain" else kernel_fn)
        return e

    def spread(ts):
        return f"{med(ts):.4f} ms (min {min(ts):.4f}, max {max(ts):.4f})"

    def log_split(split, bound_ms):
        """A kernel_split.in_turns reading, kernel first, beside its bound."""
        log(f"  host and device apart on [{card}] (bench.kernel_split, in turns; call: "
            f"medians of {2 * kernel_split.REPS}; chain: {kernel_split.CHAIN} calls; device: "
            f"torch.profiler over {kernel_split.TRACE_CALLS} calls); bound {bound_ms:.6f} ms:")
        for name, r in split.items():
            log(f"    {name}: {kernel_split.summary(r)}")

    def probe_sort_readings(inputs, key, path):
        """#6 and #7 of one stats call at a path's shapes, read apart: each
        kernel's device time a launch (torch.profiler over `sort_multi` and
        the merge of two, `bench.kernel_split.device_split`) beside its
        bound, and the one-call `torch.sort` yardsticks (CUDA events) of the
        packed (key << 32 | index) words, per tile and of the whole stream
        (int64 keys: a stable sort of the keys). Returns the yardsticks'
        ms."""
        p, rows = inputs["probe"]
        pk, pv = inputs["tile"]
        tl = pairsort.TILE_LOG
        sort_multi = getattr(pairsort, f"sort_multi_{key}")
        merge_two = getattr(pairsort, f"merge_two_multi_{key}")
        if key == "i32":
            local = torch.arange(pk.numel(), device=pk.device) & ((1 << tl) - 1)
            tile_words = ((pk.long() << 32) | local).view(-1, 1 << tl)
            words = (p.long() << 32) | rows.long()
            yard = {"per tile": lambda: torch.sort(tile_words, dim=1),
                    "whole stream": lambda: torch.sort(words)}
        else:
            tile_keys = pk.view(-1, 1 << tl)
            yard = {"per tile": lambda: torch.sort(tile_keys, dim=1, stable=True),
                    "whole stream": lambda: torch.sort(p, stable=True)}
        lib_ms = {name: med(cuda_ms(fn)) for name, fn in yard.items()}
        n_levels = len(inputs["levels"])
        d_sort = kernel_split.device_split(lambda: sort_multi(p, [rows]))
        d_two = kernel_split.device_split(lambda: merge_two(*inputs["two"]))

        def us(d, kernel):
            return sum(t for name, t in d["kernels"].items() if kernel in name)

        width = pk.element_size() + 4 * len(pv)
        level_bound = bound(2 * pk.numel() * width, pk.numel())[0]
        two_n = inputs["merged"][0].numel()
        log(f"  #6 and #7 of one call on [{card}], device us a launch (torch.profiler, "
            f"{kernel_split.TRACE_CALLS} calls): tile sort {us(d_sort, 'sort_tiles_kernel'):.2f} "
            f"(bound {bound(*path_work(inputs)['sort'])[0] * 1e3:.2f}); merge level "
            f"{us(d_sort, 'merge_kernel') / max(n_levels, 1):.2f} and its partition "
            f"{us(d_sort, 'partition_kernel') / max(n_levels, 1):.2f} ({n_levels} levels; bound "
            f"{level_bound * 1e3:.2f} a level); merge two {us(d_two, 'merge_kernel'):.2f} and its "
            f"partition {us(d_two, 'partition_kernel'):.2f} (bound "
            f"{bound(2 * two_n * width, two_n)[0] * 1e3:.2f}); sort_multi's device total "
            f"{d_sort['us']:.2f} in {d_sort['events']:g} events")
        log(f"  yardsticks at {path}, one torch.sort call: of a tile's words (#6) "
            f"{lib_ms['per tile']:.4f} ms, of the stream's words (#6 + ladder) "
            f"{lib_ms['whole stream']:.4f} ms, against sort_multi "
            f"{med(cuda_ms(lambda: sort_multi(p, [rows]))):.4f} ms")
        return lib_ms

    # ---- 8. config 3's bulk engine at full size ----------------------------
    t0 = time.perf_counter()
    tables3, probe3, (want3, want3_chk) = config3_data(1_000_000, 50_000, torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"phase config-3 data: ok ({time.perf_counter() - t0:.1f} s), oracle count "
        f"{want3}, checksums {want3_chk}")
    zero_counters(NEW_WRAPPERS)
    zero_counters(PARTITION)
    res3 = bulk_count(tables3, probe3)
    torch.cuda.synchronize()
    launches3 = read_counters(NEW_WRAPPERS)
    parts3 = check_partitions(launches3["merge_multi_i32"], "config 3 bulk_count")
    got3 = (int(res3.count), [int(c) for c in res3.payload_checksums])
    if got3 != (want3, want3_chk):
        raise AssertionError(f"config 3 bulk_count gave {got3}, oracle {(want3, want3_chk)}")
    idle = [k for k in ("sort_tiles_multi_i32", "merge_multi_i32", "merge_stats_i32")
            if launches3[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched by config 3's bulk_count: {idle}")
    cols3 = [probe3[:, level].contiguous() for level in range(len(tables3))]

    def plain3():
        return combine_levels([sm.sorted_match_stats(t, c, route=sm.PLAIN)
                               for t, c in zip(tables3, cols3)])

    res3p = plain3()
    if (int(res3p.count), [int(c) for c in res3p.payload_checksums]) != got3:
        raise AssertionError("config 3: the all-plain path disagrees")
    log(f"phase config 3: ok, bulk_count count {got3[0]} checksums {got3[1]} "
        f"(oracle and plain path agree); launches {launches3}, partitions {parts3}")
    inputs3 = path_kernels(tables3[0], cols3[0], "config 3")
    ms3, mv3 = inputs3["merged"]
    mv3 = mv3[0]
    n3 = cols3[0].numel()
    same("merge_stats_i32", merge_scan.merge_stats_i32(ms3, mv3, n3),
         merge_scan.merge_stats_plain(ms3, mv3, n3), "config 3")
    torch.cuda.synchronize()
    log(f"phase kernels (config-3 shapes): ok, max |kernel - plain| {max_err}")
    ms_cfg3 = path_ms(inputs3)
    ms_cfg3["merge_stats_i32"] = (
        med(cuda_ms(lambda: merge_scan.merge_stats_i32(ms3, mv3, n3))),
        med(cuda_ms(lambda: merge_scan.merge_stats_plain(ms3, mv3, n3))),
    )
    L3 = ms3.numel()
    # the stats scan reads the stream and its plane and writes mult and
    # psum per probe row; a few operations (compare, tag, two adds) per
    # element
    work["merge_stats_i32"] = (8 * L3 + 12 * n3, 4 * L3)
    e3 = in_turns(lambda: bulk_count(tables3, probe3), plain3)
    log(f"times on [{card}], CUDA events, medians (per level: 1M probes, 50K builds):")
    log(f"  bulk_count config 3 (1M x 4 levels), kernel path: {spread(e3['kernel'])} "
        f"= {1e6 / med(e3['kernel']) / 1e3:.1f}M probe rows/s")
    log(f"  all-plain torch path: {spread(e3['plain'])}")
    for name, (kt, pt) in ms_cfg3.items():
        log(f"  {name}: kernel {kt:.4f} ms, plain {pt:.4f} ms per level "
            f"({launches3[name]} launch(es) per bulk_count)")
    probe_sort_readings(inputs3, "i32", "config 3 (1M probes a level)")

    # ---- 9. config 1 materialized at full size (phase 4's data) ------------
    col1 = probe_dev[:, 0].contiguous()
    config1 = (table, col1, (want_count, want_checksum))  # phase 55's
    zero_counters(NEW_WRAPPERS)
    zero_counters(PARTITION)
    tiles, total = sm.sorted_expand_tiled(table, col1)
    torch.cuda.synchronize()
    launches_m = read_counters(NEW_WRAPPERS)
    parts_m = check_partitions(launches_m["merge_multi_i32"], "sorted_expand_tiled")
    psum_m = sum(int(t[2].sum()) for t in tiles)
    if (total, psum_m) != (want_count, want_checksum):
        raise AssertionError(f"sorted_expand_tiled gave ({total}, {psum_m}), numpy "
                             f"({want_count}, {want_checksum})")
    sampled = check_sampled_triples(tiles, probe[:, 0], keys, payloads)
    idle = [k for k in ("sort_tiles_multi_i32", "merge_multi_i32", "compact_i32")
            if launches_m[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched by sorted_expand_tiled: {idle}")
    cap = col1.numel() * max(table.max_mult, 1)
    got_m = sm.sorted_expand(table, col1, cap)
    want_m = sm.sorted_expand(table, col1, cap, route=sm.PLAIN)
    for g, w in zip(got_m, want_m):
        if not torch.equal(g, w):
            raise AssertionError("sorted_expand: the kernel and all-plain routes disagree")
    log(f"phase config-1 materialize: ok, {len(tiles)} tile(s), {total} triples, "
        f"payload sum {psum_m} (numpy agrees), {sampled} sampled triples match the "
        f"generators, all-plain route identical; launches {launches_m}, partitions {parts_m}")
    inputs_m = path_kernels(table, col1, "materialize")
    sm_m, (sv_m,) = inputs_m["merged"]
    same("expand_candidates_i32", candidates_view(merge_scan.expand_candidates_i32(sm_m, sv_m, 1)),
         candidates_view(merge_scan.expand_candidates_plain(sm_m, sv_m, 1)), "materialize")
    planes_m, valid_m, _ = sm.expand_candidates(table, col1)
    same("compact_i32", compact.compact_i32(planes_m, valid_m),
         compact.compact_plain(planes_m, valid_m), "materialize")
    torch.cuda.synchronize()
    log(f"phase kernels (materialize shapes): ok, max |kernel - plain| {max_err}")
    ms_mat = path_ms(inputs_m)
    # the library yardstick: the one call `planes[:, mask]`, without the
    # plain version's zeros and copy
    ms_mat["compact_i32"] = (
        med(cuda_ms(lambda: compact.compact_i32(planes_m, valid_m))),
        med(cuda_ms(lambda: compact.compact_plain(planes_m, valid_m))),
        med(cuda_ms(lambda: planes_m[:, valid_m])),
    )
    ms_mat["expand_candidates_i32"] = (
        med(cuda_ms(lambda: merge_scan.expand_candidates_i32(sm_m, sv_m, 1))),
        med(cuda_ms(lambda: merge_scan.expand_candidates_plain(sm_m, sv_m, 1))),
    )
    work["expand_candidates_i32"] = candidates_work(sm_m.numel(), 1)
    w_m = path_work(inputs_m)
    n_c = planes_m.shape[1]
    work["sort_tiles_multi_i32"] = w_m["sort"]
    work["merge_multi_i32"] = w_m["merge"]
    # the compaction reads C planes and the mask and writes C planes
    work["compact_i32"] = (8 * planes_m.numel() + n_c, n_c * planes_m.shape[0])
    em = in_turns(lambda: sm.sorted_expand_tiled(table, col1),
                  lambda: sm.sorted_expand_tiled(table, col1, route=sm.PLAIN))
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    sm.sorted_expand_tiled(table, col1)
    torch.cuda.synchronize()
    peak_m = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    log(f"times on [{card}], CUDA events, medians:")
    log(f"  sorted_expand_tiled config 1 (1M build x 16M probe, {total} triples), "
        f"kernel path: {spread(em['kernel'])} = "
        f"{total / med(em['kernel']) / 1e3:.1f}M triples/s; peak extra device "
        f"memory {peak_m:.1f} MiB")
    log(f"  all-plain torch path: {spread(em['plain'])}")
    for name, (kt, pt, *lib) in ms_mat.items():
        lib_s = f", planes[:, mask] {lib[0]:.4f} ms" if lib else ""
        log(f"  {name}: kernel {kt:.4f} ms, plain {pt:.4f} ms{lib_s} "
            f"({launches_m[name]} launch(es) per call)")
    ops_c = [idle_share(lambda fn=fn: fn(sm_m, sv_m, 1))[1] / PROFILED_CALLS
             for fn in (merge_scan.expand_candidates_i32, merge_scan.expand_candidates_plain)]
    log(f"  expand_candidates_i32 at L = {sm_m.numel()}, F = 1: bound "
        f"{bound(*work['expand_candidates_i32'])[0]:.4f} ms; device operations a call: "
        f"kernel {ops_c[0]:.0f}, plain {ops_c[1]:.0f}")
    lib_m = probe_sort_readings(inputs_m, "i32", "materialize (16M probes)")
    ms_mat["sort_tiles_multi_i32"] += (lib_m["per tile"],)

    # ---- 10. duplicate keys: mult > 1 and the F > 1 expand loop ------------
    t0 = time.perf_counter()
    keys_d, pays_d = gen_rhs_table(262_144, 4)
    probe_d = gen_probe_table(4_000_000, 1, 262_144)[:, 0]
    table_d = sm.build_sorted(keys_d, pays_d, device="cuda")
    col_d = torch.from_numpy(probe_d.astype(np.int32)).cuda()
    zero_counters(NEW_WRAPPERS)
    stats_d = sm.sorted_match_stats(table_d, col_d)
    tiles_d, total_d = sm.sorted_expand_tiled(table_d, col_d)
    torch.cuda.synchronize()
    launches_d = read_counters(NEW_WRAPPERS)
    order_d = np.argsort(keys_d, kind="stable")
    sk_d, sp_d = keys_d[order_d], pays_d[order_d]
    lo_d = np.searchsorted(sk_d, probe_d, side="left")
    hi_d = np.searchsorted(sk_d, probe_d, side="right")
    mult_d = hi_d - lo_d
    prefix_d = np.concatenate([[0], np.cumsum(sp_d)])
    if not (np.array_equal(stats_d.mult.cpu().numpy(), mult_d)
            and np.array_equal(stats_d.psum.cpu().numpy(), prefix_d[hi_d] - prefix_d[lo_d])):
        raise AssertionError("duplicate keys: per-probe stats disagree with numpy")
    if total_d != int(mult_d.sum()) or int(mult_d.max()) != 4:
        raise AssertionError(f"duplicate keys: total {total_d}, numpy {int(mult_d.sum())}")
    got_t = [torch.cat([t[i][t[0] >= 0] for t in tiles_d]).cpu().numpy() for i in range(3)]
    # the oracle's FULL-mode rows of (key, row id) probes: (key, row, key, payload)
    want_rows = oracle_join(np.stack([probe_d, np.arange(probe_d.size)], axis=1), 0,
                            OracleBuildTable(keys_d, pays_d), PayloadMode.FULL)
    want_t = [want_rows[:, 1], want_rows[:, 2], want_rows[:, 3]]

    def by_row_payload(cols):
        order = np.lexsort((cols[2], cols[0]))
        return [c[order] for c in cols]

    if not all(np.array_equal(g, w) for g, w in
               zip(by_row_payload(got_t), by_row_payload(want_t))):
        raise AssertionError("duplicate keys: the triple multiset disagrees with numpy")
    idle = [k for k, v in launches_d.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels not launched by the duplicate-key phase: {idle}")
    log(f"phase duplicate keys: ok ({time.perf_counter() - t0:.1f} s), 262144 build rows "
        f"(4 per key) x 4M probes: stats and {total_d} triples match numpy; "
        f"launches {launches_d}")
    s_d, v_d = sm.merged_stream(table_d, col_d[: (1 << 20) - 262_144])
    fan_d = table_d.max_mult
    same("expand_candidates_i32",
         candidates_view(merge_scan.expand_candidates_i32(s_d, v_d, fan_d)),
         candidates_view(merge_scan.expand_candidates_plain(s_d, v_d, fan_d)), "duplicate keys")
    zero_counters(NEW_WRAPPERS)
    cand_d = [med(cuda_ms(lambda: merge_scan.expand_candidates_i32(s_d, v_d, fan_d))),
              med(cuda_ms(lambda: merge_scan.expand_candidates_plain(s_d, v_d, fan_d)))]
    calls_d = REPS + 1
    log(f"  expand_candidates_i32 at F = {fan_d}, L = {s_d.numel()}: kernel {cand_d[0]:.4f} ms "
        f"({read_counters(NEW_WRAPPERS)['expand_candidates_i32'] / calls_d:.0f} launch(es) a "
        f"call), plain {cand_d[1]:.4f} ms, bound "
        f"{bound(*candidates_work(s_d.numel(), fan_d))[0]:.4f} ms")

    # ---- 11. the benchmark entry points ------------------------------------
    # (config3_four_way also runs the sorted-chunk executor, phase 24's; its
    # cursor entries are phase 42's)
    result = config3_four_way(table_kind=None, device="cuda")
    log(f"phase config3_four_way: ok {json.dumps(result)}")
    result = config1_materialize(device="cuda")
    log(f"phase config1_materialize: ok {json.dumps(result)}")

    # ---- 12. slice 3's int64 kernels against plain versions, small shapes -
    t0 = time.perf_counter()

    def wide_values(n, dom=None):
        """int64 keys: half near ±2^62, some at the int64 extremes, the
        rest over the range; or uniform in [0, dom)."""
        if dom is not None:
            return torch.from_numpy(rng.integers(0, dom, n).astype(np.int64)).cuda()
        v = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
        near = rng.random(n) < 0.5
        k = int(near.sum())
        v[near] = rng.integers(2**62 - 64, 2**62 + 64, k) * rng.choice([-1, 1], k)
        v[rng.random(n) < 0.02] = I64_MAX
        v[rng.random(n) < 0.02] = -(2**63)
        return torch.from_numpy(v).cuda()

    for tile_log_w in (bigsort.TILE_LOG, 11, 4, 1):
        for nt in (1, 3, 13):
            for dom in (None, 7):
                x = wide_values(nt << tile_log_w, dom)
                same("sort_tiles_i64", bigsort.sort_tiles_i64(x, tile_log_w),
                     bigsort.sort_tiles_plain(x, tile_log_w), f"tile_log={tile_log_w} nt={nt}")
    for n_w in (1, 5, 2049, 10_000, 13 << 11):
        for dom in (None, 3):
            runs_w = wide_values(n_w, dom)  # runs of one value are sorted
            for run_log_w in range(16):
                same("merge_level_i64", bigsort.merge_level_i64(runs_w, run_log_w),
                     bigsort.merge_level_plain(runs_w, run_log_w), f"n={n_w} run_log={run_log_w}")
                runs_w = bigsort.merge_level_plain(runs_w, run_log_w)
    for nt in (1, 2, 3, 5, 13):
        x = wide_values(nt << bigsort.TILE_LOG)
        for run_log_w in range(bigsort.TILE_LOG, bigsort.TILE_LOG + 5):
            same("merge_level_i64", bigsort.sort_runs(x, run_log_w),
                 bigsort.sort_runs_plain(x, run_log_w), f"sort_runs nt={nt} run_log={run_log_w}")

    def counts64_case(n_c, m_c, run_log_c, dom, builds, what):
        base = 2**61 - 4 * dom  # packed keys near 2^62
        probes = (base + rng.integers(0, dom + 8, n_c)) * 2
        probes[: min(n_c, 5)] = 0  # clamped-low probes
        n_pad_c = n_c + (-n_c) % (1 << 11)
        p = torch.from_numpy(np.concatenate([probes, np.full(n_pad_c - n_c, I64_MAX)])).cuda()
        runs_c = bigsort.sort_runs_plain(p, run_log_c, 11)
        b = torch.from_numpy((base + np.sort(builds)) * 2 + 1).cuda()
        same("merge_counts_i64", merge_scan.merge_counts_i64(runs_c, 1 << run_log_c, n_c, b, m_c),
             merge_scan.merge_counts_plain(runs_c, 1 << run_log_c, n_c, b, m_c), what)

    counts64_case(100_000, 30_000, 11, 40_000, rng.choice(40_000, 30_000, replace=False), "many runs")
    counts64_case(40_000, 70_000, 13, 50_000, rng.integers(0, 50_000, 70_000), "dup builds, m > n")
    counts64_case(33_333, 100, 14, 1000, rng.integers(0, 1000, 100), "ragged n")
    counts64_case(0, 10, 11, 50, np.arange(10), "no probes")
    counts64_case(4096, 1, 11, 3, np.array([1]), "one build")
    for kind in SKEWED_COUNTS:
        counts_edge("merge_counts_i64", np.int64, kind)

    for tile_log_w in (pairsort.TILE_LOG, 11, 4, 1):
        for n_planes in (1, 2, 3):
            for dom in (None, 3):
                keys_s, vals_s = wide_values(3 << tile_log_w, dom), planes_of(3 << tile_log_w, n_planes)
                same("sort_tiles_multi_i64",
                     pairsort.sort_tiles_multi_i64(keys_s, vals_s, tile_log_w),
                     pairsort.sort_tiles_multi_plain(keys_s, vals_s, tile_log_w),
                     f"tile_log={tile_log_w} P={n_planes}")
    for n_w in (1, 5, 2049, 10_000, 3 << 13):
        for n_planes in (1, 3):
            keys_s, vals_s = wide_values(n_w, 3), planes_of(n_w, n_planes)
            for run_log_w in range(16):
                same("merge_multi_i64", pairsort.merge_level_multi_i64(keys_s, vals_s, run_log_w),
                     pairsort.merge_level_multi_plain(keys_s, vals_s, run_log_w),
                     f"level n={n_w} P={n_planes} run_log={run_log_w}")
                keys_s, vals_s = pairsort.merge_level_multi_plain(keys_s, vals_s, run_log_w)
    for na, nb in ((0, 0), (0, 9), (9, 0), (3000, 2100), (1, 70_000), (100_003, 17)):
        for n_planes in (1, 2, 3):
            ak, bk = wide_values(na).sort().values, wide_values(nb).sort().values
            avs, bvs = planes_of(na, n_planes), planes_of(nb, n_planes)
            same("merge_multi_i64", pairsort.merge_two_multi_i64(ak, avs, bk, bvs),
                 pairsort.merge_two_multi_plain(ak, avs, bk, bvs), f"merge two {na}+{nb} P={n_planes}")
    for n_w in (1, 8191, 8193, 100_000):
        keys_s, vals_s = wide_values(n_w), planes_of(n_w, 2)
        same("sort_tiles_multi_i64", pairsort.sort_multi_i64(keys_s, vals_s),
             pairsort.sort_multi_plain(keys_s, vals_s), f"sort_multi n={n_w}")

    def stats64_case(n_s, m_s, dom, pay_lo, pay_hi, what, pad=0):
        base = 2**61  # key' near 2^61: the packed stream near 2^62
        builds = np.sort(rng.integers(0, dom, m_s))
        probes = rng.integers(0, dom + 3, n_s)
        s_np = np.concatenate([(base + builds) * 2, (base + probes) * 2 + 1])
        v_np = np.concatenate([rng.integers(pay_lo, pay_hi, m_s), np.arange(n_s)])
        order = np.argsort(s_np, kind="stable")
        s_np = np.concatenate([s_np[order], np.full(pad, I64_MAX)])
        v_np = np.concatenate([v_np[order], np.zeros(pad, np.int64)])
        s_d = torch.from_numpy(s_np).cuda()
        v_d = torch.from_numpy(v_np.astype(np.int32)).cuda()
        same("merge_stats_i64", merge_scan.merge_stats_i64(s_d, v_d, n_s),
             merge_scan.merge_stats_plain(s_d, v_d, n_s), what)

    stats64_case(0, 10, 5, 0, 9, "no probes")
    stats64_case(10, 0, 5, 0, 9, "no builds")
    stats64_case(50_000, 30_000, 5000, 0, 2**20, "duplicate builds")
    stats64_case(70_000, 2000, 300, 2**29, 2**30, "psum past 2^31")
    stats64_case(40_000, 15_000, 700, -(2**31), 2**31 - 1, "negative payloads")
    stats64_case(300_000, 5, 2, 0, 1, "zero payloads, long runs")
    stats64_case(30_000, 9000, 1000, 0, 100, "sort padding at the end", pad=777)
    torch.cuda.synchronize()
    log(f"phase slice-3 kernels (small shapes): ok ({time.perf_counter() - t0:.1f} s), "
        f"max |kernel - plain| {max_err}")

    # ---- 13. config1_wide at full size: the int64 count side --------------
    t0 = time.perf_counter()
    keys_w, pays_w, probe_w = config1_wide_host(N_BUILD, N_PROBE_WIDE, 40)
    want_w = numpy_totals(keys_w, pays_w, probe_w)
    sk_w = np.sort(keys_w)
    lo_w = np.searchsorted(sk_w, probe_w, side="left")
    hi_w = np.searchsorted(sk_w, probe_w, side="right")
    table_w = sm.build_sorted(keys_w, pays_w)
    if table_w.pack32 is not None or not table_w.span62:
        raise AssertionError("config1_wide's table is not a wide one")
    col_w = torch.from_numpy(probe_w).cuda()
    torch.cuda.synchronize()
    log(f"phase config1_wide data: ok ({time.perf_counter() - t0:.1f} s), numpy count "
        f"{want_w[0]}, checksum {want_w[1]}")
    zero_counters(WIDE_WRAPPERS)
    zero_counters(PARTITION)
    res_w = bulk_count([table_w], col_w.view(-1, 1))
    torch.cuda.synchronize()
    launches_w = read_counters(WIDE_WRAPPERS)
    parts_w = check_partitions(launches_w["merge_level_i64"] + launches_w["merge_multi_i64"],
                               "config1_wide bulk_count")
    got_w = (int(res_w.count), int(res_w.payload_checksums[0]))
    if got_w != want_w:
        raise AssertionError(f"config1_wide bulk_count gave {got_w}, numpy {want_w}")
    idle = [k for k in WIDE_COUNT if launches_w[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched by config1_wide's bulk_count: {idle}")
    if launches_w["sort_tiles_i64"]:
        raise AssertionError("config1_wide's bulk_count launched the key-only sort_tiles_i64")
    tot_w = sm.sorted_match_totals(table_w, col_w)
    if (int(tot_w[0]), int(tot_w[1])) != want_w:
        raise AssertionError(f"sorted_match_totals gave {tot_w}, numpy {want_w}")
    p64, b64 = sm.pack64_streams(table_w, col_w)
    n_w, m_w = p64.numel(), b64.numel()
    n_pad_w, run_log_w = sm.count_side_plan(n_w, m_w, bigsort.TILE_LOG)
    padded_w = torch.cat([p64, p64.new_full((n_pad_w - n_w,), I64_MAX)])

    def plain_totals_w():
        runs_p = bigsort.sort_runs_plain(padded_w, run_log_w)
        bc = merge_scan.merge_counts_plain(runs_p, 1 << run_log_w, n_w, b64, m_w).long()
        return bc.sum(), (bc * table_w.payloads).sum()

    pc_w, ps_w = plain_totals_w()
    if (int(pc_w), int(ps_w)) != want_w:
        raise AssertionError(f"config1_wide plain path gave ({int(pc_w)}, {int(ps_w)})")
    n_runs_w = -(-n_pad_w // (1 << run_log_w))
    log(f"phase config1_wide: ok, bulk_count and sorted_match_totals count {got_w[0]} "
        f"checksum {got_w[1]} (numpy and plain path agree); launches "
        f"{ {k: launches_w[k] for k in WIDE_COUNT} }, partitions {parts_w}; {n_runs_w} runs "
        f"of 2^{run_log_w}, "
        f"n_pad {n_pad_w}")
    levels_w = list(range(bigsort.TILE_LOG, bigsort.TILE_LOG + launches_w["merge_level_i64"]))
    # #13's narrowing load, the main path's tile sort, on the int64 column
    # the benchmark hands over and on a strided view of it: the tile sort
    # alone (run_log = tile_log) and the whole ladder, against the plain
    # twin and the composition it replaces (`_probe_key64`, `_padded`,
    # `sort_runs`)
    bounds_w = sm._wide_bounds(table_w)
    strided_w = torch.stack([col_w.flip(0), col_w], 1)[:, 1]
    for rl in (bigsort.TILE_LOG, run_log_w):
        got_n = bigsort.sort_runs_narrowed_i64(col_w, *bounds_w, n_pad_w, rl)
        same("sort_runs_narrowed_i64", got_n, bigsort.sort_runs_narrowed_plain(
            col_w, *bounds_w, n_pad_w, rl, dtype=torch.int64), f"config1_wide run_log={rl}")
        same("sort_runs_narrowed_i64", got_n, bigsort.sort_runs(padded_w, rl),
             f"config1_wide run_log={rl}, the composition")
        same("sort_runs_narrowed_i64",
             bigsort.sort_runs_narrowed_i64(strided_w, *bounds_w, n_pad_w, rl), got_n,
             f"config1_wide run_log={rl}, stride 2")
    tiles_w = bigsort.sort_tiles_i64(padded_w)
    same("sort_tiles_i64", tiles_w, bigsort.sort_tiles_plain(padded_w, bigsort.TILE_LOG), "config1_wide")
    level_in_w = [tiles_w]
    for lv in levels_w:
        out = bigsort.merge_level_i64(level_in_w[-1], lv)
        same("merge_level_i64", out, bigsort.merge_level_plain(level_in_w[-1], lv),
             f"config1_wide run_log={lv}")
        level_in_w.append(out)
    runs_w = level_in_w.pop()
    same("merge_counts_i64", merge_scan.merge_counts_i64(runs_w, 1 << run_log_w, n_w, b64, m_w),
         merge_scan.merge_counts_plain(runs_w, 1 << run_log_w, n_w, b64, m_w), "config1_wide")
    torch.cuda.synchronize()
    log(f"phase kernels (config1_wide shapes): ok, max |kernel - plain| {max_err}")
    narrowed_w = {
        (what, rl): (
            med(cuda_ms(lambda c=c, rl=rl: bigsort.sort_runs_narrowed_i64(
                c, *bounds_w, n_pad_w, rl))),
            med(cuda_ms(lambda c=c, rl=rl: bigsort.sort_runs_narrowed_plain(
                c, *bounds_w, n_pad_w, rl, dtype=torch.int64))),
        )
        for what, c in (("stride 1", col_w), ("stride 2", strided_w))
        for rl in (bigsort.TILE_LOG, run_log_w)
    }
    for name, times in {
        # the narrowing tile sort alone, on the int64 column
        "sort_runs_narrowed_i64": narrowed_w[("stride 1", bigsort.TILE_LOG)],
        "sort_tiles_i64": (
            med(cuda_ms(lambda: bigsort.sort_tiles_i64(padded_w))),
            med(cuda_ms(lambda: bigsort.sort_tiles_plain(padded_w, bigsort.TILE_LOG))),
        ),
        "merge_level_i64": (
            level_ms(bigsort.merge_level_i64, level_in_w, levels_w),
            level_ms(bigsort.merge_level_plain, level_in_w, levels_w),
        ),
        "merge_counts_i64": (
            med(cuda_ms(lambda: merge_scan.merge_counts_i64(runs_w, 1 << run_log_w, n_w, b64, m_w))),
            med(cuda_ms(lambda: merge_scan.merge_counts_plain(runs_w, 1 << run_log_w, n_w, b64, m_w))),
            med(cuda_ms(counts_library(runs_w, 1 << run_log_w, b64))),
        ),
    }.items():
        kernel_ms[name] = times
    work["sort_runs_narrowed_i64"] = (8 * n_w + 8 * n_pad_w, n_pad_w * bigsort.TILE_LOG)
    work["sort_tiles_i64"] = (16 * n_pad_w, n_pad_w * bigsort.TILE_LOG)
    work["merge_level_i64"] = (16 * n_pad_w * len(levels_w), n_pad_w * len(levels_w))
    work["merge_counts_i64"] = (8 * (n_w + m_w) + 4 * m_w, n_w + 2 * m_w * n_runs_w)
    ew = in_turns(lambda: bulk_count([table_w], col_w.view(-1, 1)), plain_totals_w)
    log(f"times on [{card}], CUDA events, medians:")
    log(f"  bulk_count config1_wide (1M build x 2^24 probe, span 2^40), kernel path: "
        f"{spread(ew['kernel'])} = {N_PROBE_WIDE / med(ew['kernel']) / 1e3:.1f}M probe rows/s")
    log(f"  all-plain torch path: {spread(ew['plain'])}")
    for name in (*WIDE_COUNT, "sort_tiles_i64"):
        kt, pt, *lib = kernel_ms[name]
        log(f"  {name}: kernel {kt:.4f} ms, plain {pt:.4f} ms"
            + (f", library {lib[0]:.4f} ms" if lib else "")
            + f" ({launches_w[name]} launch(es) per bulk_count)"
            + (" (the narrowing tile sort alone; its plain twin narrows, pads and sorts the "
               "tiles)" if name == "sort_runs_narrowed_i64" else
               " (on the packed, padded probes, off the main path)"
               if name == "sort_tiles_i64" else ""))
    for (what, rl), (kt, pt) in narrowed_w.items():
        log(f"  sort_runs_narrowed_i64, int64 column {what}, run_log {rl} "
            f"({rl - bigsort.TILE_LOG} levels): kernel {kt:.4f} ms, plain {pt:.4f} ms")

    # ---- 14. the wide stats side on phase 13's data ------------------------
    t0 = time.perf_counter()
    zero_counters(WIDE_WRAPPERS)
    zero_counters(PARTITION)
    stats_w = sm.sorted_match_stats(table_w, col_w)
    torch.cuda.synchronize()
    launches_s = read_counters(WIDE_WRAPPERS)
    parts_s = check_partitions(launches_s["merge_multi_i64"], "wide sorted_match_stats")
    prefix_w = np.concatenate([[0], np.cumsum(pays_w[np.argsort(keys_w, kind="stable")])])
    if not (np.array_equal(stats_w.mult.cpu().numpy(), hi_w - lo_w)
            and np.array_equal(stats_w.psum.cpu().numpy(), prefix_w[hi_w] - prefix_w[lo_w])):
        raise AssertionError("config1_wide stats: mult or psum disagree with numpy")
    idle = [k for k in WIDE_STATS if launches_s[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched by the wide sorted_match_stats: {idle}")
    plain_s = sm.sorted_match_stats(table_w, col_w, route=sm.PLAIN)
    if not (torch.equal(plain_s.mult, stats_w.mult) and torch.equal(plain_s.psum, stats_w.psum)):
        raise AssertionError("config1_wide stats: the all-plain route disagrees")
    rt_w = sm.rank_table(table_w)
    zero_counters(WIDE_WRAPPERS)
    mult_r, start_r = sm.sorted_match_ranks(rt_w, col_w)
    torch.cuda.synchronize()
    launches_r = read_counters(WIDE_WRAPPERS)
    live = (hi_w - lo_w) > 0
    if not (np.array_equal(mult_r.cpu().numpy(), hi_w - lo_w)
            and np.array_equal(start_r.cpu().numpy()[live], lo_w[live])):
        raise AssertionError("config1_wide ranks disagree with numpy")
    half = 1 << 20
    probe2 = np.stack([probe_w[:half], probe_w[half : 2 * half]], axis=1)
    rows2 = oracle_pipeline(probe2, [OracleBuildTable(keys_w, pays_w)] * 2, PayloadMode.FULL)
    want2 = (rows2.shape[0], [int(rows2[:, 3].sum()), int(rows2[:, 5].sum())])
    probe2_d = torch.from_numpy(probe2).cuda()
    zero_counters(WIDE_WRAPPERS)
    res2 = bulk_count([table_w, table_w], probe2_d)
    torch.cuda.synchronize()
    launches_2 = read_counters(WIDE_WRAPPERS)
    got2 = (int(res2.count), [int(c) for c in res2.payload_checksums])
    if got2 != want2:
        raise AssertionError(f"2-level wide bulk_count gave {got2}, oracle {want2}")
    for what, lc in (("ranks", launches_r), ("2-level bulk_count", launches_2)):
        idle = [k for k in WIDE_STATS if lc[k] == 0]
        if idle:
            raise AssertionError(f"kernels not launched by the wide {what}: {idle}")
    res2p = combine_levels([sm.sorted_match_stats(table_w, probe2_d[:, i].contiguous(),
                                                  route=sm.PLAIN) for i in range(2)])
    if (int(res2p.count), [int(c) for c in res2p.payload_checksums]) != got2:
        raise AssertionError("2-level wide bulk_count: the all-plain path disagrees")
    log(f"phase config1_wide stats: ok ({time.perf_counter() - t0:.1f} s), mult and psum of "
        f"{N_PROBE_WIDE} rows, ranks and a 2-level bulk_count (count {got2[0]}, checksums "
        f"{got2[1]}) match numpy and its oracle, all-plain identical; launches "
        f"{ {k: launches_s[k] for k in WIDE_STATS} } (stats, and {parts_s} partitions), "
        f"{ {k: launches_2[k] for k in WIDE_STATS} } (2 levels)")
    inputs_w = path_kernels(table_w, col_w, "config1_wide stats", key="i64")
    ms_w, mv_w = inputs_w["merged"]
    mv_w = mv_w[0]
    same("merge_stats_i64", merge_scan.merge_stats_i64(ms_w, mv_w, n_w),
         merge_scan.merge_stats_plain(ms_w, mv_w, n_w), "config1_wide")
    torch.cuda.synchronize()
    log(f"phase kernels (wide stats shapes): ok, max |kernel - plain| {max_err}")
    kernel_ms.update(path_ms(inputs_w, key="i64"))
    kernel_ms["merge_stats_i64"] = (
        med(cuda_ms(lambda: merge_scan.merge_stats_i64(ms_w, mv_w, n_w))),
        med(cuda_ms(lambda: merge_scan.merge_stats_plain(ms_w, mv_w, n_w))),
    )
    w_w = path_work(inputs_w)
    work["sort_tiles_multi_i64"] = w_w["sort"]
    work["merge_multi_i64"] = w_w["merge"]
    work["merge_stats_i64"] = (12 * ms_w.numel() + 12 * n_w, 4 * ms_w.numel())
    es = in_turns(lambda: sm.sorted_match_stats(table_w, col_w),
                  lambda: sm.sorted_match_stats(table_w, col_w, route=sm.PLAIN))
    log(f"times on [{card}], CUDA events, medians:")
    log(f"  sorted_match_stats config1_wide (1M build x 2^24 probe), kernel path: "
        f"{spread(es['kernel'])}")
    log(f"  all-plain torch path: {spread(es['plain'])}")
    for name in WIDE_STATS:
        kt, pt = kernel_ms[name]
        log(f"  {name}: kernel {kt:.4f} ms, plain {pt:.4f} ms ({launches_s[name]} launch(es) "
            f"per call)")
    lib_w = probe_sort_readings(inputs_w, "i64", "wide stats (2^24 int64 keys)")
    kernel_ms["sort_tiles_multi_i64"] += (lib_w["per tile"],)

    # ---- 15. the int64/int32 ratio on config 1's own data ------------------
    # the same table without `pack32` takes the int64 streams' route
    table_c = {"i32": table, "i64": dataclasses.replace(table, pack32=None)}
    bc32, bc64 = (sm._count_side(table_c[k], col) for k in ("i32", "i64"))
    if not torch.equal(bc32, bc64):
        raise AssertionError("config 1: the int64 count side disagrees with the int32 one")
    er = {"i32": [], "i64": []}
    for which in ("i32", "i64", "i64", "i32"):
        er[which] += cuda_ms(lambda t=table_c[which]: sm._count_side(t, col))
    ratio = med(er["i64"]) / med(er["i32"])
    log(f"phase int64/int32 ratio: ok, config 1's count side (1M x 16M, from the int32 column, "
        f"build stream included) on int32 streams (the narrowing load) {spread(er['i32'])}, "
        f"on int64 streams {spread(er['i64'])}, ratio {ratio:.4f} [{card}]")

    # ---- 16. slice 4's kernel against its plain version, small shapes -----
    t0 = time.perf_counter()
    extremes = np.array([0, 1, -1, -(2**63), I64_MAX, 2**32 - 1, 2**32, -(2**32)], dtype=np.int64)
    for n_h in (0, 1, 7, 8, 1001, (1 << 20) + 3):
        x_np = rng.integers(-(2**63), I64_MAX, n_h, dtype=np.int64, endpoint=True)
        x_np[: min(n_h, extremes.size)] = extremes[:n_h]
        x_h = torch.from_numpy(x_np).cuda()
        same("murmurhash64_i64", murmur.murmurhash64_i64(x_h), murmur.murmurhash64_plain(x_h),
             f"n={n_h}")
    got_np = murmur.murmurhash64_i64(torch.from_numpy(extremes).cuda()).cpu().numpy()
    if not np.array_equal(got_np.view(np.uint64), murmurhash64_np(extremes)):
        raise AssertionError("murmurhash64_i64 disagrees with numpy's uint64 hash")
    torch.cuda.synchronize()
    log(f"phase slice-4 kernel (small shapes): ok ({time.perf_counter() - t0:.1f} s), "
        f"max |kernel - plain| {max_err['murmurhash64_i64']}, numpy's uint64 hash agrees")

    # ---- 17. config 1 through the hash engines at full size ----------------
    col64 = col.to(torch.int64)
    ref = sm.sorted_match_stats(table, col)  # the cross-engine reference, per row
    hash_tables, launches_h = {}, {}
    for engine, builder, drain in (("hash_lp", build_lp, lp_match_stats),
                                   ("hash_csr", build_csr, csr_match_stats)):
        t0 = time.perf_counter()
        tbl = builder(keys, payloads, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        hash_tables[engine] = (tbl, drain)
        zero_counters(HASH_WRAPPERS)
        res_h = bulk_count([tbl], probe_dev)
        torch.cuda.synchronize()
        launches_h[engine] = read_counters(HASH_WRAPPERS)
        got_h = (int(res_h.count), int(res_h.payload_checksums[0]))
        if got_h != (want_count, want_checksum):
            raise AssertionError(f"{engine} bulk_count gave {got_h}, numpy "
                                 f"{(want_count, want_checksum)}")
        plain_h = combine_levels([drain(tbl, col64, route=HASH_PLAIN)])
        if (int(plain_h.count), int(plain_h.payload_checksums[0])) != got_h:
            raise AssertionError(f"{engine}: the all-plain route disagrees")
        stats_h = drain(tbl, col64)
        if not (torch.equal(stats_h.mult, ref.mult) and torch.equal(stats_h.psum, ref.psum)):
            raise AssertionError(f"{engine}: per-row mult or psum differ from sorted_match_stats")
        needed = ("murmurhash64_i64", "compact_i32") if engine == "hash_lp" else ("murmurhash64_i64",)
        idle = [k for k in needed if launches_h[engine][k] == 0]
        if idle:
            raise AssertionError(f"kernels not launched by {engine}'s bulk_count: {idle}")
        # a second hash launch is the LP ladder's full-width recompute
        bound_what = (f"max_run {tbl.max_run} of {tbl.n_slots} slots, ladder "
                      f"{'overflowed' if launches_h[engine]['murmurhash64_i64'] > 1 else 'held'}"
                      if engine == "hash_lp"
                      else f"max_len {tbl.max_len} of {tbl.n_buckets} buckets")
        log(f"phase config 1 {engine}: ok, build {build_s:.3f} s on the host ({bound_what}); "
            f"bulk_count count {got_h[0]} checksum {got_h[1]} (numpy and the all-plain route "
            f"agree; mult and psum of all {col.numel()} rows equal sorted_match_stats'); "
            f"launches {launches_h[engine]}")

    # ---- 18. kernel #12 at config 1's probe keys, timed ---------------------
    same("murmurhash64_i64", murmur.murmurhash64_i64(col64), murmur.murmurhash64_plain(col64),
         "config 1 probes")
    torch.cuda.synchronize()
    kernel_ms["murmurhash64_i64"] = (
        med(cuda_ms(lambda: murmur.murmurhash64_i64(col64))),
        med(cuda_ms(lambda: murmur.murmurhash64_plain(col64))),
    )
    n_h = col64.numel()
    work["murmurhash64_i64"] = (16 * n_h, HASH_OPS_PER_KEY * n_h)
    bound_h = bound(*work["murmurhash64_i64"])
    log(f"phase slice-4 kernel (config-1 shapes): ok, {n_h} keys: kernel "
        f"{kernel_ms['murmurhash64_i64'][0]:.4f} ms, plain {kernel_ms['murmurhash64_i64'][1]:.4f} "
        f"ms, bound {bound_h[0]:.4f} ms ({bound_h[1]}) [{card}]")

    # ---- 19. the hash engines beside sort-merge on config 1 -----------------
    calls = {"sort_merge": lambda: bulk_count([table], probe_dev)}
    for engine, (tbl, drain) in hash_tables.items():
        calls[engine] = lambda tbl=tbl: bulk_count([tbl], probe_dev)
        calls[f"{engine} all-plain"] = (
            lambda tbl=tbl, drain=drain: combine_levels([drain(tbl, col64, route=HASH_PLAIN)]))
    lp_table = hash_tables["hash_lp"][0]
    calls["hash_lp full width (no ladder)"] = (
        lambda: combine_levels([lp_match_stats(lp_table, col64, compact_lanes=False)]))
    e19 = {k: [] for k in calls}
    for order in (list(calls), list(calls)[::-1]):
        for k in order:
            e19[k] += cuda_ms(calls[k])
    log(f"times on [{card}], CUDA events, medians of {2 * REPS}, config 1 (1M build x 16M probe):")
    for k, ts in e19.items():
        share = ""
        if "plain" not in k:
            idle_k, n_events = idle_share(calls[k])
            share = f"; device idle share {idle_k:.4f} ({n_events} device events in {PROFILED_CALLS} calls)"
        log(f"  bulk_count {k}: {spread(ts)} = {N_PROBE / med(ts) / 1e3:.1f}M probe rows/s{share}")

    # ---- 20. bulk_materialize over hash tables, duplicate keys --------------
    t0 = time.perf_counter()
    want_trip = by_row_payload([want_rows[:, 0], want_rows[:, 2], want_rows[:, 3]])
    rows_sm = bulk_materialize([table_d], col_d.view(-1, 1), PayloadMode.FULL)
    got_sm = by_row_payload([rows_sm[:, i].cpu().numpy() for i in range(3)])
    if not all(np.array_equal(g, w) for g, w in zip(got_sm, want_trip)):
        raise AssertionError("bulk_materialize (sort-merge): triples disagree with numpy")
    for engine, builder in (("hash_lp", build_lp), ("hash_csr", build_csr)):
        tbl = builder(keys_d, pays_d, device="cuda")
        zero_counters(HASH_WRAPPERS)
        rows_h = bulk_materialize([tbl], col_d.view(-1, 1), PayloadMode.FULL)
        torch.cuda.synchronize()
        launches_mh = read_counters(HASH_WRAPPERS)
        got_trip = by_row_payload([rows_h[:, i].cpu().numpy() for i in range(3)])
        if not all(np.array_equal(g, w) for g, w in zip(got_trip, want_trip)):
            raise AssertionError(f"bulk_materialize ({engine}): triples differ from numpy's "
                                 "and the sort-merge route's")
        idle = [k for k, v in launches_mh.items() if v == 0]
        if idle:
            raise AssertionError(f"kernels not launched by {engine}'s bulk_materialize: {idle}")
        log(f"phase materialize {engine}: ok, {rows_h.shape[0]} triples (262144 build rows, "
            f"4 per key, x 4M probes) equal numpy's and the sort-merge route's; launches "
            f"{launches_mh}")
    log(f"phase hash materialize: ok ({time.perf_counter() - t0:.1f} s)")

    # ---- 21. the benchmark entry point on the hash engines -----------------
    for engine in ("hash_lp", "hash_csr"):
        result = config1_single_join(engine=engine, device="cuda")
        log(f"phase config1_single_join {engine}: ok {json.dumps(result)}")

    # ---- 22. the LP ladder's own answer, and its time, at lower hit rates --
    # Config 1's build keys are 0 .. N_BUILD - 1 with payload key + 10^7, so
    # probes uniform over [0, N_BUILD * 100 / pct) hit pct % of the time and
    # every row's (mult, psum) is known exactly.
    t0 = time.perf_counter()
    csr_table = hash_tables["hash_csr"][0]
    gen = torch.Generator(device="cuda").manual_seed(22)
    ladder_log = []
    for pct in LADDER_HIT_PCTS:
        col_l = torch.randint(0, N_BUILD * 100 // pct, (N_PROBE,), generator=gen,
                              device="cuda", dtype=torch.int64)
        hit = col_l < N_BUILD
        want_m, want_p = hit.to(torch.int32), torch.where(hit, col_l + 10_000_000, 0)
        zero_counters(HASH_WRAPPERS)
        ladder = lp_match_stats(lp_table, col_l, compact_lanes=True)
        torch.cuda.synchronize()
        lc = read_counters(HASH_WRAPPERS)
        held = lc["murmurhash64_i64"] == 1  # a second hash is the full-width recompute
        if pct <= 25 and not (held and lc["compact_i32"] == 4):
            raise AssertionError(f"LP ladder at {pct} % hits: launches {lc}, expected the "
                                 "ladder to hold (1 hash, 4 compactions)")
        for what, s in (("ladder", ladder),
                        ("full width", lp_match_stats(lp_table, col_l, compact_lanes=False)),
                        ("all-plain ladder", lp_match_stats(lp_table, col_l, compact_lanes=True,
                                                            route=HASH_PLAIN))):
            if not (torch.equal(s.mult, want_m) and torch.equal(s.psum, want_p)):
                raise AssertionError(f"LP {what} at {pct} % hits: mult or psum differ from "
                                     "the exact answer")
        want_l = (int(want_m.sum()), int(want_p.sum()))
        calls = {
            "ladder": lambda c=col_l: lp_match_stats(lp_table, c, compact_lanes=True),
            "full width": lambda c=col_l: lp_match_stats(lp_table, c, compact_lanes=False),
            "hash_csr": lambda c=col_l: bulk_count([csr_table], c.view(-1, 1)),
            "sort_merge": lambda c=col_l.to(torch.int32): bulk_count([table], c.view(-1, 1)),
        }
        for engine in ("hash_csr", "sort_merge"):
            res_l = calls[engine]()
            if (int(res_l.count), int(res_l.payload_checksums[0])) != want_l:
                raise AssertionError(f"{engine} at {pct} % hits: bulk_count gave "
                                     f"{(int(res_l.count), int(res_l.payload_checksums[0]))}, "
                                     f"exact {want_l}")
        e22 = {k: [] for k in calls}
        for order in (list(calls), list(calls)[::-1]):
            for k in order:
                e22[k] += cuda_ms(calls[k])
        ladder_log.append(f"  {pct} % hits ({want_l[0]} matches; ladder "
                          f"{'held' if held else 'overflowed'}, launches {lc}): "
                          + "; ".join(f"{k} {spread(ts)}" for k, ts in e22.items()))
    log(f"phase LP ladder: ok ({time.perf_counter() - t0:.1f} s), at "
        f"{', '.join(map(str, LADDER_HIT_PCTS))} % hits the ladder's, full width's and the "
        "all-plain ladder's mult and psum equal the exact answer on every row; CSR and "
        "sort-merge count and checksum equal it")
    log(f"times on [{card}], CUDA events, medians of {2 * REPS}, {N_PROBE} probes over config "
        "1's tables (LP: lp_match_stats; CSR, sort-merge: bulk_count):")
    for line in ladder_log:
        log(line)

    # ---- 23. slice 7's kernel, the fused drain (#10), at small shapes ------
    t0 = time.perf_counter()

    def drain_same(args, fanouts, what, **occ):
        """#10 (or, with record_occupancy, its variant) against its plain
        version on the same card tensors: total, cache counts, work, rows,
        the histograms and every cache's live prefix."""
        block = args[0].shape[2]
        name = "drain_segment_occ" if occ.get("record_occupancy") else "drain_segment"
        got = drain_segment(*args, block=block, fanouts=fanouts, **occ)
        want = drain_segment_plain(*args, block=block, fanouts=fanouts, **occ)
        same(name, [got[0], *got[2:]], [want[0], *want[2:]], what)
        for level in range(len(fanouts) - 1):
            live = int(want[2][level])
            same(name, got[1][level, level + 1 :, :live],
                 want[1][level, level + 1 :, :live], f"{what} cache {level}")
        return got

    def drain_inputs(S, block, fanouts, thresholds, counts=None, occupancy=False):
        """int32 card inputs of #10: mults in [0, fanout] (the last level's
        up to 5), counts (empty, partial and full chunks unless given),
        caches with a random live prefix (with `occupancy`, L cache counts:
        the last level's count-only cache)."""
        L = len(fanouts)
        highs = list(fanouts[:-1]) + [5]
        mults = np.stack([rng.integers(0, h + 1, (S, block)) for h in highs], axis=1)
        if counts is None:
            counts = rng.choice([0, block, int(rng.integers(1, block))], S)
        CL = max(L - 1, 1)
        if occupancy:
            cache_cnt = rng.integers(0, block, L)
        else:
            cache_cnt = rng.integers(0, block, CL) if L > 1 else np.zeros(1, np.int64)
        return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).cuda()
                for a in (mults, counts, thresholds,
                          rng.integers(0, max(highs) + 1, (CL, L, block)), cache_cnt)]

    # test_torch_drain.py's cases against the JAX kernel, then random ones
    for fanouts, thresholds, counts in (
        ((1,), (0,), [128, 0, 77]),
        ((1, 1), (64, 64), [128, 5, 60, 0, 128, 31]),
        ((2, 2, 2), (128, 128, 128), [128, 0, 77, 128]),
        ((3, 1, 2, 1), (0, 128, 64, 0), [128, 100, 0, 3, 128]),
    ):
        drain_same(drain_inputs(len(counts), 128, fanouts, thresholds, counts), fanouts,
                   f"fanouts {fanouts} thresholds {thresholds}")
    for case in range(24):
        L = int(rng.integers(1, 6))
        block = int(rng.choice([128, 384, 1024, 2048] + ([4096] if L <= 4 else [])))
        fanouts = tuple(int(f) for f in rng.integers(1, 4, L))
        while np.prod(fanouts[:-1]) > MAX_PATHS:
            fanouts = tuple(max(f - 1, 1) for f in fanouts)
        thresholds = [int(rng.choice([0, block // 2, block, int(rng.integers(1, block))]))
                      for _ in range(L)]
        drain_same(drain_inputs(int(rng.integers(0, 41)), block, fanouts, thresholds), fanouts,
                   f"random case {case}: L={L} block={block} fanouts {fanouts}")
    try:
        drain_segment(*drain_inputs(2, 128, (8, 9, 1), [0] * 3), block=128, fanouts=(8, 9, 1))
    except ValueError as err:
        refused = str(err)
    else:
        raise AssertionError("#10 ran fanouts (8, 9, 1): 72 drain paths, over the JAX gate's 64")
    torch.cuda.synchronize()
    log(f"phase slice-7 kernel (small shapes): ok ({time.perf_counter() - t0:.1f} s), max "
        f"|kernel - plain| {max_err['drain_segment']}; refused: {refused}")

    # ---- 24. config 3 on the sorted-chunk executor at full size ------------
    t0 = time.perf_counter()
    host3 = probe3.cpu().numpy().astype(np.int64)
    rank_kernels = ("sort_tiles_multi_i32", "merge_multi_i32", "merge_stats_i32")
    drain_wrappers = {"drain_segment": (drain_segment,), **NEW_WRAPPERS}
    n_chunks3 = -(-host3.shape[0] // 2048)
    launches_c3, c3_log, pipes3 = {}, [], {}

    def chunked(host):
        """A host probe table as `run(preload=True)` puts it on the card:
        (int64[S, n_joins, 2048] chunk columns, int32[S] counts)."""
        n, S = host.shape[0], -(-host.shape[0] // 2048)
        cols = np.pad(host, ((0, S * 2048 - n), (0, 0))).reshape(S, 2048, host.shape[1])
        return (torch.from_numpy(np.ascontiguousarray(cols.transpose(0, 2, 1))).cuda(),
                torch.from_numpy(np.minimum(2048, n - 2048 * np.arange(S)).astype(np.int32))
                .cuda())

    all_cols, all_counts = chunked(host3)

    def timed_section(pipe, cols, counts):
        """`run`'s timed work on a preloaded stream: the segment, then the
        flush (no host copy, no batch cut): the device idle share's window."""
        thr = pipe.static_thresholds()
        ps = pipe._process_chunks(pipe.fresh_state(), cols, counts, thr)
        if pipe.config.strategy is not CompactionStrategy.NONE:
            ps = pipe._flush_all(ps, thr)
        return ps.result_count

    for strategy in (CompactionStrategy.NONE, CompactionStrategy.FULL,
                     CompactionStrategy.BINARY):
        cfg3 = EngineConfig(block_size=2048, n_joins=4, lhs_size=host3.shape[0],
                            rhs_size=50_000, strategy=strategy)
        pipe = pipes3[strategy] = SortedPipeline(tables3, cfg3)
        for preload in (True, False):
            zero_counters(drain_wrappers)
            r = pipe.run(host3, preload=preload)
            lc = read_counters(drain_wrappers)
            launches_c3[(strategy.value, preload)] = lc
            if r["count"] != want3 or r["count"] != got3[0]:
                raise AssertionError(f"sorted {strategy.value} preload={preload}: count "
                                     f"{r['count']}, oracle {want3}, bulk_count {got3[0]}")
            want_launches = 1 if preload else -(-n_chunks3 // cfg3.tuner_segment_chunks)
            if lc["drain_segment"] != want_launches:
                raise AssertionError(f"sorted {strategy.value} preload={preload}: #10 "
                                     f"launched {lc['drain_segment']} times, expected "
                                     f"{want_launches}")
            idle = [k for k in rank_kernels if lc[k] == 0]
            if idle:
                raise AssertionError(f"rank-pass kernels not launched by the sorted "
                                     f"executor: {idle}")
        runs = {preload: [pipe.run(host3, preload=preload)["seconds"] * 1e3 for _ in range(5)]
                for preload in (True, False)}
        td = SortedPipeline(tables3, cfg3, use_kernel=False).run(host3, preload=True)
        if td["count"] != want3:
            raise AssertionError(f"torch drain {strategy.value}: count {td['count']}")
        if int(timed_section(pipe, all_cols, all_counts)) != want3:
            raise AssertionError("the timed section's count differs")
        idle_c3, n_ev = idle_share(lambda p=pipe: timed_section(p, all_cols, all_counts))
        c3_log.append(
            f"  {strategy.value}: preloaded {spread(runs[True])}, streamed {spread(runs[False])}; "
            f"device idle share {idle_c3:.4f} ({n_ev} device events in {PROFILED_CALLS} "
            f"calls); torch drain (use_kernel=False) preloaded {td['seconds'] * 1e3:.4f} ms; "
            f"launches preloaded {launches_c3[(strategy.value, True)]}, streamed "
            f"{launches_c3[(strategy.value, False)]}")
    log(f"phase config 3 sorted executor: ok ({time.perf_counter() - t0:.1f} s), 1M x 4 levels "
        f"x 50K, block 2048: NONE, FULL and BINARY, preloaded and streamed, and the torch "
        f"drain count {want3} (oracle and bulk_count agree)")
    log(f"times on [{card}], host clock around run() (synced), medians of 5:")
    for line in c3_log:
        log(line)

    # ---- 25. #10 at config-3 shapes -----------------------------------------
    pipe = pipes3[CompactionStrategy.FULL]
    mults3 = pipe._seg_mults(all_cols)
    thr3 = torch.full((4,), 2048, dtype=torch.int32, device="cuda")
    cache3 = torch.zeros((3, 4, 2048), dtype=torch.int32, device="cuda")
    ccnt3 = torch.zeros(3, dtype=torch.int32, device="cuda")
    d_args = (mults3, all_counts, thr3, cache3, ccnt3)
    d_out = drain_same(d_args, tuple(pipe._fanout), "config 3 FULL")
    torch.cuda.synchronize()
    kernel_ms["drain_segment"] = (
        med(cuda_ms(lambda: drain_segment(*d_args, block=2048, fanouts=(1,) * 4))),
        med(cuda_ms(lambda: drain_segment_plain(*d_args, block=2048, fanouts=(1,) * 4),
                    reps=3)),
    )
    S3 = mults3.shape[0]
    # the mult planes and the counts read once, the caches read and written
    # once; about four operations (compare, scan, move, add) per arriving
    # row and drain rank
    work["drain_segment"] = (4 * S3 * 4 * 2048 + 8 * 3 * 4 * 2048 + 4 * S3,
                             4 * int(d_out[4].sum()))
    bound_d = bound(*work["drain_segment"])
    log(f"phase slice-7 kernel (config-3 shapes): ok, {S3} chunks x 4 levels x 2048, FULL, "
        f"total {int(d_out[0])}, work {d_out[3].tolist()}, rows {d_out[4].tolist()}: kernel "
        f"{kernel_ms['drain_segment'][0]:.4f} ms, plain {kernel_ms['drain_segment'][1]:.4f} "
        f"ms, bound {bound_d[0]:.4f} ms ({bound_d[1]}) [{card}]")

    # #10 read apart at config 3's and config 7's shapes
    table7, host7, want7 = config7_data(2_000_000, 50_000, torch.device("cuda"))
    cols7, counts7 = chunked(host7)
    mults7 = SortedPipeline([table7] * 4, EngineConfig(
        block_size=2048, n_joins=4, lhs_size=host7.shape[0], rhs_size=50_000,
        strategy=CompactionStrategy.FULL))._seg_mults(cols7)
    thr_none = torch.zeros(4, dtype=torch.int32, device="cuda")
    log(f"  #10 read apart on [{card}] (bench.kernel_split.split; call: medians of "
        f"{kernel_split.REPS} (min, max); chain: {kernel_split.CHAIN} calls; device: "
        f"torch.profiler over {kernel_split.TRACE_CALLS} calls), blocks of 512 threads, "
        "fanouts 1, zero caches:")
    for what, args in (
        (f"config 3 FULL S={S3}", d_args),
        (f"config 3 NONE S={S3}", (mults3, all_counts, thr_none, cache3, ccnt3)),
        ("config 3 FULL S=64", (mults3[:64].contiguous(), all_counts[:64].contiguous(), thr3,
                                cache3, ccnt3)),
        (f"config 7 FULL S={mults7.shape[0]}", (mults7, counts7, thr3, cache3, ccnt3)),
    ):
        out = drain_same(args, (1,) * 4, f"#10 {what}")
        calls = [0]

        def call(args=args):
            calls[0] += 1
            return drain_segment(*args, block=2048, fanouts=(1,) * 4)

        before = drain_segment.launches
        try:
            r = kernel_split.split(call)
            reading = kernel_split.summary(r)
        except RuntimeError as err:  # the profiler saw no device event
            ts = cuda_ms(call)
            reading = f"call {med(ts):.4f} ms (min {min(ts):.4f}, max {max(ts):.4f}); {err}"
        if drain_segment.launches - before != calls[0]:
            raise AssertionError(f"#10 {what}: {drain_segment.launches - before} launches in "
                                 f"{calls[0]} calls")
        S = args[0].shape[0]
        grid_d = drain_grid(S, (1,) * 4)
        if grid_d < 2:
            raise AssertionError(f"#10 {what}: a cooperative grid of {grid_d} block(s)")
        b = bound(4 * S * 4 * 2048 + 8 * 3 * 4 * 2048 + 4 * S, 4 * int(out[4].sum()))
        log(f"    {what}: total {int(out[0])}, rows {out[4].tolist()}; grid {grid_d}; "
            f"{reading}; one launch a call; bound {b[0]:.6f} ms ({b[1]})")

    # ---- 26. config 7 at full size: three static policies -------------------
    t0 = time.perf_counter()
    tables7 = [table7] * 4
    bulk7 = int(bulk_count(tables7, host7).count)
    if bulk7 != want7:
        raise AssertionError(f"config 7: bulk_count {bulk7}, oracle {want7}")
    base7 = EngineConfig(block_size=2048, n_joins=4, lhs_size=host7.shape[0],
                         rhs_size=50_000, strategy=CompactionStrategy.FULL)
    cases7 = {
        "no_compaction": EngineConfig(block_size=2048, n_joins=4, lhs_size=host7.shape[0],
                                      rhs_size=50_000),
        "full_compaction": base7,
        "mixed_static": EngineConfig(block_size=2048, n_joins=4, lhs_size=host7.shape[0],
                                     rhs_size=50_000, strategy=CompactionStrategy.FULL,
                                     compact_threshold_per_level=(0, 2048, 0, 0)),
    }
    pipes7 = {name: SortedPipeline(tables7, cfg) for name, cfg in cases7.items()}
    c7 = {name: [] for name in pipes7}
    for name, pipe in pipes7.items():
        zero_counters(drain_wrappers)
        r = pipe.run(host7, preload=True)
        lc = read_counters(drain_wrappers)
        if r["count"] != want7 or lc["drain_segment"] != 1:
            raise AssertionError(f"config 7 {name}: count {r['count']} (oracle {want7}), #10 "
                                 f"launches {lc['drain_segment']}")
    for _ in range(5):  # interleaved rounds
        for name, pipe in pipes7.items():
            c7[name].append(pipe.run(host7, preload=True)["seconds"] * 1e3)
    log(f"phase config 7: ok ({time.perf_counter() - t0:.1f} s), 2M x 4 levels x 50K (hit rates "
        f"0.95, 0.03, 1, 1), block 2048: no_compaction, full_compaction and mixed_static "
        f"count {want7} (oracle and bulk_count agree), one #10 launch a run")
    log(f"times on [{card}], host clock around run(preload=True) (synced), medians of 5 "
        "interleaved rounds:")
    for name, pipe in pipes7.items():
        idle7, n_ev = idle_share(lambda p=pipe: timed_section(p, cols7, counts7))
        log(f"  {name}: {spread(c7[name])}; device idle share {idle7:.4f} ({n_ev} device "
            f"events in {PROFILED_CALLS} calls)")

    repo_root = os.path.dirname(os.path.abspath(__file__))

    def cli_pipeline(*args, cwd=repo_root):
        """The CLI's `pipeline` command in a process of its own: its stderr
        lines; it must exit 0."""
        env = dict(os.environ, PYTHONPATH=repo_root)
        proc = subprocess.run([sys.executable, "-m", "ccve_tpu_torch.cli", "pipeline", *args],
                              capture_output=True, text=True, timeout=600, cwd=cwd, env=env)
        if proc.returncode != 0:
            raise AssertionError(f"cli pipeline {args}: rc {proc.returncode}\n{proc.stderr}")
        return proc.stderr.splitlines()

    # ---- 27. the benchmark entry point and the CLI's pipeline command -------
    config7 = config7_heterogeneous_levels(device="cuda")
    log(f"phase config7_heterogeneous_levels: ok {json.dumps(config7)}")
    known_good = ("--join-num", "2", "--chunk-factor", "2", "--lhs-size", "3000", "--rhs-size",
                  "256", "--block-size", "256", "--table", "sorted", "--executor", "sorted")
    lines = cli_pipeline(*known_good, "--strategy", "full")
    if " [Result Rows] 2992" not in lines:
        raise AssertionError("the known-good pipeline command:\n" + "\n".join(lines))
    log("phase cli pipeline: ok, " + "; ".join(
        line.strip() for line in lines if "[Result Rows]" in line or "[Total Time]" in line))

    # ---- 28. the fused drain's repair: the shapes it refused ------------------
    t0 = time.perf_counter()
    for L, block, fanouts in ((6, 2048, (1, 2, 1, 1, 2, 1)), (5, 4096, (1,) * 5),
                              (9, 2048, (1,) * 9), (2, 8192, (2, 1))):
        thresholds = [int(rng.choice([0, block // 2, block])) for _ in range(L)]
        drain_same(drain_inputs(8, block, fanouts, thresholds), fanouts,
                   f"repaired L={L} block={block}")
        drain_same(drain_inputs(8, block, fanouts, thresholds, occupancy=True), fanouts,
                   f"repaired L={L} block={block}, occupancy", record_occupancy=True)
    keys6, pays6 = gen_rhs_table(50_000, 1)
    probe6 = gen_probe_table(1_000_000, 6, 50_000)
    want6 = int(bulk_count([sm.build_sorted(keys6, pays6, device="cuda")] * 6, probe6).count)
    lines = cli_pipeline("--join-num", "6", "--lhs-size", "1000000", "--rhs-size", "50000",
                         "--table", "sorted", "--executor", "sorted", "--strategy", "full",
                         "--preload")
    if f" [Result Rows] {want6}" not in lines:
        raise AssertionError(f"cli pipeline --join-num 6: bulk_count counts {want6}\n" +
                             "\n".join(lines))
    log(f"phase drain repair: ok ({time.perf_counter() - t0:.1f} s), #10 and its variant equal "
        f"their plain version at (6, 2048), (5, 4096), (9, 2048), (2, 8192); cli pipeline "
        f"--join-num 6 (1M x 50K, block 2048, FULL, preloaded) counts {want6} as bulk_count; " +
        "; ".join(x.strip() for x in lines if "[Total Time]" in x or "[Throughput]" in x))

    # ---- 29. #10's occupancy variant at small shapes ---------------------------
    t0 = time.perf_counter()
    for fanouts, thresholds, counts, branchy in (
        ((2, 3), (0, 0), [128, 0, 77, 128], True),
        ((2, 2, 2), (128, 128, 128), [128, 0, 77, 128, 13], False),
        ((3, 1, 2), (64, 128, 0), [128, 100, 0, 3, 128], True),
    ):
        drain_same(drain_inputs(len(counts), 128, fanouts, thresholds, counts, occupancy=True),
                   fanouts, f"occupancy fanouts {fanouts}", record_occupancy=True,
                   branchy=branchy)
    for case in range(16):
        L = int(rng.integers(1, 6))
        block = int(rng.choice([128, 384, 1024, 2048, 4096]))
        fanouts = tuple(int(f) for f in rng.integers(1, 4, L))
        while np.prod(fanouts[:-1]) > MAX_PATHS:
            fanouts = tuple(max(f - 1, 1) for f in fanouts)
        thresholds = [int(rng.choice([0, block // 2, block, int(rng.integers(1, block))]))
                      for _ in range(L)]
        drain_same(drain_inputs(int(rng.integers(0, 41)), block, fanouts, thresholds,
                                occupancy=True), fanouts,
                   f"occupancy random case {case}: L={L} block={block} fanouts {fanouts}",
                   record_occupancy=True, branchy=bool(case % 2))
    torch.cuda.synchronize()
    log(f"phase occupancy variant (small shapes): ok ({time.perf_counter() - t0:.1f} s), max "
        f"|kernel - plain| {max_err['drain_segment_occ']}")

    # ---- 30. #11 at small shapes ------------------------------------------------
    t0 = time.perf_counter()

    def rank_same(table, keys, valid, what):
        args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (table, keys, valid)]
        got = chunk_rank(*args)
        want = chunk_rank_plain(*args)
        same("chunk_rank", got[0], want[0], what)
        live = want[0] > 0
        same("chunk_rank", got[1][live], want[1][live], f"{what} start")
        return got

    for m, dom, count, block in ((500, 400, 256, 256), (30, 400, 170, 256), (256, 256, 0, 256),
                                 (700, 10, 256, 256), (128, 1000, 77, 128),
                                 (4000, 100, 2048, 2048), (0, 50, 128, 128)):
        table = np.sort(rng.integers(0, dom, m, dtype=np.int64))
        keys = rng.integers(-5, dom + 5, block, dtype=np.int64)
        rank_same(table, keys, np.arange(block) < count, f"m={m} dom={dom} count={count}")
    ext = np.array([-I64_MAX - 1, -I64_MAX - 1, -(1 << 62), -1, 0, 0, 0, 1 << 40, I64_MAX - 1,
                    I64_MAX], np.int64)
    rank_same(ext, np.resize(ext[::-1], 128), np.arange(128) % 7 != 3, "int64 extremes")
    for case in range(24):
        m = int(rng.integers(0, 200_000))
        block = int(rng.choice([128, 256, 1024, 2048, 4096]))
        dom = int(rng.choice([3, 1000, 1 << 20, 1 << 50]))
        table = np.sort(rng.integers(-dom, dom, m, dtype=np.int64))
        keys = rng.integers(-dom - 2, dom + 2, block, dtype=np.int64)
        if m:
            keys[: block // 2] = table[rng.integers(0, m, block // 2)]
        rank_same(table, keys, rng.random(block) < 0.9, f"random case {case}: m={m}")
    # the index design's edges: start compared everywhere (the lower bound)
    rank_edges = edge_cases.chunk_rank_cases(np.random.default_rng(30))
    for what, table, keys, valid in rank_edges:
        args = [torch.from_numpy(a).cuda() for a in (table, keys, valid)]
        same("chunk_rank", chunk_rank(*args), chunk_rank_plain(*args), what)
    torch.cuda.synchronize()
    log(f"phase slice-7b kernel #11 (small shapes): ok ({time.perf_counter() - t0:.1f} s), max "
        f"|kernel - plain| {max_err['chunk_rank']}; {len(rank_edges)} edge cases exact: "
        + "; ".join(what for what, *_ in rank_edges))

    # ---- 31. config 3 in the chunk rank mode at full size -------------------------
    t0 = time.perf_counter()
    rank_wrappers = {"chunk_rank": (chunk_rank,)}
    launches_cr, c31_log = {}, []
    for strategy in (CompactionStrategy.NONE, CompactionStrategy.FULL):
        cfg3 = EngineConfig(block_size=2048, n_joins=4, lhs_size=host3.shape[0],
                            rhs_size=50_000, strategy=strategy)
        pipe = SortedPipeline(tables3, cfg3, rank_mode="chunk")
        zero_counters(rank_wrappers)
        r = pipe.run(host3, preload=True)
        launches_cr[strategy.value] = read_counters(rank_wrappers)["chunk_rank"]
        if r["count"] != want3 or launches_cr[strategy.value] == 0:
            raise AssertionError(f"chunk mode {strategy.value}: count {r['count']} (oracle "
                                 f"{want3}), #11 launches {launches_cr[strategy.value]}")
        chunk_s = [pipe.run(host3, preload=True)["seconds"] * 1e3 for _ in range(5)]
        batched_s = [pipes3[strategy].run(host3, preload=True)["seconds"] * 1e3
                     for _ in range(5)]
        c31_log.append(f"  {strategy.value}: chunk mode {spread(chunk_s)}, batched mode "
                       f"{spread(batched_s)}; #11 launches a run {launches_cr[strategy.value]}")
    log(f"phase config 3 chunk rank mode: ok ({time.perf_counter() - t0:.1f} s), NONE and FULL "
        f"preloaded count {want3} with #11 launched")
    log(f"times on [{card}], host clock around run(preload=True) (synced), medians of 5:")
    for line in c31_log:
        log(line)
    # #11 at config 3's shapes: one chunk (2048 lanes) against the 50K table
    table3_keys = tables3[0].keys
    keys_cr = all_cols[len(all_cols) // 2, 0].contiguous()
    valid_cr = torch.ones(2048, dtype=torch.bool, device="cuda")
    rank_same(table3_keys.cpu().numpy(), keys_cr.cpu().numpy(), valid_cr.cpu().numpy(),
              "config-3 shapes")
    kernel_ms["chunk_rank"] = (
        med(cuda_ms(lambda: chunk_rank(table3_keys, keys_cr, valid_cr))),
        med(cuda_ms(lambda: chunk_rank_plain(table3_keys, keys_cr, valid_cr))),
        med(cuda_ms(lambda: (torch.searchsorted(table3_keys, keys_cr, side="left"),
                             torch.searchsorted(table3_keys, keys_cr, side="right")))),
    )
    m3 = table3_keys.numel()
    # keys, valid flags and both outputs once, the table read once a launch;
    # two binary searches a lane
    work["chunk_rank"] = (8 * 2048 + 2048 + 8 * 2048 + 8 * m3, 2 * 2048 * log2_ceil(m3))
    bound_cr = bound(*work["chunk_rank"])
    log(f"  #11 at config-3 shapes (2048 lanes, m = {m3}), CUDA events, medians of {REPS}: "
        f"kernel {kernel_ms['chunk_rank'][0]:.4f} ms, plain {kernel_ms['chunk_rank'][1]:.4f} "
        f"ms, two torch.searchsorted {kernel_ms['chunk_rank'][2]:.4f} ms, bound "
        f"{bound_cr[0]:.6f} ms ({bound_cr[1]}, the table counted once a launch) [{card}]")
    rank_split = kernel_split.in_turns({
        "chunk_rank": lambda: chunk_rank(table3_keys, keys_cr, valid_cr),
        "two torch.searchsorted": lambda: (
            torch.searchsorted(table3_keys, keys_cr, side="left"),
            torch.searchsorted(table3_keys, keys_cr, side="right")),
    })
    log_split(rank_split, bound_cr[0])
    log("    #11's host steps, us a call (timed apart): " + "; ".join(
        f"{k} {v:.2f}" for k, v in kernel_split.rank_host_steps(
            table3_keys, keys_cr, valid_cr).items()))
    if (rank_split["chunk_rank"]["device"]["events"], rank_split["chunk_rank"]["allocs"]) != (1, 1):
        raise AssertionError(f"#11 a call: {rank_split['chunk_rank']['device']['events']} device "
                             f"events, {rank_split['chunk_rank']['allocs']} allocations")

    # ---- 32. Zebra at config 3 ---------------------------------------------------
    t0 = time.perf_counter()
    occ_wrappers = {"drain_segment_occ": (occupancy_variant,)}
    launches_occ, c32_log = {}, []
    for strategy in (CompactionStrategy.FULL, CompactionStrategy.BINARY):
        cfg3 = EngineConfig(block_size=2048, n_joins=4, lhs_size=host3.shape[0],
                            rhs_size=50_000, strategy=strategy, record_occupancy=True)
        fused = SortedPipeline(tables3, cfg3)
        zero_counters(occ_wrappers)
        r = fused.run(host3, preload=True)
        launches_occ[strategy.value] = read_counters(occ_wrappers)["drain_segment_occ"]
        td = SortedPipeline(tables3, cfg3, use_kernel=False).run(host3, preload=True)
        if (r["count"], td["count"]) != (want3, want3) or launches_occ[strategy.value] != 1:
            raise AssertionError(f"zebra {strategy.value}: counts {r['count']}, {td['count']} "
                                 f"(oracle {want3}), variant launches "
                                 f"{launches_occ[strategy.value]}")
        if not np.array_equal(r["occupancy"], td["occupancy"]):
            raise AssertionError(f"zebra {strategy.value}: the fused route's histograms differ "
                                 "from the torch drain's")
        with_occ = [fused.run(host3, preload=True)["seconds"] * 1e3 for _ in range(5)]
        without = [pipes3[strategy].run(host3, preload=True)["seconds"] * 1e3
                   for _ in range(5)]
        c32_log.append(f"  {strategy.value}: fused with record_occupancy {spread(with_occ)}, "
                       f"without {spread(without)}; {int(r['occupancy'].sum())} emissions "
                       f"recorded, level totals {r['occupancy'].sum(1).tolist()}")
    zebra = ZebraProfiler.get()
    zebra.clear()
    zp = fused.run(host3, zebra_profile=True)
    calls = sum(c for lv in range(4)
                for _, c in zebra.histogram(f"level{lv}_{fused.config.strategy.value}").values())
    if zp["count"] != want3 or calls != int(zp["occupancy"].sum()) or zp["zebra_segments"] < 2:
        raise AssertionError(f"zebra_profile: count {zp['count']}, {zp['zebra_segments']} "
                             f"segments, {calls} calls for {int(zp['occupancy'].sum())} "
                             "recorded emissions")
    zebra.clear()
    log(f"phase config 3 zebra: ok ({time.perf_counter() - t0:.1f} s), FULL and BINARY "
        f"histograms equal on the fused route and the torch drain, count {want3}; "
        f"zebra_profile {zp['zebra_segments']} segments, {calls} calls")
    log(f"times on [{card}], host clock around run(preload=True) (synced), medians of 5:")
    for line in c32_log:
        log(line)
    d_occ = (mults3, all_counts, thr3, cache3, torch.zeros(4, dtype=torch.int32, device="cuda"))
    o_out = drain_same(d_occ, tuple(pipe._fanout), "config 3 FULL, occupancy",
                       record_occupancy=True)
    kernel_ms["drain_segment_occ"] = (
        med(cuda_ms(lambda: drain_segment(*d_occ, block=2048, fanouts=(1,) * 4,
                                          record_occupancy=True))),
        med(cuda_ms(lambda: drain_segment_plain(*d_occ, block=2048, fanouts=(1,) * 4,
                                                record_occupancy=True), reps=3)),
    )
    # the count path's bytes and operations, plus the histograms written once
    work["drain_segment_occ"] = (work["drain_segment"][0] + 4 * 4 * 2049,
                                 4 * int(o_out[4].sum()))
    bound_o = bound(*work["drain_segment_occ"])
    log(f"  the occupancy variant at config-3 shapes (FULL, zero caches): kernel "
        f"{kernel_ms['drain_segment_occ'][0]:.4f} ms, plain "
        f"{kernel_ms['drain_segment_occ'][1]:.4f} ms, bound {bound_o[0]:.4f} ms "
        f"({bound_o[1]}) [{card}]")

    # ---- 33. DYNAMIC at config 7's full size ---------------------------------------
    t0 = time.perf_counter()
    dyn_cfg = EngineConfig(block_size=2048, n_joins=4, lhs_size=host7.shape[0],
                           rhs_size=50_000, strategy=CompactionStrategy.DYNAMIC,
                           threshold_arms=(0, 2048), tuner_segment_chunks=16)
    dyn_cases = {
        "device tuner, preloaded": (dataclasses.replace(dyn_cfg, device_tuner=True), True),
        "device tuner, streamed": (dataclasses.replace(dyn_cfg, device_tuner=True), False),
        "host tuner, streamed": (dyn_cfg, False),
    }
    dyn_wrappers = {"drain_segment": (drain_segment,), **NEW_WRAPPERS}
    c33_log = []
    for name, (cfg, preload) in dyn_cases.items():
        pipe = SortedPipeline(tables7, cfg)
        zero_counters(dyn_wrappers)
        r = pipe.run(host7, preload=preload)
        lc = read_counters(dyn_wrappers)
        idle = [k for k in ("drain_segment", *rank_kernels) if lc[k] == 0]
        if r["count"] != want7 or idle:
            raise AssertionError(f"config 7 DYNAMIC {name}: count {r['count']} (oracle {want7}), "
                                 f"kernels not launched {idle}")
        times = [pipe.run(host7, preload=preload)["seconds"] * 1e3 for _ in range(3)]
        line = f"  {name}: {spread(times)}; #10 launches {lc['drain_segment']}"
        if cfg.device_tuner:
            line += (f"; greedy thresholds {r['greedy_thresholds'].tolist()}, committed "
                     f"{r['bandit_committed'].tolist()} at round {r['bandit_commit_t'].tolist()}"
                     f", selections {r['bandit_n_sel'].tolist()}")
        c33_log.append(line)
    # the host syncs of one device-tuner segment, by torch's sync debug mode
    import warnings

    pipe = SortedPipeline(tables7, dataclasses.replace(dyn_cfg, device_tuner=True))
    seg_syncs = []
    segment_fn = pipe._process_seg_device_dynamic

    def counted_segment(*args):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = segment_fn(*args)
        seg_syncs.append([f"{os.path.relpath(w.filename, repo_root)}:{w.lineno}"
                          for w in caught if "synchroniz" in str(w.message)])
        return out

    pipe._process_seg_device_dynamic = counted_segment
    torch.cuda.set_sync_debug_mode("warn")
    try:
        r = pipe.run(host7, preload=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if r["count"] != want7:
        raise AssertionError(f"config 7 DYNAMIC under sync debug: count {r['count']}")
    where = sorted({site for segment in seg_syncs for site in segment})
    log(f"phase config 7 DYNAMIC: ok ({time.perf_counter() - t0:.1f} s), 2M x 4 levels, block "
        f"2048, arms (0, 2048), 16 chunks a segment: device tuner preloaded and streamed, host "
        f"tuner streamed, count {want7} each (the oracle's); host syncs a device-tuner segment: "
        f"{sum(map(len, seg_syncs)) / len(seg_syncs):.2f} over {len(seg_syncs)} segments, at "
        f"{where}")
    log(f"times on [{card}], host clock around run() (synced), medians of 3 (phase 26's statics, "
        f"preloaded: " + ", ".join(f"{k} {med(v):.4f} ms" for k, v in c7.items()) + "):")
    for line in c33_log:
        log(line)
    # where a device-tuner run's time goes: the device's idle share and the
    # ops that take the most host time
    from torch.profiler import ProfilerActivity, profile

    pipe = SortedPipeline(tables7, dataclasses.replace(dyn_cfg, device_tuner=True))
    idle_dyn, n_ev = idle_share(lambda: pipe.run(host7, preload=True)["count"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.run(host7, preload=True)
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    log(f"  device tuner, preloaded: device idle share {idle_dyn:.4f} ({n_ev} device events in "
        f"{PROFILED_CALLS} calls); most host time in one run: " + ", ".join(
            f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ms ({e.count} calls)" for e in top))
    log(f"  phase 27's config7_heterogeneous_levels: dynamic_vs_best_static "
        f"{config7['dynamic_vs_best_static']:.4f}, dynamic_compaction_device "
        f"{json.dumps(config7['dynamic_compaction_device'])}")

    # ---- 34. the CLI's pipeline command with the tuner and the Zebra profile -----
    t0 = time.perf_counter()
    zebra_dir = os.path.join(repo_root, "chiprun_out", "zebra_cli")
    os.makedirs(zebra_dir, exist_ok=True)
    cli_log = []
    for extra, cwd in ((("--strategy", "dynamic"), repo_root),
                       (("--strategy", "full", "--record-occupancy"), repo_root),
                       (("--strategy", "full", "--zebra-profile"), zebra_dir)):
        lines = cli_pipeline(*known_good, *extra, cwd=cwd)
        if " [Result Rows] 2992" not in lines:
            raise AssertionError(f"cli pipeline {extra}:\n" + "\n".join(lines))
        cli_log.append(" ".join(extra) + ": " + "; ".join(
            x.strip() for x in lines if "[Result Rows]" in x or "[Zebra]" in x))
    log(f"phase cli tuner and zebra: ok ({time.perf_counter() - t0:.1f} s), " + " | ".join(cli_log))

    # ---- 35. slice 3b's kernels against plain versions, small shapes ---------
    t0 = time.perf_counter()
    rng35 = np.random.default_rng(35)
    i64 = np.iinfo(np.int64)

    def i64_dev(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).cuda()

    def i32_dev(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).cuda()

    def generic_stream(m_g, n_g, pay_lo, pay_hi, dom=None):
        """(sk, st) of the generic totals: build and probe keys (over the
        whole int64 range, or in [-dom, dom]) stably sorted, builds first at
        equal keys, with the payloads tagged pay * 2 + 1 and probes 0."""
        if dom is None:
            bk = rng35.integers(i64.min, i64.max, m_g, dtype=np.int64, endpoint=True)
            bk[: min(m_g, 2)] = [i64.min, i64.max][: min(m_g, 2)]
            pk = rng35.integers(i64.min, i64.max, n_g, dtype=np.int64, endpoint=True)
            if m_g:
                pk[: n_g // 2] = rng35.choice(bk, n_g // 2)
        else:
            bk, pk = rng35.integers(-dom, dom + 1, m_g), rng35.integers(-dom, dom + 2, n_g)
        keys_g = np.concatenate([bk, pk])
        st_g = np.concatenate([rng35.integers(pay_lo, pay_hi, m_g) * 2 + 1, np.zeros(n_g, np.int64)])
        o = np.argsort(keys_g, kind="stable")
        return i64_dev(keys_g[o]), i64_dev(st_g[o])

    for m_g, n_g, pay_lo, pay_hi, dom in (
        (30_000, 90_000, 0, 2**30, None),
        (50_000, 20_000, -(2**40), 2**40, None),  # negative payloads
        (0, 7_000, 0, 1, None),  # all probes
        (7_000, 0, 0, 9, None),  # all builds
        (1, 1, 0, 9, None),
        (20_000, 60_000, -5, 5, 1),  # three keys: runs across many blocks
    ):
        sk_g, st_g = generic_stream(m_g, n_g, pay_lo, pay_hi, dom)
        same("merge_scan_stats_i64", merge_scan.merge_scan_stats(sk_g, st_g),
             merge_scan.merge_scan_stats_plain(sk_g, st_g), f"m={m_g} n={n_g} dom={dom}")
    # runs of INT64_MIN, 0 and INT64_MAX straddling the 2048-element blocks
    sk_g = i64_dev(np.repeat([i64.min, 0, i64.max], [3000, 5000, 4000]))
    st_g = i64_dev(np.where(np.arange(12_000) % 7 == 0, 11, 0))
    same("merge_scan_stats_i64", merge_scan.merge_scan_stats(sk_g, st_g),
         merge_scan.merge_scan_stats_plain(sk_g, st_g), "extreme runs")
    for pay_bits in (2, 25, 31):
        bk, pk = rng35.integers(0, 50_000, 40_000), rng35.integers(0, 50_100, 200_000)
        pays = rng35.integers(0, 2 ** (pay_bits - 1), bk.size)
        s_p = i64_dev(np.sort(np.concatenate([(bk << pay_bits) | (pays << 1),
                                              (pk << pay_bits) | ((1 << pay_bits) - 1)])))
        same("merge_scan_stats_packed_i64", merge_scan.merge_scan_stats_packed(s_p, pay_bits),
             merge_scan.merge_scan_stats_packed_plain(s_p, pay_bits), f"pay_bits={pay_bits}")
    for m_c, n_c, dom, phantoms in ((30_000, 100_000, 20_000, 0), (200_000, 50_000, 2**29, 5000),
                                    (5, 300_000, 2, 10), (10, 0, 5, 3), (0, 10, 5, 0)):
        s_c = i32_dev(np.sort(np.concatenate([np.sort(rng35.integers(0, dom, m_c)) * 2 + 1,
                                              rng35.integers(0, dom + 4, n_c) * 2,
                                              np.full(phantoms, I32_MAX)])))
        # the last m has ranks past the stream's builds, which stay 0
        for mm in (m_c, m_c + phantoms // 2, m_c + phantoms + 3000):
            same("merge_scan_build_counts_i32",
                 merge_scan.merge_scan_build_counts(s_c, mm, extra=phantoms),
                 merge_scan.merge_scan_build_counts_plain(s_c, mm, phantoms),
                 f"m={mm} n={n_c} phantoms={phantoms}")
    for na, nb in ((1, 1), (0, 9), (9, 0), (1, 100_000), (100_000, 1), (100_000, 100_000),
                   (4097, 77_777)):
        for lo, hi in ((-(2**31), 2**31), (0, 5)):  # the whole range; ties
            a = i32_dev(np.sort(rng35.integers(lo, hi, na)))
            b = i32_dev(np.sort(rng35.integers(lo, hi, nb)))
            same("merge_two_i32", bigsort.merge_sorted_i32(a, b),
                 bigsort.merge_sorted_i32_plain(a, b), f"na={na} nb={nb} range [{lo}, {hi})")
    torch.cuda.synchronize()
    log(f"phase slice-3b kernels (small shapes): ok ({time.perf_counter() - t0:.1f} s), max "
        f"|kernel - plain| { {k: max_err[k] for k in SLICE_3B_WRAPPERS} }")

    # ---- 36. the full-range join: 1M x 2^24 over the whole int64 range -------
    t0 = time.perf_counter()
    keys_f, pays_f, probe_f = config1_full_range_host(N_BUILD, N_PROBE_WIDE)
    want_f = numpy_totals(keys_f, pays_f, probe_f)
    table_f = sm.build_sorted(keys_f, pays_f)
    if table_f.pack32 is not None or table_f.span62:
        raise AssertionError("the full-range table has a packed form")
    col_f = torch.from_numpy(probe_f).cuda()
    torch.cuda.synchronize()
    log(f"phase full-range data: ok ({time.perf_counter() - t0:.1f} s), numpy count "
        f"{want_f[0]}, checksum {want_f[1]}")
    zero_counters(SLICE_3B_WRAPPERS)
    res_f = bulk_count([table_f], col_f.view(-1, 1))
    torch.cuda.synchronize()
    launches_3b = {"merge_scan_stats_i64": read_counters(SLICE_3B_WRAPPERS)["merge_scan_stats_i64"]}
    got_f = (int(res_f.count), int(res_f.payload_checksums[0]))
    if got_f != want_f:
        raise AssertionError(f"full-range bulk_count gave {got_f}, numpy {want_f}")
    if launches_3b["merge_scan_stats_i64"] != 1:
        raise AssertionError(f"#15's generic entry launched {launches_3b} by the full-range "
                             "bulk_count, expected once")

    def sort_f():
        """The generic totals' sort: build ∪ probe keys with tagged payloads."""
        keys_all = torch.cat([table_f.keys, col_f])
        tagged = torch.cat([table_f.payloads * 2 + 1, torch.zeros_like(col_f)])
        sk, order_f = keys_all.sort(stable=True)
        return sk, tagged[order_f]

    def plain_totals_f():
        mult_f, psum_f = merge_scan.merge_scan_stats_plain(*sort_f())
        return mult_f.to(torch.int64).sum(), psum_f.sum()

    pc_f, ps_f = plain_totals_f()
    if (int(pc_f), int(ps_f)) != want_f:
        raise AssertionError(f"full-range all-plain route gave ({int(pc_f)}, {int(ps_f)})")
    sk_f, st_f = sort_f()
    same("merge_scan_stats_i64", merge_scan.merge_scan_stats(sk_f, st_f),
         merge_scan.merge_scan_stats_plain(sk_f, st_f), "full range")
    len_f = sk_f.numel()
    log(f"phase full-range join: ok, bulk_count count {got_f[0]} checksum {got_f[1]} (numpy and "
        f"the all-plain route agree); #15's generic entry launched once; {len_f} stream elements")
    e_f = in_turns(lambda: bulk_count([table_f], col_f.view(-1, 1)), plain_totals_f)
    idle_f, n_ev_f = idle_share(lambda: bulk_count([table_f], col_f.view(-1, 1)))
    sort_ms_f = cuda_ms(sort_f)
    kernel_ms["merge_scan_stats_i64"] = (
        med(cuda_ms(lambda: merge_scan.merge_scan_stats(sk_f, st_f))),
        med(cuda_ms(lambda: merge_scan.merge_scan_stats_plain(sk_f, st_f))),
    )
    # sk and st read once, mult and psum written once; run start, tag,
    # two adds and two selects an element
    work["merge_scan_stats_i64"] = (28 * len_f, 6 * len_f)
    del sk_f, st_f
    torch.cuda.reset_peak_memory_stats()
    base_f = torch.cuda.memory_allocated()
    bulk_count([table_f], col_f.view(-1, 1))
    torch.cuda.synchronize()
    peak_f = (torch.cuda.max_memory_allocated() - base_f) / 2**20
    k_f = med(e_f["kernel"])
    log(f"times on [{card}], CUDA events, medians of {2 * REPS}:")
    log(f"  bulk_count full range (1M build x 2^24 probe, keys over the whole int64 range), "
        f"kernel path: {spread(e_f['kernel'])} = {N_PROBE_WIDE / k_f / 1e3:.1f}M probe rows/s; "
        f"peak extra device memory {peak_f:.1f} MiB; device idle share {idle_f:.4f} ({n_ev_f} "
        f"device events in {PROFILED_CALLS} calls)")
    log(f"  all-plain torch path: {spread(e_f['plain'])}")
    log(f"  split: the stable sort with its gather {spread(sort_ms_f)}, #15's generic scan "
        f"{kernel_ms['merge_scan_stats_i64'][0]:.4f} ms (plain "
        f"{kernel_ms['merge_scan_stats_i64'][1]:.4f} ms), the rest (concatenations, sums) "
        f"{k_f - med(sort_ms_f) - kernel_ms['merge_scan_stats_i64'][0]:.4f} ms")

    # ---- 37. the small-probe route on config 1's table ---------------------------
    t0 = time.perf_counter()
    # config 1's table once more: phase 30 reuses the names `table` and `keys`
    keys1, pays1 = gen_rhs_table(N_BUILD, 1)
    table1 = sm.build_sorted(keys1, pays1)
    if not np.array_equal(pays1, payloads):
        raise AssertionError("config 1's generator gave other payloads")
    counted_37 = {**SLICE_3B_WRAPPERS, "merge_counts_i32": (merge_scan.merge_counts_i32,)}
    launches_3b["merge_two_i32"] = launches_3b["merge_scan_build_counts_i32"] = 0
    small_log = []
    for n_s in (*SMALL_PROBE_NS, SMALL_PROBE_NS[-1] + 1):
        col_s = col[:n_s].contiguous()  # config 1's first probe rows
        want_s = numpy_totals(keys1, payloads, probe[:n_s, 0])
        zero_counters(counted_37)
        got_s = sm.sorted_match_totals(table1, col_s)
        torch.cuda.synchronize()
        lc = read_counters(counted_37)
        if (int(got_s[0]), int(got_s[1])) != want_s:
            raise AssertionError(f"sorted_match_totals at n={n_s} gave {got_s}, numpy {want_s}")
        small = n_s in SMALL_PROBE_NS
        seen = (lc["merge_two_i32"], lc["merge_scan_build_counts_i32"], lc["merge_counts_i32"])
        if seen != ((1, 1, 0) if small else (0, 0, 1)):
            raise AssertionError(f"n={n_s}: launches (#5, #4, #3) {seen}")
        if small:
            launches_3b["merge_two_i32"] += lc["merge_two_i32"]
            launches_3b["merge_scan_build_counts_i32"] += lc["merge_scan_build_counts_i32"]
        small_log.append(f"n={n_s} count {want_s[0]} checksum {want_s[1]} "
                         f"({'small-probe' if small else 'tile'} route)")
        if small:
            # the call's own streams, outside the counted call
            p_s, b_s = sm.pack32_streams(table1, col_s)
            ps_s = p_s.sort().values
            s_s = bigsort.merge_sorted_i32(ps_s, b_s)
            same("merge_two_i32", s_s, bigsort.merge_sorted_i32_plain(ps_s, b_s), f"n={n_s}")
            same("merge_scan_build_counts_i32", merge_scan.merge_scan_build_counts(s_s, N_BUILD),
                 merge_scan.merge_scan_build_counts_plain(s_s, N_BUILD), f"n={n_s}")
    log(f"phase small-probe route: ok ({time.perf_counter() - t0:.1f} s), config 1's table: "
        + "; ".join(small_log) + "; #5 and #4 once a small-probe call, #3 on the tile route; "
        "#5 and #4 equal their plain versions on each small call's streams")
    # #5 and #4 at the path's widest shape: 8192 sorted probes and the 1M
    # build stream
    n_8k = SMALL_PROBE_NS[-1]
    p8, b8 = sm.pack32_streams(table1, col[:n_8k].contiguous())
    ps8 = p8.sort().values
    s8 = bigsort.merge_sorted_i32(ps8, b8)
    cat8 = torch.cat([ps8, b8])
    want_b8 = b8 - 1  # the probe value each build's count matches
    kernel_ms["merge_two_i32"] = (
        med(cuda_ms(lambda: bigsort.merge_sorted_i32(ps8, b8))),
        med(cuda_ms(lambda: bigsort.merge_sorted_i32_plain(ps8, b8))),
        med(cuda_ms(lambda: cat8.sort().values)),
    )
    kernel_ms["merge_scan_build_counts_i32"] = (
        med(cuda_ms(lambda: merge_scan.merge_scan_build_counts(s8, N_BUILD))),
        med(cuda_ms(lambda: merge_scan.merge_scan_build_counts_plain(s8, N_BUILD))),
        med(cuda_ms(lambda: torch.searchsorted(ps8, want_b8, right=True)
                    - torch.searchsorted(ps8, want_b8))),
    )
    # #5: both inputs read and the output written once, a compare an
    # output; #4: the stream read once and bc written once, a few
    # operations an element
    len8 = s8.numel()
    work["merge_two_i32"] = (8 * len8, len8)
    work["merge_scan_build_counts_i32"] = (4 * len8 + 4 * N_BUILD, 4 * len8)
    counts_split = kernel_split.in_turns({
        "merge_scan_build_counts": lambda: merge_scan.merge_scan_build_counts(s8, N_BUILD),
        "two torch.searchsorted and a subtraction": lambda: (
            torch.searchsorted(ps8, want_b8, right=True) - torch.searchsorted(ps8, want_b8)),
    })
    d4 = counts_split["merge_scan_build_counts"]["device"]
    if d4["events"] != 1 or any("emset" in k for k in d4["kernels"]):
        raise AssertionError(f"#4 a call: {d4['events']} device events {d4['kernels']}")
    del p8, b8, ps8, s8, cat8, want_b8
    log(f"times on [{card}], CUDA events, medians of {REPS}, 8192 probes against config 1's "
        f"1M rows ({len8} merged elements):")
    for name in ("merge_two_i32", "merge_scan_build_counts_i32"):
        times = kernel_ms[name]
        log(f"  {name}: kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms, library "
            f"{times[2]:.4f} ms, bound {bound(*work[name])[0]:.4f} ms ({bound(*work[name])[1]})")
    log_split(counts_split, bound(*work["merge_scan_build_counts_i32"])[0])
    # #4 on the edges of its one-launch design, each call into memory the
    # allocator last held garbage in (bc has no memset), and from a view 4
    # bytes past a 16-byte boundary (the scalar loads)
    count_edges = edge_cases.dense_counts_cases(np.random.default_rng(37))
    for what, s_e, m_e in count_edges:
        s_e = torch.from_numpy(s_e).cuda()
        for view, x in (("", s_e), (" from element 1", s_e[1:])):
            torch.full((m_e + 4096,), -7, dtype=torch.int32, device="cuda")  # freed at once
            same("merge_scan_build_counts_i32", merge_scan.merge_scan_build_counts(x, m_e),
                 merge_scan.merge_scan_build_counts_plain(x, m_e), what + view)
    torch.cuda.synchronize()
    log(f"  #4 on {len(count_edges)} edge cases, aligned and from element 1, exact: "
        + "; ".join(what for what, *_ in count_edges))

    # ---- 38. #5, #4 and #16 at full width on config 1's own data ----------------
    t0 = time.perf_counter()
    n1, m1 = p32.numel(), b32.numel()
    ps32 = p32.sort().values  # config 1's sorted 16M probe stream
    s38 = bigsort.merge_sorted_i32(ps32, b32)
    same("merge_two_i32", s38, bigsort.merge_sorted_i32_plain(ps32, b32), "config 1")
    bc38 = merge_scan.merge_scan_build_counts(s38, m1)
    same("merge_scan_build_counts_i32", bc38, merge_scan.merge_scan_build_counts_plain(s38, m1),
         "config 1")
    bc38 = bc38.long()
    got38 = (int(bc38.sum()), int((bc38 * table1.payloads).sum()))
    if got38 != (want_count, want_checksum):
        raise AssertionError(f"#5 then #4 on config 1 gave {got38}")
    # config 1's table packed as the JAX package's `table.pack` packs it
    kmin, key_bits, pay_bits = table1.pack
    key_lo, tag = kmin - 1, (1 << pay_bits) - 1
    bpacked = ((table1.keys - key_lo) << pay_bits) | (table1.payloads << 1)
    ppacked = ((col.long() - key_lo).clamp(0, (1 << key_bits) - 1) << pay_bits) | tag
    s_pk = torch.cat([bpacked, ppacked]).sort().values
    zero_counters(SLICE_3B_WRAPPERS)
    mult_pk, psum_pk = merge_scan.merge_scan_stats_packed(s_pk, pay_bits)
    launches_3b["merge_scan_stats_packed_i64"] = read_counters(
        SLICE_3B_WRAPPERS)["merge_scan_stats_packed_i64"]
    got_pk = (int(mult_pk.long().sum()), int(psum_pk.sum()))
    if got_pk != (want_count, want_checksum):
        raise AssertionError(f"#16 on config 1's packed table gave {got_pk}")
    same("merge_scan_stats_packed_i64", (mult_pk, psum_pk),
         merge_scan.merge_scan_stats_packed_plain(s_pk, pay_bits), "config 1 packed")
    del mult_pk, psum_pk, bpacked, ppacked
    cat38 = torch.cat([ps32, b32])
    want_b = b32 - 1  # the probe value each build's count matches
    # #5 and #4 at 17M elements, a shape the main path does not give them
    # (16M probes take the tile route): logged beside their 8192-probe
    # times of phase 37, which the kernel line carries
    ms17 = {
        "merge_two_i32": (
            med(cuda_ms(lambda: bigsort.merge_sorted_i32(ps32, b32))),
            med(cuda_ms(lambda: bigsort.merge_sorted_i32_plain(ps32, b32))),
            med(cuda_ms(lambda: cat38.sort().values)),
            bound(8 * (n1 + m1), n1 + m1),
        ),
        "merge_scan_build_counts_i32": (
            med(cuda_ms(lambda: merge_scan.merge_scan_build_counts(s38, m1))),
            med(cuda_ms(lambda: merge_scan.merge_scan_build_counts_plain(s38, m1))),
            med(cuda_ms(lambda: torch.searchsorted(ps32, want_b, right=True)
                        - torch.searchsorted(ps32, want_b))),
            bound(4 * (n1 + m1) + 4 * m1, 4 * (n1 + m1)),
        ),
    }
    kernel_ms["merge_scan_stats_packed_i64"] = (
        med(cuda_ms(lambda: merge_scan.merge_scan_stats_packed(s_pk, pay_bits))),
        med(cuda_ms(lambda: merge_scan.merge_scan_stats_packed_plain(s_pk, pay_bits))),
    )
    # #16: the packed stream read once, mult and psum written once, decode,
    # run start and adds an element
    work["merge_scan_stats_packed_i64"] = (20 * s_pk.numel(), 8 * s_pk.numel())
    log(f"phase slice-3b kernels (config-1 shapes): ok ({time.perf_counter() - t0:.1f} s), "
        f"#5 then #4: count {got38[0]} checksum {got38[1]}; #16 (pay_bits {pay_bits}): Σ mult "
        f"{got_pk[0]} Σ psum {got_pk[1]}; max |kernel - plain| "
        f"{ {k: max_err[k] for k in SLICE_3B_WRAPPERS} }")
    log(f"times on [{card}], CUDA events, medians of {REPS}:")
    for name in SLICE_3B_WRAPPERS:
        times = kernel_ms[name]
        lib = f", library {times[2]:.4f} ms" if len(times) > 2 else ""
        log(f"  {name}: kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms{lib}, bound "
            f"{bound(*work[name])[0]:.4f} ms ({bound(*work[name])[1]})"
            + (" (phase 36's shape)" if name == "merge_scan_stats_i64"
               else " (phase 37's 8192 probes)" if name in ms17 else ""))
    for name, (kt, pt, lt, (bt, by)) in ms17.items():
        log(f"  {name} at config 1's 17M elements: kernel {kt:.4f} ms, plain {pt:.4f} ms, "
            f"library {lt:.4f} ms, bound {bt:.4f} ms ({by})")
    del s38, cat38, s_pk, ps32

    # ---- 39. #17, the compare-exchange stages, against its plain version ------
    t0 = time.perf_counter()
    for n_ce in (1 << ce_stages.TILE_LOG, 3 << ce_stages.TILE_LOG):
        for k_ce in (1, 3, 16):
            x_ce = values(n_ce)
            same("ce_stages_i32", ce_stages.ce_stages_i32(x_ce, k_ce),
                 ce_stages.ce_stages_plain(x_ce, k_ce), f"n={n_ce} K={k_ce}")
    x_ce = values(1 << 24)
    ce_ms = {}
    for k_ce in (16, 32, 48, 64):
        same("ce_stages_i32", ce_stages.ce_stages_i32(x_ce, k_ce),
             ce_stages.ce_stages_plain(x_ce, k_ce), f"n=2^24 K={k_ce}")
        ce_ms[k_ce] = (
            med(cuda_ms(lambda k=k_ce: ce_stages.ce_stages_i32(x_ce, k))),
            med(cuda_ms(lambda k=k_ce: ce_stages.ce_stages_plain(x_ce, k))),
        )
    # the slice's main path, in this process: the anchors that `cli roofline
    # --anchor` measures, with #17's counter zeroed just before
    ce_stages.ce_stages_i32.launches = 0
    anchors = roofline.measure_anchors()
    launches["ce_stages_i32"] = ce_stages.ce_stages_i32.launches
    if not launches["ce_stages_i32"]:
        raise AssertionError("measure_anchors launched no #17")
    # #17: each key read and written once a launch, one compare-exchange a
    # key a stage; the kernel line carries K = 64
    kernel_ms["ce_stages_i32"] = ce_ms[64]
    work["ce_stages_i32"] = (8 * x_ce.numel(), 64 * x_ce.numel())
    log(f"phase #17 (ce_stages_i32): ok ({time.perf_counter() - t0:.1f} s), equal to its plain "
        f"version at n = 8192 and 24576 (K = 1, 3, 16) and 2^24 (K = 16, 32, 48, 64); "
        f"{launches['ce_stages_i32']} launches in measure_anchors()")
    # #17's own floor: K passes of 8 bytes a key through the SMs' shared memory
    sms, clock_hz = roofline.smem_rate()
    log(f"times on [{card}], CUDA events, medians of {REPS}, one launch over 2^24 keys; "
        f"shared-memory floor at {roofline.SMEM_BYTES_PER_CLOCK} B a clock on {sms} SMs at "
        f"{clock_hz / 1e9:.3f} GHz (clocks.max.sm):")
    for k_ce, (kt, pt) in ce_ms.items():
        b_ms, b_by = bound(8 * x_ce.numel(), k_ce * x_ce.numel())
        floor_ms = roofline.smem_floor_ms(x_ce.numel(), k_ce, sms, clock_hz)
        log(f"  ce_stages_i32 K={k_ce}: kernel {kt:.4f} ms, plain {pt:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {8 * x_ce.numel()} bytes at {roofline.BW_HBM:.3g} B/s, "
            f"{k_ce * x_ce.numel()} operations at {roofline.ALU_OPS_PER_S:.3g} op/s), "
            f"shared-memory floor {floor_ms:.4f} ms ({floor_ms / kt * 100:.1f}% of it reached)")
    slope, intercept, worst = roofline.stage_line(list(ce_ms), [t[0] for t in ce_ms.values()])
    log(f"  K-slope over K = {', '.join(map(str, ce_ms))}: {slope / x_ce.numel() * 1e9:.4f} "
        f"ps a key a stage (least squares; intercept {intercept:.4f} ms), (t64 - t16) / 48 / n "
        f"{(ce_ms[64][0] - ce_ms[16][0]) / 48 / x_ce.numel() * 1e9:.4f} ps; largest deviation "
        f"from the line {worst * 100:.2f}%; the floor's "
        f"{roofline.smem_floor_ms(1, 1, sms, clock_hz) * 1e9:.4f} ps")
    log("  measure_anchors() in this process:\n" + anchors)
    del x_ce

    # ---- 40. the slice through its entry point: cli roofline --anchor -------------
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ccve_tpu_torch.cli", "roofline", "--anchor",
         "--n-build", str(N_BUILD), "--n-probe", str(N_PROBE), "--measured-ms", repr(k_ms)],
        capture_output=True, text=True, timeout=600, cwd=repo_root,
        env=dict(os.environ, PYTHONPATH=repo_root),
    )
    if proc.returncode != 0:
        raise AssertionError(f"cli roofline --anchor: rc {proc.returncode}\n{proc.stderr}")
    out = proc.stdout.splitlines()
    model1 = roofline.count_side_model(N_BUILD, N_PROBE)
    if roofline.count_side_plan(N_BUILD, N_PROBE) != plan1:
        raise AssertionError(f"the model's plan {roofline.count_side_plan(N_BUILD, N_PROBE)} "
                             f"is not config 1's run {plan1}")
    missing = [op.name for op in model1 if not any(line.startswith(op.name) for line in out)]
    missing += [tag for tag in (" A. CE-stage kernel K-slope", " B. library sort",
                                "% of model speed-of-light")
                if not any(tag in line for line in out)]
    if missing:
        raise AssertionError("cli roofline --anchor lacks " + repr(missing) + ":\n"
                             + proc.stdout)
    log(f"phase cli roofline --anchor --measured-ms {k_ms!r}: ok "
        f"({time.perf_counter() - t0:.1f} s)\n" + proc.stdout.rstrip())
    measured1 = {1: "sort_tiles_i32", 2: "merge_level_i32", 3: "merge_counts_i32"}
    log(f"config 1's model speed-of-light beside this run's kernel times on [{card}] "
        f"(phase 5, CUDA events, medians of {REPS}; the merge levels back to back in one "
        f"window):")
    for i, op in enumerate(model1):
        got = (f"measured {kernel_ms[measured1[i]][0]:.4f} ms = "
               f"{op.t_sol * 1e3 / kernel_ms[measured1[i]][0] * 100:.1f}% of it"
               if i in measured1 else "not measured apart")
        log(f"  {op.name}: t_sol {op.t_sol * 1e3:.4f} ms ({op.bound}); {got}")

    # ---- 40, DataCollection: config 3's probe table through chunks on the card ---
    t0 = time.perf_counter()
    dc3 = DataCollection.from_columns(host3.T)
    back3 = DataCollection(host3.shape[1])
    for start in range(0, len(dc3), 2048):
        chunk3 = dc3.fetch_chunk(start, min(start + 2048, len(dc3)), 2048, device="cuda")
        if chunk3.cols.device.type != "cuda":
            raise AssertionError(f"fetch_chunk gave a chunk on {chunk3.cols.device}")
        back3.append_chunk(chunk3)
    # one chunk through a selection vector: its rows whose level-0 key is even
    chunk3 = dc3.fetch_chunk(0, 2048, 2048, device="cuda")
    picked = torch.nonzero(chunk3.cols[0] % 2 == 0).flatten().to(torch.int32)
    n_picked = picked.numel()
    picked = torch.cat([picked, picked.new_zeros(2048 - n_picked)])
    back3.append_chunk(chunklib.slice_compose(chunk3, picked, n_picked))
    want3_rows = np.concatenate([host3, host3[:2048][host3[:2048, 0] % 2 == 0]])
    if not np.array_equal(back3.rows(), want3_rows):
        raise AssertionError("DataCollection: config 3's probe table did not round-trip")
    log(f"phase DataCollection: ok ({time.perf_counter() - t0:.1f} s), config 3's probe table "
        f"({host3.shape[0]} x {host3.shape[1]}) through fetch_chunk(..., device='cuda') and "
        f"append_chunk in {-(-host3.shape[0] // 2048)} chunks of 2048, and {n_picked} rows of "
        "one chunk through a selection vector, equal to the table")

    # ---- 41-45. slice 6: the cursor executor over hash tables -----------------------
    cursor_launches = cursor_phases(card, same, host3, want3)
    cli_cursor_phase(card, known_good, cli_pipeline, repo_root)

    # ---- 46-50. slice 8: config 4, the aggregates, the radix sort, the CSR build ---
    launches4 = config4_phases(card, repo_root, same)

    # ---- 51-54. slice 9: the distributed tier at config 5 ---------------------------
    launches9 = dist_phases(card, repo_root, max_err)

    # ---- 55. the emission (#19) at config 1's shape and over three levels ------------
    emitted = emit_phase(card, same, *config1)
    launches["emit_rows_i32"] = emitted["launches"]
    kernel_ms["emit_rows_i32"] = emitted["ms"][:2]
    work["emit_rows_i32"] = emitted["work"]

    sources = {
        "sort_runs_narrowed": ("ccve_tpu_torch/kernels/csrc/sort_tiles.cu",
                               "ccve_tpu/kernels/bigsort.py:94"),
        "sort_tiles_i32": ("ccve_tpu_torch/kernels/csrc/sort_tiles.cu",
                           "ccve_tpu/kernels/bigsort.py:94"),
        "merge_level_i32": ("ccve_tpu_torch/kernels/csrc/merge_multi.cu",
                            "ccve_tpu/kernels/bigsort.py:286"),
        "merge_counts_i32": ("ccve_tpu_torch/kernels/csrc/merge_counts.cu",
                             "ccve_tpu/kernels/merge_scan.py:548"),
        "sort_tiles_multi_i32": ("ccve_tpu_torch/kernels/csrc/sort_tiles.cu",
                                 "ccve_tpu/kernels/pairsort.py:99"),
        "merge_multi_i32": ("ccve_tpu_torch/kernels/csrc/merge_multi.cu",
                            "ccve_tpu/kernels/pairsort.py:133"),
        "merge_stats_i32": ("ccve_tpu_torch/kernels/csrc/merge_stats.cu",
                            "ccve_tpu/kernels/merge_scan.py:240"),
        "compact_i32": ("ccve_tpu_torch/kernels/csrc/compact.cu",
                        "ccve_tpu/kernels/compact.py:77"),
        "expand_candidates_i32": ("ccve_tpu_torch/kernels/csrc/candidates.cu",
                                  "none: lax.associative_scan, ccve_tpu/ops/sort_merge.py:151"),
        "sort_runs_narrowed_i64": ("ccve_tpu_torch/kernels/csrc/sort_tiles.cu",
                                   "ccve_tpu/kernels/pairsort.py:563"),
        "sort_tiles_i64": ("ccve_tpu_torch/kernels/csrc/sort_tiles.cu",
                           "ccve_tpu/kernels/pairsort.py:563"),
        "merge_level_i64": ("ccve_tpu_torch/kernels/csrc/merge_multi.cu",
                            "ccve_tpu/kernels/pairsort.py:592"),
        "merge_counts_i64": ("ccve_tpu_torch/kernels/csrc/merge_counts.cu",
                             "ccve_tpu/kernels/merge_scan.py:784"),
        "sort_tiles_multi_i64": ("ccve_tpu_torch/kernels/csrc/sort_tiles.cu",
                                 "ccve_tpu/kernels/pairsort.py:563"),
        "merge_multi_i64": ("ccve_tpu_torch/kernels/csrc/merge_multi.cu",
                            "ccve_tpu/kernels/pairsort.py:592"),
        "merge_stats_i64": ("ccve_tpu_torch/kernels/csrc/merge_stats.cu",
                            "ccve_tpu/kernels/merge_scan.py:47"),
        "murmurhash64_i64": ("ccve_tpu_torch/kernels/csrc/murmur.cu",
                             "ccve_tpu/kernels/murmur.py:68"),
        "drain_segment": ("ccve_tpu_torch/kernels/csrc/drain.cu",
                          "ccve_tpu/kernels/drain.py:94"),
        "drain_segment_occ": ("ccve_tpu_torch/kernels/csrc/drain.cu",
                              "ccve_tpu/kernels/drain.py:95"),
        "chunk_rank": ("ccve_tpu_torch/kernels/csrc/chunk_rank.cu",
                       "ccve_tpu/kernels/chunk_probe.py:85"),
        "merge_scan_stats_i64": ("ccve_tpu_torch/kernels/csrc/merge_stats.cu",
                                 "ccve_tpu/kernels/merge_scan.py:166"),
        "merge_scan_stats_packed_i64": ("ccve_tpu_torch/kernels/csrc/merge_stats.cu",
                                        "ccve_tpu/kernels/merge_scan.py:62"),
        "merge_scan_build_counts_i32": ("ccve_tpu_torch/kernels/csrc/dense_counts.cu",
                                        "ccve_tpu/kernels/merge_scan.py:464"),
        "merge_two_i32": ("ccve_tpu_torch/kernels/csrc/merge_multi.cu",
                          "ccve_tpu/kernels/bigsort.py:229"),
        "ce_stages_i32": ("ccve_tpu_torch/kernels/csrc/ce_stages.cu",
                          "ccve_tpu/bench/roofline.py:208"),
        "emit_rows_i32": ("ccve_tpu_torch/kernels/csrc/emit.cu",
                          "none: takes and concatenations, ccve_tpu/exec/bulk.py:342-390"),
    }
    # Slice 2's launches are those of its two main-path runs (config 3's
    # bulk_count and config 1's sorted_expand_tiled); its times are per
    # call at the materialize shapes, and per level at config 3's for the
    # stats scan, which only the stats path runs. Slice 3's are those of
    # config1_wide's bulk_count (count side) and sorted_match_stats
    # (stats side), with the times at their shapes.
    for name in NEW_WRAPPERS:
        launches[name] = launches3[name] + launches_m[name]
        kernel_ms[name] = ms_cfg3[name] if name == "merge_stats_i32" else ms_mat[name]
    for name in (*WIDE_COUNT, "sort_tiles_i64"):
        launches[name] = launches_w[name]
    for name in WIDE_STATS:
        launches[name] = launches_s[name]
    # slice 4: the hash's launches in phase 17's two bulk_count runs; the
    # compaction's on the LP drain add to its slice-2 launches
    launches["murmurhash64_i64"] = sum(lc["murmurhash64_i64"] for lc in launches_h.values())
    # slice 6: and its launches in the counted runs of the cursor executor
    # (phases 42-44: one a probe, a chunk's and each descend's)
    launches["murmurhash64_i64"] += cursor_launches
    launches["compact_i32"] += launches_h["hash_lp"]["compact_i32"]
    # slice 7: #10's launches in phase 24's counted runs (one a preloaded
    # run, one a segment streamed)
    launches["drain_segment"] = sum(lc["drain_segment"] for lc in launches_c3.values())
    # slice 7b: #11's launches in phase 31's counted chunk-mode runs, the
    # occupancy variant's in phase 32's counted fused runs
    launches["chunk_rank"] = sum(launches_cr.values())
    launches["drain_segment_occ"] = sum(launches_occ.values())
    # slice 3b: #15's generic entry in phase 36's counted bulk_count, #5 and
    # #4 in phase 37's counted small-probe calls, #16 (on no path) in phase
    # 38's counted call of the packed totals
    launches.update(launches_3b)
    # slice 8: config 4's counted query and histogram (phase 46) launch the
    # count side (#1-#3) and #12
    for name, k in launches4.items():
        launches[name] += k
    # slice 9: the distributed plans' counted runs, one a plan (phases 51-52
    # on one rank; phase 53's summed over its ranks) launch #6-#9 and #12
    for name, k in launches9.items():
        launches[name] += k
    entries = []
    for name in sources:
        bound_ms, bound_by = bound(*work[name])
        entries.append({
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": kernel_ms[name][0],
            "plain_ms": kernel_ms[name][1],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": (kernel_ms[name][1] if name in LIBRARY_IS_PLAIN
                           else kernel_ms[name][2] if len(kernel_ms[name]) > 2 else None),
        })
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
