"""Sorted-chunk executor: chunk-at-a-time N-way join over sorted tables.

Port of `ccve_tpu.exec.sorted_pipeline.SortedPipeline`:

 - each level's build side is a `SortedTable`; a probe row's rank at a
   level, (mult, start) = its match count and first matching row, depends
   only on its key, not on the chunk it rides in. In the batched rank mode
   (the default) each segment of chunks gets its ranks for every level from
   one `sorted_match_ranks` pass per distinct table over the flat S·block
   key stream (kernels #6-#8 on the card), carried as int64 rank columns
   `mult << 32 | start` that ride the chunk stream, the compactor caches and
   the flush like data columns. In the chunk rank mode every (chunk, level)
   gets its ranks when the chunk arrives there, from
   `kernels.chunk_probe.chunk_rank` (kernel #11 on a CUDA table, its plain
   twin with `use_kernel=False` or on the CPU): nothing is computed ahead;
 - the drain over drain ranks t = 0..max_mult-1 replays the reference's
   emission structure (main.cpp:150-161): step t emits the rows with more
   than t matches, then compaction, then the descend; the emitted multiset
   equals `exec.oracle.oracle_pipeline`'s.

Two routes run the drain:

 - the fused drain (count-only runs in batched mode with at most 64 drain
   paths and a block of 128 or more, as the JAX gate): `_seg_mults` gives
   the mult planes, and `kernels.drain.drain_segment` walks the whole
   segment, with the caches' mult planes carried, in one launch on the card
   (#10, its occupancy variant under `record_occupancy`), or through its
   plain twin on the CPU. Thresholds go to it as a device tensor, so the
   device tuner's arms need no host read. A preloaded static run is one
   segment, so one launch;
 - the torch drain (`use_kernel=False`, collecting tuples, or chunk rank
   mode): `_run_tree` per chunk in torch ops, Python loops for JAX's
   `fori_loop` and `cond`, the counts as host ints (so it reads one back a
   step on the card, and reads tuner thresholds on the host).

Each route keeps JAX's work counters for the device tuner (`level_steps`,
`level_rows`, under DYNAMIC) and its Zebra histograms (`occupancy`, under
`record_occupancy`), route for route: the fused drain counts as JAX's
kernel does, the torch drain as JAX's XLA drain does, and the two differ
from three levels on (the kernel walks empty subtrees).

The end-of-stream flush runs the torch drain on the flushed caches on both
routes. The fused route keeps only mult planes in its caches and writes
them back as `mult << 32` into the caches' rank columns: the flush reads
mult there (and start only when collecting, which the fused route never
does), so the caches' key columns may be stale. Under `record_occupancy`
the last level's cache is count-only on the fused route: its flush is a
count.

Rows inside emitted chunks come in input order per drain rank, not per
bucket chain: invisible in the result multiset the reference checks.

Removed: `interpret` (Pallas interpret mode; the CPU runs the twins
instead); in chunk mode, the JAX package's int32 packing (clamped keys,
I32_MAX sentinels) and its per-level gate (`_MAX_KEY_BITS`,
`_MAX_VMEM_ENTRIES`, `stage_table_planes`): the CUDA kernel takes int64
keys and any table size, so no level falls back.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ccve_tpu_torch.config import CompactionStrategy, PayloadMode
from ccve_tpu_torch.core.chunk import Chunk, compact_rows, make_dense
from ccve_tpu_torch.exec.pipeline import JoinPipeline, PipelineState
from ccve_tpu_torch.kernels.chunk_probe import chunk_rank, chunk_rank_plain
from ccve_tpu_torch.kernels.drain import MAX_PATHS, drain_segment
from ccve_tpu_torch.ops import compactor as comp
from ccve_tpu_torch.ops.sort_merge import SortedTable, rank_table, sorted_match_ranks

_LOW32 = 0xFFFFFFFF


class SortedPipeline(JoinPipeline):
    """Chunk-at-a-time N-way join over per-level sorted tables (see the
    module docstring). `use_kernel` (default True) picks the fused drain
    where it applies, the stats side's kernel route for the batched ranks
    and kernel #11 for the chunk ranks; False asks for the torch drain, the
    generic ranks and #11's plain twin. `rank_mode` is "batched" (the
    default) or "chunk"."""

    def __init__(
        self,
        tables: Sequence[SortedTable],
        config,
        result_capacity: int | None = None,
        prefilter=None,
        prefilter_col: int = 0,
        use_kernel: bool = True,
        rank_mode: str = "batched",
    ):
        for t in tables:
            if not isinstance(t, SortedTable):
                raise TypeError("SortedPipeline needs SortedTable levels")
        if rank_mode not in ("batched", "chunk"):
            raise ValueError(f"unknown rank_mode {rank_mode!r}")
        super().__init__(tables, config, result_capacity=result_capacity,
                         prefilter=prefilter, prefilter_col=prefilter_col)
        self.use_kernel = use_kernel
        self.rank_mode = rank_mode
        self._fanout = [max(t.max_mult, 1) for t in self.tables]
        if config.strategy is CompactionStrategy.DYNAMIC:  # the device tuner's arms
            self._arms = torch.tensor(config.resolved_threshold_arms, dtype=torch.int32,
                                      device=self.device)
        if rank_mode == "batched":
            # levels that share one table object (configs 3 and 7 join the
            # same table at every level) share one rank pass over their keys
            groups: dict[int, list[int]] = {}
            for level, t in enumerate(self.tables):
                groups.setdefault(id(t), []).append(level)
            self._rank_tables = {key: rank_table(self.tables[lv[0]])
                                 for key, lv in groups.items()}
            # each group's levels as an index made once: a slice where they
            # run in a row, else a tensor on the device (a list index would
            # copy to the card, and wait for it, every segment)
            self._groups = {
                key: (lv, slice(lv[0], lv[-1] + 1) if lv == list(range(lv[0], lv[-1] + 1))
                      else torch.tensor(lv, device=self.device))
                for key, lv in groups.items()
            }
            # one int64 rank column per level, past the result columns
            self._rank_col0 = self.width
            self.width += self.n_levels
        paths = 1
        for f in self._fanout[:-1]:
            paths *= f
        self._fused_drain_ok = (
            rank_mode == "batched" and self.capacity == 0 and use_kernel
            and paths <= MAX_PATHS and config.block_size >= 128
        )

    # ------------------------------------------------------------------

    def _seg_rank_pass(self, chunk_cols: torch.Tensor):
        """Yields (the levels' index, mult int32[len(levels), S, B], start)
        of each group of levels sharing a table: one `sorted_match_ranks`
        over their concatenated key streams."""
        S, _, B = chunk_cols.shape
        for key, (lvls, index) in self._groups.items():
            flat = chunk_cols[:, index, :].transpose(0, 1).reshape(-1)
            mult, start = sorted_match_ranks(self._rank_tables[key], flat,
                                             use_kernel=self.use_kernel)
            yield index, mult.reshape(len(lvls), S, B), start.reshape(len(lvls), S, B)

    def _seg_mults(self, chunk_cols: torch.Tensor) -> torch.Tensor:
        """Mult planes int32[S, n_levels, block] for the fused drain (no
        rank pack: the kernel reads only mult)."""
        S, _, B = chunk_cols.shape
        out = torch.empty((S, self.n_levels, B), dtype=torch.int32, device=chunk_cols.device)
        for index, mult, _ in self._seg_rank_pass(chunk_cols):
            out[:, index, :] = mult.transpose(0, 1)
        return out

    def _seg_ranks(self, chunk_cols: torch.Tensor) -> torch.Tensor:
        """Rank columns int64[S, n_levels, block], rank = mult << 32 | start
        (start indexes the sorted table). Lanes past a chunk's count get
        garbage ranks; `_run_tree` masks mult with the live lanes."""
        S, _, B = chunk_cols.shape
        out = torch.empty((S, self.n_levels, B), dtype=torch.int64, device=chunk_cols.device)
        for index, mult, start in self._seg_rank_pass(chunk_cols):
            rank = (mult.to(torch.int64) << 32) | start.to(torch.int64)
            out[:, index, :] = rank.transpose(0, 1)
        return out

    def _level_rank(self, level: int, keys: torch.Tensor, valid: torch.Tensor):
        """Chunk mode: (mult, start) int32[block] of one chunk at one level."""
        rank = chunk_rank if self.use_kernel else chunk_rank_plain
        return rank(self.tables[level].keys, keys.contiguous(), valid.contiguous())

    # ------------------------------------------------------------------
    # The torch drain
    # ------------------------------------------------------------------

    def _compact(self, pstate: PipelineState, level: int, chunk: Chunk, threshold: int):
        cache = comp.CompactorState(pstate.cache_cols[level], int(pstate.cache_count[level]))
        emitted, new = comp.compact(cache, chunk, threshold, chunk_dense=True)
        cache_cols = pstate.cache_cols.clone()
        cache_cols[level] = new.cache_cols
        cache_count = pstate.cache_count.clone()
        cache_count[level] = new.cache_count
        return emitted, pstate._replace(cache_cols=cache_cols, cache_count=cache_count)

    def _run_tree(self, level: int, cols, count: int, pstate: PipelineState, thresholds,
                  valid_extra=None) -> PipelineState:
        """A dense chunk (cols int64[W, block], `count` live rows) at
        `level`: drain its matches, compact, and recurse into deeper levels
        (the reference's ExecutePipeline recursion, main.cpp:119-170). The
        work counters and the histogram are written in place."""
        cfg = self.config
        block, L = self.block, self.n_levels
        valid = torch.arange(block, device=cols.device) < count
        if valid_extra is not None:
            valid = valid & valid_extra
        if self.rank_mode == "batched":
            rank = cols[self._rank_col0 + level]
            mult = torch.where(valid, rank >> 32, 0)
            start = rank & _LOW32
        else:
            mult, start = self._level_rank(level, cols[level], valid)
        if level == L - 1 and self.capacity == 0 and not cfg.record_occupancy:
            # the count collapse: the collector reads only counts, and
            # Σ_t |{mult > t}| = Σ mult; the last level's compaction cannot
            # change a count over stream and flush (it applies under DYNAMIC
            # too, where the last level's arm then steers nothing)
            return pstate._replace(result_count=pstate.result_count + mult.sum(dtype=torch.int64))
        ca = cfg.n_joins + 2 * level
        if self.capacity > 0:
            cols = cols.clone()
            # REFERENCE: (0, matched key); FULL: (matched key, payload)
            cols[ca + 1 if cfg.payload_mode is PayloadMode.REFERENCE else ca] = cols[level]
        table = self.tables[level]
        last_row = max(table.keys.numel(), 1) - 1
        dynamic = cfg.strategy is CompactionStrategy.DYNAMIC
        per_level = cfg.compact_threshold_per_level
        # threshold 0 by strategy or by level: the compactor never runs
        skip = cfg.strategy is CompactionStrategy.NONE or (
            per_level is not None and per_level[level] == 0)
        threshold = int(thresholds[level])
        for t in range(self._fanout[level]):
            cols_t = cols
            if self.capacity > 0 and cfg.payload_mode is PayloadMode.FULL:
                cols_t = cols.clone()
                cols_t[ca + 1] = table.payloads[(start.long() + t).clamp(0, last_row)]
            dense, cnt = compact_rows(cols_t, mult > t)
            chunk = make_dense(dense, cnt)
            passthrough = cnt >= threshold or cnt >= block
            if skip or passthrough:
                emitted = chunk  # the compactor is not run
            else:
                emitted, pstate = self._compact(pstate, level, chunk, threshold)
            if dynamic and not skip and not (passthrough and cfg.branchy_descend):
                # one compaction, one work unit (JAX's XLA drain runs the
                # compactor on every step unless branchy_descend skips it)
                pstate.level_steps[level] += 1
            if cfg.record_occupancy:
                pstate.occupancy[level, emitted.count] += 1
            if level == L - 1:
                pstate = self._collect(pstate, emitted)
            elif emitted.count > 0 or not cfg.branchy_descend:
                if dynamic:  # one entry into level + 1, one work unit there
                    pstate.level_steps[level + 1] += 1
                    pstate.level_rows[level + 1] += emitted.count
                pstate = self._run_tree(level + 1, emitted.cols, emitted.count, pstate,
                                        thresholds)
        return pstate

    def _one_chunk(self, pstate, cols, count: int, thresholds, ranks=None) -> PipelineState:
        """One input chunk (cols int64[n_joins, block]; in batched mode
        ranks int64[n_levels, block]) through the level recursion."""
        padded = torch.zeros((self.width, self.block), dtype=torch.int64, device=cols.device)
        padded[: self.config.n_joins] = cols
        if ranks is not None:
            padded[self._rank_col0 : self._rank_col0 + self.n_levels] = ranks
        extra = None
        if self.prefilter is not None:
            extra = self.prefilter(cols[self.prefilter_col])
        if self.config.strategy is CompactionStrategy.DYNAMIC:
            pstate.level_steps[0] += 1
            pstate.level_rows[0] += count
        return self._run_tree(0, padded, count, pstate, thresholds, extra)

    # ------------------------------------------------------------------
    # Segments
    # ------------------------------------------------------------------

    def _scan_chunks_fused(self, pstate, chunk_cols, chunk_counts, thresholds):
        """The fused drain: the segment's mult planes, then its whole
        chunk-at-a-time level recursion in one `drain_segment`, with the
        caches' mult planes carried in and out."""
        cfg = self.config
        L = self.n_levels
        mults = self._seg_mults(chunk_cols)
        if self.prefilter is not None:
            keep0 = self.prefilter(chunk_cols[:, self.prefilter_col, :])
            mults[:, 0, :] = torch.where(keep0, mults[:, 0, :], 0)
        CL = max(L - 1, 1)
        occ = cfg.record_occupancy
        CC = L if occ else CL  # the occupancy variant's last cache is count-only
        c0 = self._rank_col0
        cache_m = (pstate.cache_cols[:CL, c0 : c0 + L, :] >> 32).to(torch.int32)
        outs = drain_segment(
            mults, chunk_counts.to(torch.int32),
            torch.as_tensor(thresholds, dtype=torch.int32, device=mults.device),
            cache_m, pstate.cache_count[:CC].contiguous(),
            block=self.block, fanouts=tuple(self._fanout),
            record_occupancy=occ, branchy=cfg.branchy_descend,
        )
        total, cache_o, ccnt_o, work, rows = outs[:5]
        cache_cols = pstate.cache_cols.clone()
        cache_cols[:CL, c0 : c0 + L, :] = cache_o.to(torch.int64) << 32
        cache_count = pstate.cache_count.clone()
        cache_count[:CC] = ccnt_o
        pstate = pstate._replace(result_count=pstate.result_count + total,
                                 cache_cols=cache_cols, cache_count=cache_count)
        if occ:
            pstate.occupancy.add_(outs[5])
        if cfg.strategy is CompactionStrategy.DYNAMIC:
            pstate.level_steps.add_(work)
            pstate.level_rows.add_(rows)
        return pstate

    def _process_chunks(self, pstate, chunk_cols, chunk_counts, thresholds):
        """One segment: chunk_cols int64[S, n_joins, block], chunk_counts
        int32[S], `thresholds` int32[n_levels] on the host or the device."""
        if self._fused_drain_ok:
            return self._scan_chunks_fused(pstate, chunk_cols, chunk_counts, thresholds)
        seg_ranks = self._seg_ranks(chunk_cols) if self.rank_mode == "batched" else None
        for s, count in enumerate(chunk_counts.tolist()):
            pstate = self._one_chunk(pstate, chunk_cols[s], count, thresholds,
                                     None if seg_ranks is None else seg_ranks[s])
        return pstate

    def _process_seg_device_dynamic(self, pstate, bstate, cols_seg, counts_seg):
        """One device-tuner segment: each level's arm from the device
        bandit, the segment at those thresholds, and the reward, all on the
        device. The reward is cost-aware, as in JAX: stream efficiency =
        input rows / (block × total work units), work units from the
        segment's `level_steps` delta (level entries plus compactions), the
        same for every level (the reference's one host timer,
        main.cpp:164-167), in (0, 1] for the heartbeat's double/halve
        test."""
        from ccve_tpu_torch.control import device_bandit as db

        cfg = self.config
        arm, bstate = db.select_arms(bstate, cfg.bandit_start_sampling)
        thresholds = self._arms[arm.long()]
        steps0 = pstate.level_steps.clone()
        rows_in0 = pstate.level_rows[0].clone()
        pstate = self._process_chunks(pstate, cols_seg, counts_seg, thresholds)
        d_work = (pstate.level_steps - steps0).to(torch.float32).sum()
        d_rows_in = (pstate.level_rows[0] - rows_in0).to(torch.float32)
        eff = d_rows_in / (torch.clamp(d_work, min=1.0) * self.block)
        reward = eff.expand(self.n_levels).contiguous()
        bstate = db.update_arms(bstate, arm, reward, cfg.bandit_start_sampling,
                                cfg.bandit_commit_after)
        return pstate, bstate

    def _flush_all(self, pstate, thresholds):
        """FlushPipelineCache (main.cpp:172-191), in level order: level l's
        cache goes into level l + 1, so refilled deeper caches flush in
        later iterations. An empty cache flushes too, as in JAX: its drain
        steps count as work and are recorded in the histogram."""
        for level in range(self.n_levels):
            flushed = comp.flush(comp.CompactorState(
                pstate.cache_cols[level], int(pstate.cache_count[level])))[0]
            cache_count = pstate.cache_count.clone()
            cache_count[level] = 0
            pstate = pstate._replace(cache_count=cache_count)
            if level + 1 == self.n_levels:
                pstate = self._collect(pstate, flushed)
            else:
                pstate = self._run_tree(level + 1, flushed.cols, flushed.count, pstate,
                                        thresholds)
        return pstate
