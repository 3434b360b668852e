"""Sorted-chunk executor: chunk-at-a-time N-way join over sorted tables.

Port of `ccve_tpu.exec.sorted_pipeline.SortedPipeline` in its batched rank
mode:

 - each level's build side is a `SortedTable`; a probe row's rank at a
   level, (mult, start) = its match count and first matching row, depends
   only on its key, not on the chunk it rides in. So each segment of chunks
   gets its ranks for every level from one `sorted_match_ranks` pass per
   distinct table over the flat S·block key stream (kernels #6-#8 on the
   card), carried as int64 rank columns `mult << 32 | start` that ride the
   chunk stream, the compactor caches and the flush like data columns;
 - the drain over drain ranks t = 0..max_mult-1 replays the reference's
   emission structure (main.cpp:150-161): step t emits the rows with more
   than t matches, then compaction, then the descend; the emitted multiset
   equals `exec.oracle.oracle_pipeline`'s.

Two routes run the drain:

 - the fused drain (count-only runs with at most 64 drain paths and a
   block of 128 or more, as the JAX gate): `_seg_mults` gives the mult
   planes, and `kernels.drain.drain_segment` walks the whole segment, with
   the caches' mult planes carried, in one launch on the card (#10), or
   through its plain twin on the CPU. A preloaded static run is one
   segment, so one launch;
 - the torch drain (`use_kernel=False`, or collecting tuples): `_run_tree`
   per chunk in torch ops, Python loops for JAX's `fori_loop` and `cond`,
   the counts as host ints (so it reads one back a step on the card).

The end-of-stream flush runs the torch drain on the flushed caches on both
routes. The fused route keeps only mult planes in its caches and writes
them back as `mult << 32` into the caches' rank columns: the flush reads
mult there (and start only when collecting, which the fused route never
does), so the caches' key columns may be stale.

Rows inside emitted chunks come in input order per drain rank, not per
bucket chain: invisible in the result multiset the reference checks.

Not ported: `rank_mode="chunk"` (kernel #11) and the DYNAMIC tuners,
ROADMAP Queue 1, slice 7b; they raise `NotImplementedError`. Removed:
`interpret` (Pallas interpret mode); the CPU runs the twin instead.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.core.chunk import Chunk, compact_rows, iota_sel
from ccve_tpu_torch.exec.pipeline import TUNER_SLICE, JoinPipeline, PipelineState
from ccve_tpu_torch.kernels.drain import MAX_PATHS, drain_segment
from ccve_tpu_torch.ops import compactor as comp
from ccve_tpu_torch.ops.sort_merge import SortedTable, rank_table, sorted_match_ranks

_LOW32 = 0xFFFFFFFF


class SortedPipeline(JoinPipeline):
    """Chunk-at-a-time N-way join over per-level sorted tables, batched
    rank mode (see the module docstring). `use_kernel` (default True)
    picks the fused drain where it applies and the stats side's kernel
    route for the ranks; False asks for the torch drain and the generic
    ranks."""

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
        if rank_mode == "chunk":
            raise NotImplementedError(
                f"rank_mode='chunk' (kernel #11, the per-chunk rank): {TUNER_SLICE}")
        if rank_mode != "batched":
            raise ValueError(f"unknown rank_mode {rank_mode!r}")
        super().__init__(tables, config, result_capacity=result_capacity,
                         prefilter=prefilter, prefilter_col=prefilter_col)
        self.use_kernel = use_kernel
        self._fanout = [max(t.max_mult, 1) for t in self.tables]
        # levels that share one table object (configs 3 and 7 join the same
        # table at every level) share one rank pass over their key streams
        self._groups: dict[int, list[int]] = {}
        for level, t in enumerate(self.tables):
            self._groups.setdefault(id(t), []).append(level)
        self._rank_tables = {key: rank_table(self.tables[lv[0]])
                             for key, lv in self._groups.items()}
        # one int64 rank column per level, past the result columns
        self._rank_col0 = self.width
        self.width += self.n_levels
        paths = 1
        for f in self._fanout[:-1]:
            paths *= f
        self._fused_drain_ok = (
            self.capacity == 0 and use_kernel and paths <= MAX_PATHS
            and config.block_size >= 128
        )

    # ------------------------------------------------------------------

    def _seg_rank_pass(self, chunk_cols: torch.Tensor):
        """Yields (levels, mult int32[len(levels), S, B], start) of each
        group of levels sharing a table: one `sorted_match_ranks` over their
        concatenated key streams."""
        S, _, B = chunk_cols.shape
        for key, lvls in self._groups.items():
            flat = chunk_cols[:, lvls, :].transpose(0, 1).reshape(-1)
            mult, start = sorted_match_ranks(self._rank_tables[key], flat,
                                             use_kernel=self.use_kernel)
            yield lvls, mult.reshape(len(lvls), S, B), start.reshape(len(lvls), S, B)

    def _seg_mults(self, chunk_cols: torch.Tensor) -> torch.Tensor:
        """Mult planes int32[S, n_levels, block] for the fused drain (no
        rank pack: the kernel reads only mult)."""
        S, _, B = chunk_cols.shape
        out = torch.empty((S, self.n_levels, B), dtype=torch.int32, device=chunk_cols.device)
        for lvls, mult, _ in self._seg_rank_pass(chunk_cols):
            out[:, lvls, :] = mult.transpose(0, 1)
        return out

    def _seg_ranks(self, chunk_cols: torch.Tensor) -> torch.Tensor:
        """Rank columns int64[S, n_levels, block], rank = mult << 32 | start
        (start indexes the sorted table). Lanes past a chunk's count get
        garbage ranks; `_run_tree` masks mult with the live lanes."""
        S, _, B = chunk_cols.shape
        out = torch.empty((S, self.n_levels, B), dtype=torch.int64, device=chunk_cols.device)
        for lvls, mult, start in self._seg_rank_pass(chunk_cols):
            rank = (mult.to(torch.int64) << 32) | start.to(torch.int64)
            out[:, lvls, :] = rank.transpose(0, 1)
        return out

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
        (the reference's ExecutePipeline recursion, main.cpp:119-170)."""
        cfg = self.config
        block, L = self.block, self.n_levels
        valid = torch.arange(block, device=cols.device) < count
        if valid_extra is not None:
            valid = valid & valid_extra
        rank = cols[self._rank_col0 + level]
        mult = torch.where(valid, rank >> 32, 0)
        if level == L - 1 and self.capacity == 0:
            # the count collapse: the collector reads only counts, and
            # Σ_t |{mult > t}| = Σ mult; the last level's compaction cannot
            # change a count over stream and flush
            return pstate._replace(result_count=pstate.result_count + mult.sum())
        ca = cfg.n_joins + 2 * level
        if self.capacity > 0:
            cols = cols.clone()
            # REFERENCE: (0, matched key); FULL: (matched key, payload)
            cols[ca + 1 if cfg.payload_mode is PayloadMode.REFERENCE else ca] = cols[level]
        table = self.tables[level]
        last_row = max(table.keys.numel(), 1) - 1
        start = rank & _LOW32
        threshold = int(thresholds[level])
        for t in range(self._fanout[level]):
            cols_t = cols
            if self.capacity > 0 and cfg.payload_mode is PayloadMode.FULL:
                cols_t = cols.clone()
                cols_t[ca + 1] = table.payloads[(start + t).clamp(0, last_row)]
            dense, cnt = compact_rows(cols_t, mult > t)
            chunk = Chunk(dense, iota_sel(block, dense.device), cnt)
            if cnt >= threshold or cnt >= block:
                emitted = chunk  # pass-through: the compactor is not run
            else:
                emitted, pstate = self._compact(pstate, level, chunk, threshold)
            if level == L - 1:
                pstate = self._collect(pstate, emitted)
            elif emitted.count > 0 or not cfg.branchy_descend:
                pstate = self._run_tree(level + 1, emitted.cols, emitted.count, pstate,
                                        thresholds)
        return pstate

    def _one_chunk(self, pstate, cols, count: int, thresholds, ranks) -> PipelineState:
        """One input chunk (cols int64[n_joins, block], ranks
        int64[n_levels, block]) through the level recursion."""
        padded = torch.zeros((self.width, self.block), dtype=torch.int64, device=cols.device)
        padded[: self.config.n_joins] = cols
        padded[self._rank_col0 : self._rank_col0 + self.n_levels] = ranks
        extra = None
        if self.prefilter is not None:
            extra = self.prefilter(cols[self.prefilter_col])
        return self._run_tree(0, padded, count, pstate, thresholds, extra)

    # ------------------------------------------------------------------
    # Segments
    # ------------------------------------------------------------------

    def _scan_chunks_fused(self, pstate, chunk_cols, chunk_counts, thresholds):
        """The fused drain: the segment's mult planes, then its whole
        chunk-at-a-time level recursion in one `drain_segment`, with the
        caches' mult planes carried in and out."""
        L = self.n_levels
        mults = self._seg_mults(chunk_cols)
        if self.prefilter is not None:
            keep0 = self.prefilter(chunk_cols[:, self.prefilter_col, :])
            mults[:, 0, :] = torch.where(keep0, mults[:, 0, :], 0)
        CL = max(L - 1, 1)
        c0 = self._rank_col0
        cache_m = (pstate.cache_cols[:CL, c0 : c0 + L, :] >> 32).to(torch.int32)
        total, cache_o, ccnt_o, _, _ = drain_segment(
            mults, chunk_counts.to(torch.int32),
            torch.as_tensor(thresholds, dtype=torch.int32, device=mults.device),
            cache_m, pstate.cache_count[:CL].contiguous(),
            block=self.block, fanouts=tuple(self._fanout),
        )
        cache_cols = pstate.cache_cols.clone()
        cache_cols[:CL, c0 : c0 + L, :] = cache_o.to(torch.int64) << 32
        cache_count = pstate.cache_count.clone()
        cache_count[:CL] = ccnt_o
        return pstate._replace(result_count=pstate.result_count + total,
                               cache_cols=cache_cols, cache_count=cache_count)

    def _process_chunks(self, pstate, chunk_cols, chunk_counts, thresholds):
        """One segment: chunk_cols int64[S, n_joins, block], chunk_counts
        int32[S], `thresholds` a host int32[n_levels]."""
        if self._fused_drain_ok:
            return self._scan_chunks_fused(pstate, chunk_cols, chunk_counts, thresholds)
        seg_ranks = self._seg_ranks(chunk_cols)
        for s, count in enumerate(chunk_counts.tolist()):
            pstate = self._one_chunk(pstate, chunk_cols[s], count, thresholds, seg_ranks[s])
        return pstate

    def _flush_all(self, pstate, thresholds):
        """FlushPipelineCache (main.cpp:172-191), in level order: level l's
        cache goes into level l + 1, so refilled deeper caches flush in
        later iterations."""
        for level in range(self.n_levels):
            flushed = comp.flush(comp.CompactorState(
                pstate.cache_cols[level], int(pstate.cache_count[level])))[0]
            cache_count = pstate.cache_count.clone()
            cache_count[level] = 0
            pstate = pstate._replace(cache_count=cache_count)
            if flushed.count == 0:
                continue
            if level + 1 == self.n_levels:
                pstate = self._collect(pstate, flushed)
            else:
                pstate = self._run_tree(level + 1, flushed.cols, flushed.count, pstate,
                                        thresholds)
        return pstate
