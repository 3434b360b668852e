"""Engine configuration carried from `ccve_tpu.config`: the compaction
strategy, the payload mode and `EngineConfig`, with every field and check.

`EngineConfig` keeps the JAX package's `block_size % 128` check, so that one
configuration is valid in both packages and the parity tests can hand the
same one to each.
"""

from __future__ import annotations

import dataclasses
import enum


class CompactionStrategy(enum.Enum):
    """Chunk-compaction strategy for under-filled selection vectors
    (the reference's setting.h:17-29):

    - NONE:    chunks flow downstream as-is (no compaction).
    - FULL:    always merge under-filled chunks into a cached chunk, emit
               only full chunks (NaiveCompactor, compactor.cpp:5-41).
    - BINARY:  compact only when count < block_size // 2.
    - DYNAMIC: compact when count < threshold, the threshold chosen per
               pipeline level by a bandit tuner (negative_feedback.hpp).
    """

    NONE = "no_compaction"
    FULL = "full_compaction"
    BINARY = "binary_compaction"
    DYNAMIC = "dynamic_compaction"


class PayloadMode(enum.Enum):
    """What the join emits for the build side.

    REFERENCE: bit-parity with the reference's observable output. The
      reference discards build payloads (only the key is inserted into the
      bucket, chaining_ht.cpp:34, linear_probing_ht.cpp:35) and 'gathers' the
      matched key as the payload (chaining_ht.cpp:132); the first RHS output
      column is never written and stays 0. So each join level contributes
      columns (0, matched_key).
    FULL: the meaningful extension — the hash table stores real payloads
      (payload = row_index + 10_000_000, chaining_ht.cpp:21) and each level
      contributes (matched_key, matched_payload).
    """

    REFERENCE = "reference"
    FULL = "full"


# Threshold arms for the DYNAMIC strategy's bandit
# (negative_feedback.hpp:172).
DEFAULT_THRESHOLD_ARMS = (0, 32, 64, 128, 256, 384, 512, 768, 1024)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """All engine knobs, with the JAX package's defaults (base.h:37-51,
    except `block_size`, 2048 rows a chunk)."""

    # Rows per chunk (base.h:42); a multiple of 128.
    block_size: int = 2048

    # Query setting (base.h:48-51).
    n_joins: int = 3
    lhs_size: int = 20_000_000
    rhs_size: int = 2_000_000
    chunk_factor: int = 1

    # Micro-bench knob (base.h:42-45).
    hit_freq: int = 1

    strategy: CompactionStrategy = CompactionStrategy.NONE
    payload_mode: PayloadMode = PayloadMode.REFERENCE

    # Whether the result collector materializes joined tuples
    # (setting.h:31 `flag_collect_tuples`).
    collect_tuples: bool = False

    # Per-level emitted-chunk occupancy histograms (the Zebra profiler's
    # data, profiler.h:170-260).
    record_occupancy: bool = False

    # Skip a level's deeper subtree when a drain step emits nothing.
    branchy_descend: bool = True

    # DYNAMIC-strategy bandit arms (negative_feedback.hpp:172).
    threshold_arms: tuple = DEFAULT_THRESHOLD_ARMS

    # Per-LEVEL static compaction thresholds (len == n_joins); FULL and
    # BINARY use them instead of the uniform threshold, and a level with
    # threshold 0 passes every chunk through.
    compact_threshold_per_level: tuple | None = None

    # DYNAMIC tuner knobs: the device bandit instead of the host one, the
    # segment each arm choice holds for, the device bandit's warm start
    # and early commit (control/device_bandit.py).
    device_tuner: bool = False
    tuner_segment_chunks: int = 64
    bandit_start_sampling: int = 2
    bandit_commit_after: int = 8

    def __post_init__(self):
        if self.block_size % 128 != 0:
            raise ValueError(
                f"block_size must be a multiple of 128 (got {self.block_size})"
            )
        if self.n_joins < 1:
            raise ValueError("n_joins must be >= 1")
        if self.chunk_factor < 1:
            raise ValueError("chunk_factor must be >= 1")
        if self.compact_threshold_per_level is not None:
            t = self.compact_threshold_per_level
            if len(t) != self.n_joins:
                raise ValueError(
                    "compact_threshold_per_level needs one entry per join"
                    f" level (got {len(t)}, n_joins={self.n_joins})"
                )
            if self.strategy in (
                CompactionStrategy.NONE,
                CompactionStrategy.DYNAMIC,
            ):
                raise ValueError(
                    "compact_threshold_per_level applies to static"
                    " compacting strategies (FULL/BINARY) only"
                )

    @property
    def resolved_threshold_arms(self) -> tuple:
        """Bandit arms scaled to the block size: the default arm list tops
        out at 1024, so for a larger block the same fractions are taken of
        the block; custom arm tuples pass verbatim."""
        if self.threshold_arms != DEFAULT_THRESHOLD_ARMS:
            return self.threshold_arms
        if self.block_size <= 1024:
            return self.threshold_arms
        b = self.block_size
        return (
            0, b // 32, b // 16, b // 8, b // 4, 3 * b // 8, b // 2,
            3 * b // 4, b,
        )

    @property
    def compact_threshold(self) -> int:
        """Static compaction threshold for non-DYNAMIC strategies: a chunk
        with count < threshold gets compacted into the cache."""
        if self.strategy is CompactionStrategy.NONE:
            return 0
        if self.strategy is CompactionStrategy.FULL:
            return self.block_size
        if self.strategy is CompactionStrategy.BINARY:
            return self.block_size // 2
        raise ValueError("DYNAMIC threshold comes from the tuner, not config")
