"""Engine configuration carried from `ccve_tpu.config`: the payload mode.

The JAX package's `CompactionStrategy` and `EngineConfig` wait for the
chunk-at-a-time executors (ROADMAP Queue 1, slices 4, 6, 7).
"""

from __future__ import annotations

import enum


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
