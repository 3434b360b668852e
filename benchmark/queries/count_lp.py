"""Query kind `count_lp`: the N-way chained join's output row count and
each level's payload checksum, through `ccve_tpu_torch.exec.bulk.bulk_count`
over one `LPTable` a level (the source's linear-probing hash table), so
that each level drains its probe column through `lp_match_stats`: #12's
hash, step 0 at full width, the compaction ladder of #9 and the tail.

The answer is query kind `count`'s, and so is the yardstick of the
rooflines, `least_bytes`: the probe batch, the build rows' keys and
payloads once each, and the answer, whatever the table's slots hold.
"""

from __future__ import annotations

import torch

from benchmark.manifest import plugin

least_bytes = plugin("queries", "count").least_bytes


def prepare(build: list, device):
    """The port's tables, one a level, built by its own `build_lp` from
    the host copies of the benchmark's columns."""
    from ccve_tpu_torch.ops.hash_table import build_lp

    return [build_lp(keys.cpu().numpy(), payloads.cpu().numpy(), device=device)
            for keys, payloads in build]


def call(tables, probe: torch.Tensor) -> dict:
    from ccve_tpu_torch.exec import bulk

    result = bulk.bulk_count(tables, probe)
    return {"count": result.count, "payload_checksums": result.payload_checksums}
