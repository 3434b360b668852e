"""Query kind `count`: the N-way chained join's output row count and each
level's payload checksum, through `ccve_tpu_torch.exec.bulk.bulk_count`
over one `SortedTable` a level, without materializing the output.

The harness calls `prepare` in set-up and `call` once a query; the answer
read is the harness's own. `least_bytes` is the yardstick of the rooflines:
each input byte once, at the width handed over, plus the answer.
"""

from __future__ import annotations

import torch


def prepare(build: list, device):
    """The port's tables, one a level, built by its own `build_sorted`
    from the host copies of the benchmark's columns."""
    from ccve_tpu_torch.ops.sort_merge import build_sorted

    return [build_sorted(keys.cpu().numpy(), payloads.cpu().numpy(), device=device)
            for keys, payloads in build]


def call(tables, probe: torch.Tensor) -> dict:
    from ccve_tpu_torch.exec import bulk

    result = bulk.bulk_count(tables, probe)
    return {"count": result.count, "payload_checksums": result.payload_checksums}


def least_bytes(build: list, probe: torch.Tensor) -> int:
    """The bytes one query cannot do without: the probe batch, every build
    table's keys and payloads, and the answer (an int64 count and one
    int64 checksum a level)."""
    table_bytes = sum(k.numel() * k.element_size() + p.numel() * p.element_size()
                      for k, p in build)
    answer_bytes = 8 * (1 + len(build))
    return probe.numel() * probe.element_size() + table_bytes + answer_bytes
