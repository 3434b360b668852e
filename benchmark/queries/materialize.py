"""Query kind `materialize`: every output row of the one-level join,
(probe key, build key, build payload), through
`ccve_tpu_torch.exec.bulk.bulk_materialize` over one `SortedTable`, then
the reference module's order-free `digest` of those rows, on the card,
inside the query. The digest is the benchmark's work, the same for every
version of the port, and it reads every row the port wrote, so no change
to the port can leave a row unwritten.

The harness calls `prepare` in set-up and `call` once a query; the answer
read is the harness's own. `least_bytes` is the yardstick of the rooflines:
each input byte once, at the width handed over, each output row's bytes
once, plus the answer.
"""

from __future__ import annotations

import torch

from benchmark.manifest import plugin

reference = plugin("reference", "materialize")

ROW_BYTES = 3 * 8  # an output row: three int64 columns
ANSWER_BYTES = 5 * 8  # the count, three column sums and the row hash, int64


def prepare(build: list, device):
    """The port's table, built by its own `build_sorted` from the host
    copies of the benchmark's columns."""
    from ccve_tpu_torch.ops.sort_merge import build_sorted

    return [build_sorted(keys.cpu().numpy(), payloads.cpu().numpy(), device=device)
            for keys, payloads in build]


def call(tables, probe: torch.Tensor) -> dict:
    from ccve_tpu_torch.config import PayloadMode
    from ccve_tpu_torch.exec import bulk

    return reference.digest(bulk.bulk_materialize(tables, probe, PayloadMode.FULL))


def least_bytes(build: list, probe: torch.Tensor) -> int:
    """The bytes one query cannot do without: the probe batch, the build
    table's keys and payloads, the batch's output rows written once, and
    the answer."""
    table_bytes = sum(k.numel() * k.element_size() + p.numel() * p.element_size()
                      for k, p in build)
    return (probe.numel() * probe.element_size() + table_bytes
            + reference.output_rows(build, probe) * ROW_BYTES + ANSWER_BYTES)
