"""Plain reference of query kind `count`, in PyTorch, on any device.

The source's N-way chained equi-join: level l joins probe column l
against build table l, so a probe row that matches m_l build rows at
every level l emits the product of its m_l output rows, and level l's
checksum is the sum of level l's matched build payload over those output
rows:

    count       = sum_i  prod_l m_l(i)
    checksum_l  = sum_i  s_l(i) * prod_{k != l} m_k(i)

where s_l(i) is the sum of the payloads of the m_l(i) matches. For each
probe key, its matches are the range of equal keys in the build keys
sorted: `searchsorted` left and right give the range, and the difference
of two prefix sums over the payloads in that order gives s_l(i).

`acc` is the type every count, product and sum is kept in: int64 holds
the answer exactly; the control keeps them in int32, the nearest type
below, where they wrap. It imports nothing of the program and reads only
the benchmark's own columns.
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 22  # probe rows a block, so that the reference fits beside the pool


def _levels(build: list, acc: torch.dtype):
    """Per level: (build keys sorted, prefix sums of their payloads)."""
    out = []
    for keys, payloads in build:
        order = torch.argsort(keys.to(torch.int64), stable=True)
        sorted_keys = keys.to(torch.int64)[order]
        prefix = torch.zeros(keys.numel() + 1, dtype=acc, device=keys.device)
        prefix[1:] = torch.cumsum(payloads[order].to(acc), 0, dtype=acc)
        out.append((sorted_keys, prefix))
    return out


def answer(build: list, probe: torch.Tensor, acc: torch.dtype = torch.int64) -> dict:
    """{"count": acc scalar, "payload_checksums": acc[levels]} of `probe`
    ([rows, levels]) against `build` ([(keys, payloads)], one a level)."""
    levels = _levels(build, acc)
    count = torch.zeros((), dtype=acc, device=probe.device)
    checksums = torch.zeros(len(levels), dtype=acc, device=probe.device)
    for lo_row in range(0, probe.shape[0], BLOCK_ROWS):
        block = probe[lo_row : lo_row + BLOCK_ROWS]
        mults, sums = [], []
        for level, (sorted_keys, prefix) in enumerate(levels):
            col = block[:, level].to(torch.int64).contiguous()
            lo = torch.searchsorted(sorted_keys, col, right=False)
            hi = torch.searchsorted(sorted_keys, col, right=True)
            mults.append((hi - lo).to(acc))
            sums.append(prefix[hi] - prefix[lo])
        rows = mults[0]
        for m in mults[1:]:
            rows = rows * m
        count += rows.sum(dtype=acc)
        for level, s in enumerate(sums):
            others = torch.ones_like(s)
            for k, m in enumerate(mults):
                if k != level:
                    others = others * m
            checksums[level] += (s * others).sum(dtype=acc)
    return {"count": count, "payload_checksums": checksums}
