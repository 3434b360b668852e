"""Group-by aggregates over int64 keys: count, sum, min and max a group.

Port of `ccve_tpu.ops.aggregate`. The number of groups depends on the data,
so the aggregates' results have a static length and a device-side
`n_groups`, and the aggregates read nothing back to the host.

 - `hash_aggregate`: a group-by of any keys. One stable `torch.sort` of the
   keys with the values gathered; group ids from the cumsum of the run
   starts; count and sum from the cumsum at the run ends; min and max by
   one `scatter_reduce_` each into the padded outputs. The JAX version runs
   four segmented `associative_scan`s and a second sort to move the run
   ends to the front, because XLA lowers a TPU scatter to a loop a row;
   neither has a job on the GPU.
 - `dense_aggregate`: keys in [0, domain), one scatter a stat into
   domain-sized tables (a perfect-hash aggregate).
 - `join_dense_aggregate`: the aggregate pushed below a join against a
   table of unique keys 0 .. domain - 1 (config 4): algebra over the
   count side's per-build-row probe counts (`ops.sort_merge.
   sorted_build_counts`, kernels #1-#3 on the card).
 - `partition_histogram`: keys a part of a P-way hash partition
   (`parallel.distributed._owner`, kernel #12 on the card), the
   distributed tier's skew statistic, counted on the device with no read
   back.

Sums and the stats accumulate in int64 whatever the value dtype, and wrap
as int64 arithmetic does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

I64_MAX = 2**63 - 1
I64_MIN = -(2**63)
HIST_LANES = 1024  # bins a part in `partition_histogram` (a power of two)


class GroupByResult(NamedTuple):
    """Per-group stats, `n_groups` of them at the front. Past `n_groups`
    keys, count and sum are 0, min is I64_MAX and max is I64_MIN."""

    keys: torch.Tensor  # int64[n]: group keys, ascending
    count: torch.Tensor  # int64[n]: rows a group
    sum: torch.Tensor  # int64[n]: sum of the group's values
    min: torch.Tensor  # int64[n]
    max: torch.Tensor  # int64[n]
    n_groups: torch.Tensor  # int64 0-d tensor on the keys' device


def _check(keys: torch.Tensor, values: torch.Tensor) -> None:
    if keys.dim() != 1 or values.shape != keys.shape:
        raise ValueError(f"keys and values must be 1-D of one length, got "
                         f"{tuple(keys.shape)} and {tuple(values.shape)}")
    if values.device != keys.device:
        raise ValueError(f"keys on {keys.device}, values on {values.device}")


def _group_min_max(gid: torch.Tensor, values: torch.Tensor, size: int):
    """(min, max) int64[size] of `values` by group id; I64_MAX and I64_MIN
    where a group has no row."""
    mn = values.new_full((size,), I64_MAX).scatter_reduce_(0, gid, values, "amin")
    mx = values.new_full((size,), I64_MIN).scatter_reduce_(0, gid, values, "amax")
    return mn, mx


def hash_aggregate(keys: torch.Tensor, values: torch.Tensor,
                   valid: torch.Tensor | None = None) -> GroupByResult:
    """Group-by of int64 (or int32) `keys` over `values`, sorted by key:
    arrays of length n = len(keys) with the groups at the front. Rows where
    `valid` (bool[n], default all) is False join no group: the distributed
    aggregate's empty grid slots, which no key value could mark."""
    _check(keys, values)
    n = keys.numel()
    keys = keys.to(torch.int64)
    if not n:
        empty = keys.new_zeros(0)
        return GroupByResult(empty, empty, empty, empty, empty, keys.new_zeros(()))
    sk, order = keys.sort(stable=True)
    is_start = torch.ones(n, dtype=torch.bool, device=keys.device)
    is_start[1:] = sk[1:] != sk[:-1]
    if valid is not None:
        # a second stable sort moves the left-out rows behind the rest, each
        # part still in key order; a change of validity starts a group too
        sval = valid[order]
        back = (~sval).to(torch.int8).sort(stable=True).indices
        order, sk, sval = order[back], sk[back], sval[back]
        is_start[1:] = (sk[1:] != sk[:-1]) | (sval[1:] != sval[:-1])
    sv = values.to(torch.int64)[order]
    gid = torch.cumsum(is_start, 0) - 1  # int64 group id a row
    is_end = torch.ones_like(is_start)
    is_end[:-1] = is_start[1:]
    sink = torch.full_like(gid, n)
    if valid is None:
        n_groups = gid[-1] + 1
    else:
        n_groups = (is_start & sval).sum()
        gid = torch.where(sval, gid, sink)  # left-out rows add to no group
    # run ends scatter their inclusive cumsums (and positions) to their
    # group; every other row goes to the sink at n
    at_end = torch.where(is_end, gid, sink)
    lane = torch.arange(n, device=keys.device)
    live = lane < n_groups
    ends = keys.new_zeros(n + 1).scatter_(0, at_end, lane + 1)[:n]
    csum = keys.new_zeros(n + 1).scatter_(0, at_end, torch.cumsum(sv, 0))[:n]
    count = ends - torch.cat([ends.new_zeros(1), ends[:-1]])
    total = csum - torch.cat([csum.new_zeros(1), csum[:-1]])
    group_keys = keys.new_zeros(n + 1).scatter_(0, torch.where(is_start, gid, sink), sk)[:n]
    mn, mx = _group_min_max(gid, sv, n + 1)
    return GroupByResult(
        keys=group_keys,
        count=torch.where(live, count, 0),
        sum=torch.where(live, total, 0),
        min=mn[:n],
        max=mx[:n],
        n_groups=n_groups,
    )


def dense_aggregate(keys: torch.Tensor, values: torch.Tensor, domain: int) -> GroupByResult:
    """Perfect-hash aggregate for keys in [0, domain): one scatter a stat
    into domain-sized tables, `keys[g] = g`. Keys outside [0, domain) are
    dropped. (The JAX version's `.at[keys].add(..., mode="drop")` wraps a
    negative key into the top of the domain, so key -1 counts as group
    domain - 1 there; ROADMAP Queue 3.)"""
    _check(keys, values)
    keys = keys.to(torch.int64)
    sv = values.to(torch.int64)
    # rows outside the domain go to the sink at `domain`
    idx = torch.where((keys >= 0) & (keys < domain), keys, domain)
    cnt = keys.new_zeros(domain + 1).scatter_add_(0, idx, torch.ones_like(idx))[:domain]
    total = keys.new_zeros(domain + 1).scatter_add_(0, idx, sv)[:domain]
    mn, mx = _group_min_max(idx, sv, domain + 1)
    return GroupByResult(
        keys=torch.arange(domain, dtype=torch.int64, device=keys.device),
        count=cnt,
        sum=total,
        min=mn[:domain],
        max=mx[:domain],
        n_groups=(cnt > 0).sum(),
    )


def join_dense_aggregate(table, probe_keys: torch.Tensor, domain: int):
    """GROUP BY probe key over the join probe ⋈ `table` (a SortedTable of
    the unique keys 0 .. domain - 1, each row's value its payload), pushed
    below the join: with bc[k] the probes of key k (`sorted_build_counts`),

      count[k] = bc[k]      sum[k] = bc[k] * payload[k]
      min[k] = max[k] = payload[k] where bc[k] > 0      matches = Σ bc

    Returns (GroupByResult over [0, domain), matches as an int64 0-d
    tensor). Raises ValueError unless the table's host-side fields show
    `domain` unique keys from 0 to domain - 1; use `dense_aggregate`
    then."""
    from ccve_tpu_torch.ops.sort_merge import sorted_build_counts

    m = table.keys.numel()
    # m unique keys from 0 to domain - 1 are the keys 0 .. domain - 1
    if m != domain or (m and (table.max_mult != 1 or table.key_range != (0, domain - 1))):
        raise ValueError(
            f"join_dense_aggregate needs a table of the keys 0 .. {domain - 1}, each once: "
            f"this one has {m} rows, key multiplicity up to {table.max_mult}, "
            f"key range {table.key_range}"
        )
    bc = sorted_build_counts(table, probe_keys).to(torch.int64)
    s_k = table.payloads
    occupied = bc > 0
    return (
        GroupByResult(
            keys=table.keys,
            count=bc,
            sum=bc * s_k,
            min=torch.where(occupied, s_k, I64_MAX),
            max=torch.where(occupied, s_k, I64_MIN),
            n_groups=occupied.sum(),
        ),
        bc.sum(),
    )


def partition_histogram(keys: torch.Tensor, n_parts: int) -> torch.Tensor:
    """int64[n_parts]: the keys owned by each part of an `n_parts`-way
    hash partition (the top bits of murmur64, `parallel.distributed`)."""
    from ccve_tpu_torch.parallel.distributed import _owner

    owner = _owner(keys, n_parts)
    # index_add_ into a known length (bincount reads the largest owner
    # back), each part's count spread over HIST_LANES bins by row, so the
    # atomic adds of a hot part do not all land on one address
    lane = torch.arange(owner.numel(), device=owner.device) & (HIST_LANES - 1)
    slot = owner * HIST_LANES + lane
    bins = owner.new_zeros(n_parts * HIST_LANES).index_add_(0, slot, torch.ones_like(slot))
    return bins.view(n_parts, HIST_LANES).sum(1)
