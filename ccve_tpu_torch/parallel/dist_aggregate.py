"""Distributed group-by over a hash-partitioned mesh.

Port of `ccve_tpu.parallel.dist_aggregate`, the classic shuffle aggregate:

 1. rows are split evenly over the ranks (rank r takes rows [r * per_dev,
    (r + 1) * per_dev)), and each rank routes its rows to `owner(key)`,
    the join shuffle's high-bit ownership (`parallel.distributed._owner`),
    so a join and an aggregate on one key share the placement;
 2. one all-to-all of a [P, 1 + 2 * cap] grid carries keys and values,
    each grid row with its live count (`distributed._route`);
 3. each rank aggregates the rows it owns with `ops.aggregate.
    hash_aggregate`, the empty grid slots left out (`valid`). Ownership is
    disjoint, so no second combine: the ranks' groups together are the
    global group set;
 4. the per-owner histogram of live rows is summed over the ranks (`skew`
    = max / mean), and a bucket over the static `cap` sets `overflow`
    (counting the dead rows at row % P, as in JAX), never a silent drop.

The JAX package pads rows with an INT64_MAX sentinel key and takes every
INT64_MAX key for padding, so a real key INT64_MAX is dropped there
(ROADMAP Queue 3); here pad rows are masked, and every int64 key groups.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ccve_tpu_torch.ops.aggregate import hash_aggregate
from ccve_tpu_torch.parallel.distributed import (
    JoinMesh,
    _capacity,
    _dead_counts,
    _owner,
    _probe_shard,
    _route,
)


class DistAggResult(NamedTuple):
    """This rank's block of the global group-by, `block_len` = P * cap
    rows: its live groups occupy the first `shard_groups[rank]`, sorted by
    key, with `GroupByResult`'s padding after them. Keys are distinct across
    the ranks (ownership is disjoint). `shard_groups`, `n_groups`, `skew`
    and `overflow` are equal on every rank."""

    keys: torch.Tensor  # int64[block_len]
    count: torch.Tensor  # int64[block_len]
    sum: torch.Tensor  # int64[block_len]
    min: torch.Tensor  # int64[block_len]
    max: torch.Tensor  # int64[block_len]
    shard_groups: torch.Tensor  # int64[P]: live groups a block
    n_groups: torch.Tensor  # int64: distinct keys over the mesh
    block_len: int
    skew: torch.Tensor  # float32: max/mean global partition load
    overflow: torch.Tensor  # bool: a send bucket exceeded cap (invalid)
    mesh: JoinMesh


def dist_aggregate(mesh: JoinMesh, keys, values, cap_slack: float = 2.0) -> DistAggResult:
    """Distributed count/sum/min/max group-by of `values` by `keys` (int64
    [n], host or device, the same on every rank). `cap_slack` scales the
    static send capacity a destination (expected rows x slack + 8)."""
    P = mesh.size
    keys = torch.as_tensor(keys).reshape(-1)
    values = torch.as_tensor(values).reshape(-1)
    if keys.shape != values.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and values {tuple(values.shape)}")
    per_dev = -(-keys.shape[0] // P)
    cap = _capacity(per_dev, P, cap_slack)
    cols, live = _probe_shard(mesh, torch.stack([keys.to(torch.int64),
                                                 values.to(torch.int64)], 1), per_dev)
    owner = _owner(cols[0], P)
    over = (_dead_counts(owner, live, P) > cap).any()
    hist = torch.zeros(P, dtype=torch.int64, device=mesh.device).index_add_(
        0, owner, live.to(torch.int64))
    routed = _route(mesh, None, owner, live, cols, P, cap)
    res = hash_aggregate(routed.values[0], routed.values[1], valid=routed.valid)
    shard_groups = mesh.all_gather(res.n_groups)
    ghist = mesh.psum(hist).to(torch.float32)
    return DistAggResult(
        keys=res.keys, count=res.count, sum=res.sum, min=res.min, max=res.max,
        shard_groups=shard_groups, n_groups=shard_groups.sum(), block_len=P * cap,
        skew=ghist.max() / ghist.mean().clamp(min=1.0), overflow=mesh.pmax(over), mesh=mesh,
    )


def collect_groups(res: DistAggResult) -> np.ndarray:
    """The live groups of every rank as int64[n_groups, 5] rows (key,
    count, sum, min, max), sorted by key: the canonical form to compare
    with a single-device `hash_aggregate`. A collective (an all-gather of
    the blocks): every rank calls it."""
    blocks = res.mesh.all_gather(torch.stack([res.keys, res.count, res.sum, res.min, res.max]))
    blocks = blocks.cpu().numpy()
    rows = [blocks[p, :, :g].T for p, g in enumerate(res.shard_groups.tolist())]
    out = np.concatenate(rows, axis=0)
    return out[np.argsort(out[:, 0], kind="stable")]
