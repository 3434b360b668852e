"""The distributed hash join over `torch.distributed`: hash-partitioned
tables and an all-to-all radix shuffle.

Port of `ccve_tpu.parallel.distributed`. The JAX package runs each plan as
one SPMD program under `shard_map` over a device mesh; here each plan runs
on every rank of a process group, one device a rank, and each rank calls
it with the same host inputs (deterministic generators), as the JAX
package's processes do.

 - **Mesh** (`JoinMesh`, `make_join_mesh`, `make_join_mesh_2d`): the
   process group (or a `DeviceMesh` with dims ("dcn", "ici")), its size P,
   this rank, the compute device and the collective device. NCCL carries
   collectives on the card; gloo on the host, so the plans copy each send
   grid to the host and each received grid back, explicitly. The backend
   follows the device (NCCL for cuda, gloo for cpu) unless the caller
   names it; gloo with cuda runs several ranks on one card. Partition p
   lives on rank p, which is (p // I, p % I) on the 2D mesh.
 - **Partitioning**: a build row belongs to `owner(key) = murmurhash64(key)
   >> (64 - log2 P)`, the hash's high bits, disjoint from the low bits
   that pick a slot or bucket inside each local table. Each rank builds
   its own partition only (`build_sorted`, `build_lp`, `build_csr`), with
   no padding: a sorted partition keeps the key span of its own rows, so
   `sorted_match_stats` takes its kernel route. LP and CSR partitions are
   sized by the largest partition, as in JAX, and `max_bound` is the
   global chain bound (an all-reduce MAX).
 - **Probe (radix shuffle)**: rank r takes probe rows [r * per_dev,
   (r + 1) * per_dev), per_dev = ceil(n / P); rows past n are dead. Each
   rank buckets its live keys by owner (a stable sort and offsets) into a
   static [P, cap] grid, exchanges grids with one `all_to_all`, probes the
   received keys against its partition (`exec.bulk.match_stats`), and
   routes (mult, psum) back with two more. A grid row carries its live
   count in a column of its own, so empty slots need no sentinel key: the
   JAX package's key -2 for dead rows, -3 for an empty hot set and
   INT64_MAX for padded sorted partitions are gone, and any int64 key
   joins. The N-way count factorizes as on one device (`combine_levels`),
   finished with one all-reduce.
 - **Skew and overflow**: the per-owner send histogram is summed over the
   ranks, `skew` = max / mean; a bucket over the static `cap` sets
   `overflow` (the results are then invalid), never a silent drop. The
   flat plans count dead rows where JAX counts them (owner = row % P), so
   `skew` and `overflow` equal JAX's.

Plans: the flat shuffle with PRPD levels (`dist_bulk_count`), the ring
(`dist_bulk_count_ring`), the hierarchical two-hop shuffle
(`dist_bulk_count_hier`), the broadcast join (`dist_bulk_count_bcast`) and
the materializing joins (`dist_bulk_expand`, `dist_pipeline_expand`).
Results are tensors on the compute device, equal on every rank, or (the
materializing joins) each rank's own shard.

`_owner` on a CUDA tensor launches kernel #12; the owner is int64, torch's
index type (JAX's `_owner_jnp` returns int32). The JAX package shifts the
uint64 hash right by 64 - int(log2(P)); here the hash is int64 holding the
uint64 bits, where `>>` carries the sign in, so the shifted value is
masked to its int(log2(P)) bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ccve_tpu_torch.config import PayloadMode
from ccve_tpu_torch.device import require_device
from ccve_tpu_torch.exec.bulk import combine_levels, match_stats
from ccve_tpu_torch.ops.hash_table import build_csr, build_lp, next_pow2
from ccve_tpu_torch.ops.hashing import murmurhash64, murmurhash64_np
from ccve_tpu_torch.ops.sort_merge import MatchStats, build_sorted, sorted_expand

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def _owner_bits(n_parts: int) -> int:
    if n_parts < 1:
        raise ValueError(f"n_parts must be at least 1, got {n_parts}")
    return int(math.log2(n_parts))


def _owner(keys: torch.Tensor, n_parts: int) -> torch.Tensor:
    """int64[n]: each key's part among `n_parts`, the top
    int(log2(n_parts)) bits of its murmur64 hash (kernel #12 on a CUDA
    tensor); all zeros for one part."""
    bits = _owner_bits(n_parts)
    if bits == 0:
        return torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    return (murmurhash64(keys) >> (64 - bits)) & ((1 << bits) - 1)


def _owner_np(keys: np.ndarray, n_parts: int) -> np.ndarray:
    """`_owner` in numpy on the uint64 hash: int64[n]."""
    bits = _owner_bits(n_parts)
    if bits == 0:
        return np.zeros(keys.shape[0], np.int64)
    return (murmurhash64_np(keys) >> np.uint64(64 - bits)).astype(np.int64)


# ---------------------------------------------------------------------------
# The mesh: a process group and its collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JoinMesh:
    """P ranks of a process group, one partition a rank. `shape` is (P,)
    or (D, I) with dims ("dcn", "ici") (`device_mesh` then holds the
    `DeviceMesh`). Collectives take tensors on `device` and return them
    there; they travel on `comm_device` (the card for NCCL, the host for
    gloo). A mesh that made its own one-rank group destroys it on
    `close()` (or at the end of a `with` block)."""

    size: int
    rank: int
    device: torch.device
    comm_device: torch.device
    shape: tuple
    device_mesh: object = None
    owns_group: bool = False

    def group(self, axis: str | None = None):
        """The process group of `axis` ("dcn" or "ici" on a 2D mesh), or of
        the whole mesh (None: the default group)."""
        if axis is None:
            return None
        if self.device_mesh is None:
            raise ValueError(f"axis {axis!r} needs a 2D mesh (make_join_mesh_2d)")
        return self.device_mesh.get_group(axis)

    def _to_comm(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.comm_device).contiguous()

    def all_to_all(self, grid: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """Row j of this rank's [G, ...] grid goes to rank j of the group;
        row j of the result came from rank j (`all_to_all_single`, even
        splits)."""
        send = self._to_comm(grid)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group(axis))
        return recv.to(self.device)

    def _all_reduce(self, x: torch.Tensor, op, axis) -> torch.Tensor:
        buf = x.to(self.comm_device, copy=True).contiguous()  # reduced in place
        dist.all_reduce(buf, op=op, group=self.group(axis))
        return buf.to(self.device)

    def psum(self, x: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.SUM, axis)

    def pmax(self, x: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """The elementwise maximum over the group; a bool tensor reduces as
        int32 and comes back bool."""
        if x.dtype == torch.bool:
            return self._all_reduce(x.to(torch.int32), dist.ReduceOp.MAX, axis) > 0
        return self._all_reduce(x, dist.ReduceOp.MAX, axis)

    def all_gather(self, x: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """[G, *x.shape]: every rank's x in rank order (x has one shape on
        every rank)."""
        send = self._to_comm(x)
        g = self.size if axis is None else dist.get_world_size(self.group(axis))
        out = [torch.empty_like(send) for _ in range(g)]
        dist.all_gather(out, send, group=self.group(axis))
        return torch.stack(out).to(self.device)

    def ring_shift(self, x: torch.Tensor, tag: int = 0):
        """Post the send of x to rank + 1 and the receive of rank - 1's x
        (same shape and dtype), one `batch_isend_irecv`; returns a function
        that waits for both and gives the received tensor on `device`.
        Needs P > 1: torch refuses a send to the caller's own rank."""
        if self.device_mesh is not None:
            raise ValueError("the ring runs on a 1D mesh (make_join_mesh)")
        send = self._to_comm(x)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (self.rank + 1) % self.size, tag=tag),
               dist.P2POp(dist.irecv, recv, (self.rank - 1) % self.size, tag=tag)]
        reqs = dist.batch_isend_irecv(ops)

        def finish(held=(send, recv)) -> torch.Tensor:  # both live until the wait
            for req in reqs:
                req.wait()
            return held[1].to(self.device)

        return finish

    def close(self) -> None:
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False

    def __enter__(self) -> JoinMesh:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _check_pow2(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"mesh size must be a power of two (got {n})")


def _join_group(n: int, device, backend: str | None):
    """(compute device, collective device, whether this call made the
    group) for a mesh of n ranks: the running process group, which must
    have n ranks, or, with none, a one-rank group on a HashStore (n must be
    1), the port's form of a single-process run."""
    device = require_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    owns = not dist.is_initialized()
    if owns:
        if n != 1:
            raise ValueError(
                f"a mesh of {n} ranks needs a process group of {n} ranks "
                "(bootstrap.init_distributed, torchrun); without one a mesh has one rank")
        backend = backend or default_backend(device)
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("the NCCL backend carries CUDA tensors: pass a CUDA device")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        world = dist.get_world_size()
        if n != world:
            raise ValueError(f"a mesh of {n} ranks on a process group of {world}")
        running = dist.get_backend()
        if backend is not None and backend != running:
            raise ValueError(f"backend {backend!r} asked, the process group runs {running!r}")
        backend = running
    comm = device if backend == "nccl" else torch.device("cpu")
    return device, comm, owns


def make_join_mesh(n_devices: int | None = None, device="cuda",
                   backend: str | None = None) -> JoinMesh:
    """The 1D join mesh over the running process group (its size when
    `n_devices` is None), or a one-rank mesh on a group of its own when
    there is none. A size that is no power of two raises, as in JAX.
    `device` is this rank's compute device (default the card; raises
    without one)."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    _check_pow2(n)
    device, comm, owns = _join_group(n, device, backend)
    return JoinMesh(size=n, rank=dist.get_rank(), device=device, comm_device=comm,
                    shape=(n,), owns_group=owns)


def make_join_mesh_2d(n_hosts: int, chips_per_host: int, device="cuda",
                      backend: str | None = None) -> JoinMesh:
    """A (hosts x devices-a-host) mesh: a `DeviceMesh` with dims ("dcn",
    "ici") over the running process group's ranks, row-major, so partition
    p of P = n_hosts * chips_per_host lives on rank p = (p // I, p % I).
    The leading dim crosses nodes (or stands in for it); the trailing one
    stays inside a node."""
    from torch.distributed.device_mesh import init_device_mesh

    n = n_hosts * chips_per_host
    _check_pow2(n)
    device, comm, owns = _join_group(n, device, backend)
    dmesh = init_device_mesh(comm.type, (n_hosts, chips_per_host),
                             mesh_dim_names=(DCN_AXIS, ICI_AXIS))
    return JoinMesh(size=n, rank=dist.get_rank(), device=device, comm_device=comm,
                    shape=(n_hosts, chips_per_host), device_mesh=dmesh, owns_group=owns)


# ---------------------------------------------------------------------------
# Partitioning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PartitionedTables:
    """One join level's build table, hash-partitioned over P ranks: `table`
    is this rank's partition (a SortedTable, LPTable or CSRTable on the
    mesh's device). `max_bound` is the global chain bound, the largest
    max_run, max_len or key multiplicity over the partitions (at least
    1)."""

    kind: str  # "sorted" | "lp" | "csr"
    table: object
    max_bound: int
    n_parts: int


def _columns(keys, payloads):
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if payloads is None:
        payloads = np.arange(keys.shape[0], dtype=np.int64) + 10_000_000
    return keys, np.ascontiguousarray(payloads, dtype=np.int64)


def _build(kind: str, keys, payloads, max_count: int, device):
    """(table, its own chain bound) of one partition. LP and CSR tables are
    sized by `max_count`, the largest partition's rows, as JAX's
    `_rebuild_lp` and `_rebuild_csr` are."""
    if kind == "lp":
        t = build_lp(keys, payloads, device=device, n_slots=next_pow2(4 * max_count))
        return t, t.max_run
    if kind == "csr":
        t = build_csr(keys, payloads, device=device, n_buckets=next_pow2(2 * max_count))
        return t, t.max_len
    if kind == "sorted":
        t = build_sorted(keys, payloads, device=device)
        return t, t.max_mult
    raise ValueError(f"unknown table kind {kind!r}")


def _pack_partitions(keys, payloads, parts, n_parts, kind, mesh) -> PartitionedTables:
    """This rank's partition of the row-index lists `parts` (one a rank),
    with the global bound (a collective: every rank calls it in turn)."""
    if mesh is None:
        raise ValueError("partitioning needs the mesh whose rank builds its partition")
    if n_parts != mesh.size:
        raise ValueError(f"{n_parts} partitions on a mesh of {mesh.size} ranks")
    max_count = max(max((idx.shape[0] for idx in parts), default=1), 1)
    idx = parts[mesh.rank]
    table, bound = _build(kind, keys[idx], payloads[idx], max_count, mesh.device)
    bound = mesh.pmax(torch.tensor(max(bound, 1), dtype=torch.int64, device=mesh.device))
    return PartitionedTables(kind=kind, table=table, max_bound=int(bound), n_parts=n_parts)


def partition_tables(keys, payloads, n_parts: int, kind: str = "lp",
                     mesh: JoinMesh | None = None) -> PartitionedTables:
    """Hash-partition one build table over the mesh: every rank computes
    each key's owner and builds the partition it owns (`mesh` is
    required)."""
    keys, payloads = _columns(keys, payloads)
    owner = _owner_np(keys, n_parts)
    parts = [np.nonzero(owner == p)[0] for p in range(n_parts)]
    return _pack_partitions(keys, payloads, parts, n_parts, kind, mesh)


def partition_tables_block(keys, payloads, n_parts: int, kind: str = "lp",
                           mesh: JoinMesh | None = None) -> PartitionedTables:
    """Block-partitioned build for the ring join: partition p owns rows
    [p * ceil(n / P), ...); every probe key then visits every partition
    (`dist_bulk_count_ring`)."""
    keys, payloads = _columns(keys, payloads)
    per = -(-keys.shape[0] // n_parts)
    owner = np.minimum(np.arange(keys.shape[0]) // max(per, 1), n_parts - 1)
    parts = [np.nonzero(owner == p)[0] for p in range(n_parts)]
    return _pack_partitions(keys, payloads, parts, n_parts, kind, mesh)


@dataclasses.dataclass(frozen=True)
class HotSplitTables:
    """PRPD (partial redistribution, partial duplication) split of one
    build level for skewed probes: rows whose key is a detected heavy
    hitter are replicated to every rank (`rep`), the rest hash-partitioned
    (`part`). Probes with a hot key never enter the shuffle; they probe the
    local replica. `hot_keys` is the hot set on the mesh's device,
    unpadded: an empty set matches no key."""

    part: PartitionedTables
    rep: PartitionedTables
    hot_keys: torch.Tensor  # int64[H]


def detect_heavy_hitters(keys: np.ndarray, max_hot: int = 64,
                         min_frac: float = 0.001) -> np.ndarray:
    """The at most `max_hot` most frequent keys of a (sample of a) probe
    key stream whose count is at least max(1, int(min_frac * n)), most
    frequent first (numpy, on the host)."""
    keys = np.asarray(keys).reshape(-1)
    vals, counts = np.unique(keys, return_counts=True)
    keep = counts >= max(1, int(min_frac * keys.shape[0]))
    vals, counts = vals[keep], counts[keep]
    order = np.argsort(-counts)[:max_hot]
    return np.ascontiguousarray(vals[order], dtype=np.int64)


def partition_tables_split(keys, payloads, n_parts: int, hot_keys, kind: str = "lp",
                           mesh: JoinMesh | None = None) -> HotSplitTables:
    """Hash-partition the cold rows; every rank builds the hot rows'
    replica."""
    keys, payloads = _columns(keys, payloads)
    hot_keys = np.ascontiguousarray(hot_keys, dtype=np.int64)
    is_hot = np.isin(keys, hot_keys)
    cold_idx = np.nonzero(~is_hot)[0]
    hot_idx = np.nonzero(is_hot)[0]
    owner = _owner_np(keys, n_parts)
    cold_parts = [cold_idx[owner[cold_idx] == p] for p in range(n_parts)]
    part = _pack_partitions(keys, payloads, cold_parts, n_parts, kind, mesh)
    rep = _pack_partitions(keys, payloads, [hot_idx] * n_parts, n_parts, kind, mesh)
    return HotSplitTables(part=part, rep=rep,
                          hot_keys=torch.from_numpy(hot_keys).to(mesh.device))


@dataclasses.dataclass(frozen=True)
class ReplicatedTables:
    """One join level's whole build table on every rank: the broadcast
    join's counterpart of `PartitionedTables`."""

    kind: str
    table: object
    max_bound: int


def replicate_tables(keys, payloads, kind: str = "sorted",
                     mesh: JoinMesh | None = None) -> ReplicatedTables:
    """The whole table, built on every rank from the host rows every rank
    holds. JAX pays the one-time broadcast as a `device_put` of host data;
    here each rank pays it as a local build (`bench.dist_model.bcast_cost`
    prices it as an all-gather). Sized as one partition holding every row,
    as JAX's `replicate_tables` is."""
    if mesh is None:
        raise ValueError("replicate_tables needs the mesh (its device)")
    keys, payloads = _columns(keys, payloads)
    table, bound = _build(kind, keys, payloads, max(keys.shape[0], 1), mesh.device)
    return ReplicatedTables(kind=kind, table=table, max_bound=max(int(bound), 1))


# ---------------------------------------------------------------------------
# The shuffle
# ---------------------------------------------------------------------------


class DistResult(NamedTuple):
    count: torch.Tensor  # int64: total join output rows
    payload_checksums: torch.Tensor  # int64[n_levels]
    skew: torch.Tensor  # float32: max/mean of the global partition load
    overflow: torch.Tensor  # bool: a send bucket exceeded cap (results invalid)


def _capacity(per_dev: int, n_parts: int, cap_slack: float) -> int:
    """The static send capacity a destination, JAX's rule: expected rows
    x slack + 8, at least 16, at most the rows a rank holds."""
    return min(max(int(per_dev / n_parts * cap_slack) + 8, 16), per_dev)


def _probe_shard(mesh: JoinMesh, probe_rows, per_dev: int):
    """(int64 [n_cols, per_dev] columns of this rank's rows, bool[per_dev]
    live) on the mesh's device: rows [rank * per_dev, (rank + 1) *
    per_dev); rows past the table are dead (key 0, masked)."""
    probe = torch.as_tensor(probe_rows)
    if probe.dim() == 1:
        probe = probe[:, None]
    n = probe.shape[0]
    lo = min(mesh.rank * per_dev, n)
    mine = probe[lo:min(lo + per_dev, n)].to(device=mesh.device, dtype=torch.int64)
    cols = torch.zeros((probe.shape[1], per_dev), dtype=torch.int64, device=mesh.device)
    cols[:, : mine.shape[0]] = mine.T
    live = torch.arange(per_dev, device=mesh.device) < mine.shape[0]
    return cols, live


def _dead_counts(owner, live, n_parts: int) -> torch.Tensor:
    """int64[n_parts]: rows a destination with JAX's dead-row rule: a live
    row counts at its owner, a dead one at its row index % P (JAX sends it
    there as key -2)."""
    lane = torch.arange(owner.numel(), device=owner.device)
    at = torch.where(live, owner, lane % n_parts)
    return torch.zeros(n_parts, dtype=torch.int64, device=owner.device).index_add_(
        0, at, torch.ones_like(at))


class _Routed(NamedTuple):
    values: torch.Tensor  # int64[k, n_dest * cap] the received values
    valid: torch.Tensor  # bool[n_dest * cap] the received slots that hold a row
    slot: torch.Tensor  # int64[n] each sent row's slot (dest * cap + pos), -1 unsent
    live_counts: torch.Tensor  # int64[n_dest] rows sent a destination (before the cap)
    n_dest: int
    cap: int


def _route(mesh: JoinMesh, axis, dest, send, values, n_dest: int, cap: int) -> _Routed:
    """Send the rows where `send` (bool[n]) is set to rank dest[row] of the
    group of `axis`, with their `values` (int64 [k, n]), in one all-to-all
    of a [n_dest, 1 + k * cap] grid: column 0 holds a row's live count, then
    k blocks of cap values, the rows packed in stable order. A destination
    past `cap` keeps the first cap (the caller flags overflow)."""
    n, k, dev = dest.numel(), values.shape[0], dest.device
    d = torch.where(send, dest, n_dest)  # unsent rows sort into bucket n_dest
    order = torch.sort(d, stable=True).indices
    d_sorted = d[order]
    counts = torch.zeros(n_dest + 1, dtype=torch.int64, device=dev).index_add_(
        0, d, torch.ones_like(d))
    offs = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=dev) - offs[d_sorted]
    ok = (d_sorted < n_dest) & (pos < cap)
    slot_sorted = torch.where(ok, d_sorted * cap + pos, -1)
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    sink = n_dest * cap
    flat = torch.zeros((k, sink + 1), dtype=torch.int64, device=dev)
    flat[:, torch.where(ok, slot_sorted, sink)] = values[:, order]
    live_counts = counts[:n_dest]
    grid = torch.cat([
        live_counts.clamp(max=cap)[:, None],
        flat[:, :sink].view(k, n_dest, cap).transpose(0, 1).reshape(n_dest, k * cap),
    ], 1)
    recv = mesh.all_to_all(grid, axis)
    valid = torch.arange(cap, device=dev)[None, :] < recv[:, :1]
    got = recv[:, 1:].view(n_dest, k, cap).transpose(0, 1).reshape(k, n_dest * cap)
    return _Routed(got, valid.reshape(-1), slot, live_counts, n_dest, cap)


def _route_back(mesh: JoinMesh, axis, routed: _Routed, stats) -> list:
    """Each received slot's stats (tensors [n_dest * cap]) back to the rows
    that sent them, one all-to-all a tensor; 0 at rows not sent."""
    sent = routed.slot >= 0
    at = routed.slot.clamp(min=0)
    out = []
    for s in stats:
        back = mesh.all_to_all(s.reshape(routed.n_dest, routed.cap), axis).reshape(-1)
        out.append(torch.where(sent, back[at], 0))
    return out


def _shuffle_level_stats(mesh: JoinMesh, table, keys, live, cap: int):
    """One level of the flat shuffle: route the live keys to their owners,
    probe, route (mult, psum) back. Returns (mult int32[n], psum int64[n],
    the send histogram int64[P] with JAX's dead rows, overflow)."""
    P = mesh.size
    owner = _owner(keys, P)
    counts = _dead_counts(owner, live, P)
    routed = _route(mesh, None, owner, live, keys[None], P, cap)
    stats = match_stats(table, routed.values[0])
    mult, psum = _route_back(mesh, None, routed, [stats.mult, stats.psum])
    return mult, psum, counts, (counts > cap).any()


def _reduce(mesh: JoinMesh, stats, live, hist=None, over=None) -> DistResult:
    """The factorized count and checksums of this rank's live rows, summed
    over the mesh, with the skew of `hist` (None: 1.0) and `over` the
    overflow (None: False)."""
    stats = [MatchStats(torch.where(live, s.mult, 0), torch.where(live, s.psum, 0))
             for s in stats]
    local = combine_levels(stats)
    n_levels = len(stats)
    parts = [local.count[None], local.payload_checksums]
    if hist is not None:
        parts.append(hist)
    sums = mesh.psum(torch.cat(parts))
    if hist is None:
        skew = torch.ones((), dtype=torch.float32, device=mesh.device)
        overflow = torch.zeros((), dtype=torch.bool, device=mesh.device)
    else:
        ghist = sums[1 + n_levels:].to(torch.float32)
        skew = ghist.max() / ghist.mean().clamp(min=1.0)
        overflow = mesh.pmax(over)
    return DistResult(count=sums[0], payload_checksums=sums[1 : 1 + n_levels], skew=skew,
                      overflow=overflow)


def _n_rows(probe_rows) -> tuple:
    shape = tuple(torch.as_tensor(probe_rows).shape)
    return shape if len(shape) == 2 else (shape[0], 1)


def dist_bulk_count(mesh: JoinMesh, ptables: Sequence, probe_rows,
                    cap_slack: float = 2.0) -> DistResult:
    """Distributed N-way join count. `probe_rows` is int [n, n_joins] (host
    or device, the same on every rank); each rank takes its row block,
    shuffles each level by key ownership, and the factorized count and
    checksums are summed over the mesh.

    A level given as `HotSplitTables` takes the PRPD path: probes whose key
    is in the level's hot set stay out of the shuffle (their stats come
    from the local replica), so a Zipf head neither loads one partition nor
    fills a send bucket; they count toward the send histogram as dead rows
    at row % P, as in JAX (whose docstring says they do not count)."""
    n, _ = _n_rows(probe_rows)
    per_dev = -(-n // mesh.size)
    cap = _capacity(per_dev, mesh.size, cap_slack)
    cols, live = _probe_shard(mesh, probe_rows, per_dev)
    stats = []
    hist = torch.zeros(mesh.size, dtype=torch.int64, device=mesh.device)
    over = torch.zeros((), dtype=torch.bool, device=mesh.device)
    for level, pt in enumerate(ptables):
        keys = cols[level]
        if isinstance(pt, HotSplitTables):
            routed = live & ~torch.isin(keys, pt.hot_keys)
            m, s, h, o = _shuffle_level_stats(mesh, pt.part.table, keys, routed, cap)
            rs = match_stats(pt.rep.table, keys)
            m, s = m + rs.mult, s + rs.psum
        else:
            m, s, h, o = _shuffle_level_stats(mesh, pt.table, keys, live, cap)
        stats.append(MatchStats(m, s))
        hist += h
        over |= o
    return _reduce(mesh, stats, live, hist, over)


def dist_bulk_count_ring(mesh: JoinMesh, ptables: Sequence, probe_rows,
                         n_chunks: int = 2) -> DistResult:
    """Ring (fragment-replicate) N-way join count over block-partitioned
    builds (`partition_tables_block`): no radix shuffle. Each rank's probe
    block circulates in `n_chunks` chunks; at each of P steps a chunk is
    probed against the local partitions and passed to rank + 1 with its
    running (mult, psum), which add up over the partitions. After P steps
    the chunk is home, so no inverse routing is needed. P x the probe work
    for no shuffle capacity: skew is 1.0 and overflow false.

    Exchange and compute overlap: each chunk's send and receive are posted
    (`batch_isend_irecv`) before the next chunk is probed, and waited for
    at the end of the step."""
    P, n_levels = mesh.size, len(ptables)
    n_chunks = max(1, n_chunks)
    n, _ = _n_rows(probe_rows)
    per_dev = -(-n // P)
    per_dev += (-per_dev) % n_chunks  # chunk-divisible
    per_chunk = per_dev // n_chunks
    cols, live = _probe_shard(mesh, probe_rows, per_dev)
    # a chunk travels as one packet: key columns, then each level's running
    # mult, then its running psum
    zeros = torch.zeros((2 * n_levels, per_chunk), dtype=torch.int64, device=mesh.device)
    chunks = [torch.cat([cols[:, c * per_chunk:(c + 1) * per_chunk], zeros])
              for c in range(n_chunks)]
    for _ in range(P):
        posted = []
        for c, packet in enumerate(chunks):
            packet = packet.clone()
            for level, pt in enumerate(ptables):
                s = match_stats(pt.table, packet[level])
                packet[n_levels + level] += s.mult
                packet[2 * n_levels + level] += s.psum
            # at P = 1 the rotation is the identity (JAX's ppermute on one
            # device), and torch refuses a send to the caller's own rank
            posted.append(mesh.ring_shift(packet, tag=c) if P > 1 else (lambda p=packet: p))
        chunks = [finish() for finish in posted]
    packets = torch.cat(chunks, 1)
    stats = [MatchStats(packets[n_levels + level], packets[2 * n_levels + level])
             for level in range(n_levels)]
    return _reduce(mesh, stats, live)


def _hier_level_stats(mesh: JoinMesh, table, keys, live, caps):
    """Two-hop shuffle of one level on the (dcn, ici) mesh:

      hop A (ici): to the rank i = owner % I of this node, the owner's column
      hop B (dcn): to node d = owner // I, whose rank in that column is the
                   owner

    so a key crosses the slow dim once, in a node-aggregated grid. Dead rows
    take no slot (JAX fills free slots with them and masks their stats).
    Returns (mult, psum, the live owner histogram, overflow over the live
    counts of both hops)."""
    D, I = mesh.shape
    cap_a, cap_b = caps
    owner0 = _owner(keys, D * I)
    hist = torch.zeros(D * I, dtype=torch.int64, device=keys.device).index_add_(
        0, owner0, live.to(torch.int64))
    hop_a = _route(mesh, ICI_AXIS, owner0 % I, live, keys[None], I, cap_a)
    keys_a = hop_a.values[0]
    hop_b = _route(mesh, DCN_AXIS, _owner(keys_a, D * I) // I, hop_a.valid, keys_a[None], D,
                   cap_b)
    stats = match_stats(table, hop_b.values[0])
    mult_a, psum_a = _route_back(mesh, DCN_AXIS, hop_b, [stats.mult, stats.psum])
    mult, psum = _route_back(mesh, ICI_AXIS, hop_a, [mult_a, psum_a])
    overflow = (hop_a.live_counts > cap_a).any() | (hop_b.live_counts > cap_b).any()
    return mult, psum, hist, overflow


def dist_bulk_count_hier(mesh: JoinMesh, ptables: Sequence, probe_rows,
                         cap_slack: float = 2.0) -> DistResult:
    """Distributed N-way join count on a 2D (dcn, ici) mesh with the
    hierarchical shuffle (`_hier_level_stats`): the flat all-to-all sends
    P - 1 messages a rank, P - I of them across nodes; here the slow dim
    sees D - 1 node-aggregated messages a rank. Tables are partitioned on
    the same mesh (partition p on rank p). This plan counts live rows only
    in its histogram and its caps, as JAX's does."""
    if mesh.device_mesh is None:
        raise ValueError("dist_bulk_count_hier needs a (dcn, ici) mesh (make_join_mesh_2d)")
    D, I = mesh.shape
    n, _ = _n_rows(probe_rows)
    per_dev = -(-n // mesh.size)

    def capf(avg):
        return max(int(avg * cap_slack) + 8, 16)

    # hop A: owner columns are uniform over I, so ~per_dev / I rows a column;
    # hop B: after hop A ~per_dev live rows, uniform over the D nodes
    caps = (capf(per_dev / I), capf(per_dev / D))
    cols, live = _probe_shard(mesh, probe_rows, per_dev)
    stats = []
    hist = torch.zeros(mesh.size, dtype=torch.int64, device=mesh.device)
    over = torch.zeros((), dtype=torch.bool, device=mesh.device)
    for level, pt in enumerate(ptables):
        m, s, h, o = _hier_level_stats(mesh, pt.table, cols[level], live, caps)
        stats.append(MatchStats(m, s))
        hist += h
        over |= o
    return _reduce(mesh, stats, live, hist, over)


def dist_bulk_count_bcast(mesh: JoinMesh, rtables: Sequence, probe_rows) -> DistResult:
    """Distributed N-way join count with replicated builds: ship the
    function, not the arguments. Every level's whole table sits on every
    rank (`replicate_tables`, the one-time broadcast), so each rank answers
    its probe rows locally and the only recurring communication is one
    all-reduce of L + 1 scalars. Rows are split evenly (skew 1.0, no send
    capacity to overflow). Works on a 1D or a 2D mesh. For builds too large
    to replicate, the partitioned plans remain; `bench.dist_model` prices
    the crossover."""
    n, _ = _n_rows(probe_rows)
    per_dev = -(-n // mesh.size)
    cols, live = _probe_shard(mesh, probe_rows, per_dev)
    stats = [match_stats(rt.table, cols[level]) for level, rt in enumerate(rtables)]
    return _reduce(mesh, stats, live)


# ---------------------------------------------------------------------------
# Materializing plans
# ---------------------------------------------------------------------------


class DistExpandResult(NamedTuple):
    """Materialized single-level join, this rank's shard: slots with
    rows >= 0 hold (probe row, build key, build payload) triples (rows are
    global probe-row ids, -1 an empty slot). `counts` holds every rank's
    triples, `total` their sum; both equal on every rank."""

    rows: torch.Tensor  # int64[capacity]
    keys: torch.Tensor  # int64[capacity]
    payloads: torch.Tensor  # int64[capacity]
    counts: torch.Tensor  # int64[P]
    total: torch.Tensor  # int64
    overflow: torch.Tensor  # bool: a send bucket overflowed (results invalid)
    mesh: JoinMesh

    def triples(self) -> np.ndarray:
        """int64[total, 3] (row, key, payload) of every rank, in rank order:
        a collective (an all-gather of the shards), so every rank calls it."""
        shards = self.mesh.all_gather(torch.stack([self.rows, self.keys, self.payloads]))
        out = shards.transpose(1, 2).reshape(-1, 3).cpu().numpy()
        return out[out[:, 0] >= 0]


class DistPipelineResult(NamedTuple):
    """Materialized N-way join, this rank's shard: slots with rid >= 0 are
    output rows; `rid` is the global probe-row id, `payloads[l]` the
    level-l matched build payload (the matched key is the probe's column
    l). `counts` and `total` as in `DistExpandResult`."""

    rid: torch.Tensor  # int64[S]
    payloads: torch.Tensor  # int64[n_levels, S]
    counts: torch.Tensor  # int64[P]
    total: torch.Tensor  # int64
    overflow: torch.Tensor  # bool
    mesh: JoinMesh

    def materialize(self, probe_rows: np.ndarray, payload_mode) -> np.ndarray:
        """The rows of every rank in the oracle's layout (exec/oracle.py):
        [probe columns..., per level (0, key) | (key, payload)]. A
        collective: every rank calls it."""
        mode = PayloadMode(getattr(payload_mode, "value", payload_mode))
        probe_rows = np.asarray(probe_rows)
        rid = self.mesh.all_gather(self.rid).reshape(-1).cpu().numpy()
        pays = self.mesh.all_gather(self.payloads).transpose(0, 1)
        pays = pays.reshape(pays.shape[0], -1).cpu().numpy()
        valid = rid >= 0
        rid_v = rid[valid]
        cols = [probe_rows[rid_v]]
        for level in range(pays.shape[0]):
            key_l = probe_rows[rid_v, level]
            if mode is PayloadMode.REFERENCE:
                cols += [np.zeros_like(key_l)[:, None], key_l[:, None]]
            else:
                cols += [key_l[:, None], pays[level, valid][:, None]]
        return np.concatenate(cols, axis=1)


def _expand_routed(table, routed: _Routed, capacity: int):
    """`sorted_expand` of the received keys (values[0]): (src int64 slot
    of each output slot, ok bool: a triple from a valid slot, payloads).
    Empty slots hold key 0 and may match; their triples are masked, and
    `capacity` (slots x fan-out) holds every match."""
    ridx, _, mpays, _ = sorted_expand(table, routed.values[0], capacity)
    src = ridx.to(torch.int64).clamp(min=0)
    ok = (ridx >= 0) & routed.valid[src]
    return src, ok, mpays


def dist_bulk_expand(mesh: JoinMesh, ptable: PartitionedTables, probe_keys,
                     cap_slack: float = 2.0) -> DistExpandResult:
    """Distributed materializing single-level join: probe keys are
    shuffled to their owner with their global row ids, each rank expands
    its matches with `sorted_expand`, and the triples stay sharded. Their
    multiset equals the single-device `sorted_expand`'s. `ptable` must be
    the sorted kind; a rank's output holds the static worst case P * cap *
    max_bound slots, so only a send bucket can overflow."""
    if ptable.kind != "sorted":
        raise ValueError("dist_bulk_expand needs kind='sorted' partitions")
    P = mesh.size
    n = torch.as_tensor(probe_keys).reshape(-1).shape[0]
    per_dev = -(-n // P)
    cap = _capacity(per_dev, P, cap_slack)
    capx = P * cap * max(int(ptable.max_bound), 1)
    cols, live = _probe_shard(mesh, torch.as_tensor(probe_keys).reshape(-1), per_dev)
    keys = cols[0]
    grow = mesh.rank * per_dev + torch.arange(per_dev, device=mesh.device)
    owner = _owner(keys, P)
    over = (_dead_counts(owner, live, P) > cap).any()
    routed = _route(mesh, None, owner, live, torch.stack([keys, grow]), P, cap)
    src, ok, mpays = _expand_routed(ptable.table, routed, capx)
    rows = torch.where(ok, routed.values[1][src], -1)
    keys_out = torch.where(ok, routed.values[0][src], 0)
    count = ok.sum()
    counts = mesh.all_gather(count)
    return DistExpandResult(rows=rows, keys=keys_out, payloads=torch.where(ok, mpays, 0),
                            counts=counts, total=counts.sum(), overflow=mesh.pmax(over),
                            mesh=mesh)


def dist_pipeline_expand(mesh: JoinMesh, ptables: Sequence, probe_rows,
                         cap_slack: float = 2.0,
                         level_caps: Sequence[int] | None = None) -> DistPipelineResult:
    """Distributed materializing N-way join: a cascade of shuffled
    expansions. At level l each live partial row goes to the owner of its
    level-l key with its cargo (the global row id, the later levels' keys
    and the earlier levels' matched payloads), expands against the owner's
    sorted partition (`sorted_expand`), and the survivors go on to level
    l + 1. Output stays sharded where the last level expanded it; its row
    multiset equals `oracle_pipeline`'s.

    Capacities are static worst cases (a level's expansion buffer = what
    its shuffle can deliver x its max multiplicity), multiplying over the
    levels. `level_caps[l]` bounds the per-rank state carried out of level
    l instead: the live rows are compacted (one stable sort of the dead
    mask) into that buffer, and exceeding it is detected overflow, never a
    silent drop."""
    for pt in ptables:
        if pt.kind != "sorted":
            raise ValueError("dist_pipeline_expand needs 'sorted' partitions")
    P = mesh.size
    n, n_levels = _n_rows(probe_rows)
    if n_levels != len(ptables):
        raise ValueError(f"probe_rows has {n_levels} columns for {len(ptables)} levels")
    per_dev = -(-n // P)
    sizes, caps, expand_caps = [per_dev], [], []  # sizes[l]: state rows into level l
    for level, pt in enumerate(ptables):
        c = min(max(int(sizes[level] / P * cap_slack) + 8, 16), sizes[level])
        caps.append(c)
        worst = P * c * max(int(pt.max_bound), 1)
        expand_caps.append(worst)
        bounded = level_caps is not None and level < len(level_caps)
        sizes.append(min(worst, max(int(level_caps[level]), 1)) if bounded else worst)

    cols, live = _probe_shard(mesh, probe_rows, per_dev)
    dev = mesh.device
    rid = torch.where(live, mesh.rank * per_dev + torch.arange(per_dev, device=dev), -1)
    later = [cols[level] for level in range(n_levels)]  # keys of the levels to come
    mpays = []  # matched payloads of the levels done
    over = torch.zeros((), dtype=torch.bool, device=dev)
    for level, pt in enumerate(ptables):
        alive = rid >= 0
        keys = later[0]
        owner = _owner(keys, P)
        over |= (_dead_counts(owner, alive, P) > caps[level]).any()
        cargo = torch.stack([keys, rid, *later[1:], *mpays])
        routed = _route(mesh, None, owner, alive, cargo, P, caps[level])
        src, ok, mpay = _expand_routed(pt.table, routed, expand_caps[level])
        got = routed.values[:, src]  # [key, rid, later keys..., payloads...]
        rid = torch.where(ok, got[1], -1)
        n_later = len(later) - 1
        later = [torch.where(ok, got[2 + j], 0) for j in range(n_later)]
        mpays = [torch.where(ok, got[2 + n_later + j], 0) for j in range(len(mpays))]
        mpays.append(torch.where(ok, mpay, 0))
        if sizes[level + 1] < expand_caps[level]:
            # bounded carry: the live rows first (stable), cut to the bound
            alive = rid >= 0
            over |= alive.sum() > sizes[level + 1]
            sel = torch.sort((~alive).to(torch.int8), stable=True).indices[: sizes[level + 1]]
            rid = rid[sel]
            later = [k[sel] for k in later]
            mpays = [p[sel] for p in mpays]
    count = (rid >= 0).sum()
    counts = mesh.all_gather(count)
    pays = torch.stack([torch.where(rid >= 0, p, 0) for p in mpays])
    return DistPipelineResult(rid=rid, payloads=pays, counts=counts, total=counts.sum(),
                              overflow=mesh.pmax(over), mesh=mesh)
