"""The distributed tier: hash-partitioned joins and aggregates over a
`torch.distributed` process group (`distributed`, `dist_aggregate`), the
process bootstrap (`bootstrap`) and a dry run of every plan (`dryrun`)."""

from ccve_tpu_torch.parallel.bootstrap import init_distributed, run_dist_join, spawn_ranks
from ccve_tpu_torch.parallel.dist_aggregate import collect_groups, dist_aggregate
from ccve_tpu_torch.parallel.distributed import (
    HotSplitTables,
    JoinMesh,
    PartitionedTables,
    ReplicatedTables,
    detect_heavy_hitters,
    dist_bulk_count,
    dist_bulk_count_bcast,
    dist_bulk_count_hier,
    dist_bulk_count_ring,
    dist_bulk_expand,
    dist_pipeline_expand,
    make_join_mesh,
    make_join_mesh_2d,
    partition_tables,
    partition_tables_block,
    partition_tables_split,
    replicate_tables,
)
from ccve_tpu_torch.parallel.dryrun import dryrun_multichip

__all__ = [
    "HotSplitTables", "JoinMesh", "PartitionedTables", "ReplicatedTables", "collect_groups",
    "detect_heavy_hitters", "dist_aggregate", "dist_bulk_count", "dist_bulk_count_bcast",
    "dist_bulk_count_hier", "dist_bulk_count_ring", "dist_bulk_expand", "dist_pipeline_expand",
    "dryrun_multichip", "init_distributed", "make_join_mesh", "make_join_mesh_2d",
    "partition_tables", "partition_tables_block", "partition_tables_split", "replicate_tables",
    "run_dist_join", "spawn_ranks",
]
