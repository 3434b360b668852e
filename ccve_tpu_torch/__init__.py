"""ccve_tpu_torch — the PyTorch and CUDA port of ccve_tpu.

The same query-execution engine, written for an NVIDIA Hopper GPU: plain
tensor code is PyTorch, and every Pallas kernel of `ccve_tpu` on a ported
path is a CUDA C++ kernel for `sm_90a` (`kernels/csrc/`), built with nvcc on
first use and called through ctypes. Each kernel has a plain PyTorch version
beside it in the same module; a wrapper runs that plain version for CPU
tensors only, and for CUDA tensors launches its kernel or raises.

The layout mirrors `ccve_tpu` (core/, ops/, kernels/, exec/, bench/, cli.py)
so that each counterpart is easy to find. This package never imports JAX
nor `ccve_tpu` (whose `__init__` imports JAX); the host code it needs from
there is carried as numpy code.

Ported (every slice of ROADMAP Queue 1):
the count-side join (`exec.bulk.bulk_count` over one
`ops.sort_merge.SortedTable`), per-probe stats and ranks
(`sorted_match_stats`, `sorted_match_ranks`), N-level `bulk_count`, and
the materializing join (`sorted_expand`, `sorted_expand_tiled`,
`exec.bulk.bulk_materialize`); the count side, stats and ranks also on
int64 keys (key spans from 2^30 to 2^62); and the hash engines
(`ops.hash_table` LP and CSR tables, `ops.hashing` murmur64) under
`bulk_count` and `bulk_materialize`; and the chunk-at-a-time executor with
chunk compaction over sorted tables (`core.chunk`, `ops.compactor`,
`ops.filter`, `exec.pipeline`, `exec.sorted_pipeline.SortedPipeline`, the
fused drain `kernels.drain`), with DYNAMIC compaction on the host and
device bandits (`control`), the Zebra occupancy histograms and profilers
(`utils.profiler`) and the per-chunk rank mode (`kernels.chunk_probe`);
the cursor executor over hash tables (`exec.pipeline.JoinPipeline`); and
slice 8, config 4's group-by and sort: `ops.aggregate` (hash, dense and
join-pushed aggregates, the partition histogram), `ops.sort` (the LSD
radix sort), the Zipf key generator, the hash partition
(`parallel.distributed._owner`) and the device CSR build
(`ops.hash_table.build_csr_device`); and slice 9, the distributed tier
(`parallel`: the flat, ring, hierarchical, broadcast and PRPD joins, the
materializing joins and the aggregate on `torch.distributed`, the
bootstrap, the cost model `bench.dist_model`, config 5 and `cli dist`).
"""
