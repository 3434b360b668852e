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

Ported so far (ROADMAP Queue 1, slices 1 to 3 and slice 5's bulk path):
the count-side join (`exec.bulk.bulk_count` over one
`ops.sort_merge.SortedTable`), per-probe stats and ranks
(`sorted_match_stats`, `sorted_match_ranks`), N-level `bulk_count`, and
the materializing join (`sorted_expand`, `sorted_expand_tiled`,
`exec.bulk.bulk_materialize`); the count side, stats and ranks also on
int64 keys (key spans from 2^30 to 2^62); and the hash engines
(`ops.hash_table` LP and CSR tables, `ops.hashing` murmur64) under
`bulk_count` and `bulk_materialize`.
"""
