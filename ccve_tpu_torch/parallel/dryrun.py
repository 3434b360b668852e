"""A dry run of every distributed plan at tiny shapes.

The port's twin of `__graft_entry__.dryrun_multichip`, with its sizes and
its asserts (2 levels, 256 build rows, 1024 probe rows, cap slack 8), over
all of the distributed plans: the flat shuffle on mixed sorted and CSR
levels, the materializing single-level and bounded N-level joins, the
hierarchical shuffle, the broadcast join, and two that the JAX dry run
leaves out, the ring and the PRPD split. Each count is held to the
one-device `bulk_count` over an LP table.
"""

from __future__ import annotations

import torch.distributed as dist

from ccve_tpu_torch.parallel import distributed as pd


def _dryrun_rank(n_devices: int, device) -> dict:
    """The dry run on this rank of a group of `n_devices` ranks (one rank
    on a group of its own when there is none). Returns what each plan
    gave, the same on every rank."""
    from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table
    from ccve_tpu_torch.exec.bulk import bulk_count
    from ccve_tpu_torch.ops.hash_table import build_lp

    n_joins, rhs, lhs = 2, 256, 1024
    keys, payloads = gen_rhs_table(rhs, 1)
    probe = gen_probe_table(lhs, n_joins, rhs)
    got = {}

    def check(name, res):
        out = (int(res.count), res.payload_checksums.tolist())
        if bool(res.overflow):
            raise AssertionError(f"{name}: a send bucket overflowed")
        if out != got["bulk_count"]:
            raise AssertionError(f"{name}: count and checksums {out}, one device "
                                 f"{got['bulk_count']}")
        got[name] = out

    with pd.make_join_mesh(n_devices, device) as mesh:
        ref = bulk_count([build_lp(keys, payloads, device=mesh.device)] * n_joins, probe)
        want = (int(ref.count), ref.payload_checksums.tolist())
        got["bulk_count"] = want

        # mixed sort-merge and CSR levels: both local-table paths
        ptables = [pd.partition_tables(keys, payloads, n_devices, kind, mesh)
                   for kind in ("sorted", "csr")]
        check("flat", pd.dist_bulk_count(mesh, ptables, probe, cap_slack=8.0))

        rexp = pd.dist_bulk_expand(mesh, ptables[0], probe[:, 0], cap_slack=8.0)
        if bool(rexp.overflow) or int(rexp.total) != int(rexp.counts.sum()):
            raise AssertionError(f"dist_bulk_expand: total {int(rexp.total)}, counts "
                                 f"{rexp.counts.tolist()}, overflow {bool(rexp.overflow)}")
        got["expand"] = int(rexp.total)

        # the N-level join with the bounded carry (level_caps)
        plevels = [pd.partition_tables(keys, payloads, n_devices, "sorted", mesh)
                   for _ in range(n_joins)]
        pres = pd.dist_pipeline_expand(mesh, plevels, probe, cap_slack=8.0,
                                       level_caps=[4 * lhs // n_devices] * n_joins)
        if bool(pres.overflow) or int(pres.total) != want[0]:
            raise AssertionError(f"dist_pipeline_expand: total {int(pres.total)}, overflow "
                                 f"{bool(pres.overflow)}; one device {want[0]}")
        got["pipeline"] = int(pres.total)

        blocks = [pd.partition_tables_block(keys, payloads, n_devices, kind, mesh)
                  for kind in ("lp", "csr")]
        check("ring", pd.dist_bulk_count_ring(mesh, blocks, probe))

        hot = pd.detect_heavy_hitters(probe[:, 0], max_hot=8, min_frac=0.01)
        split = [pd.partition_tables_split(keys, payloads, n_devices, hot, "lp", mesh),
                 pd.partition_tables(keys, payloads, n_devices, "csr", mesh)]
        check("prpd", pd.dist_bulk_count(mesh, split, probe, cap_slack=8.0))

    n_hosts = 2 if n_devices >= 4 else 1
    with pd.make_join_mesh_2d(n_hosts, n_devices // n_hosts, device) as mesh2:
        ptables2 = [pd.partition_tables(keys, payloads, n_devices, "lp", mesh2)
                    for _ in range(n_joins)]
        check("hier", pd.dist_bulk_count_hier(mesh2, ptables2, probe, cap_slack=8.0))
        rtables = [pd.replicate_tables(keys, payloads, kind, mesh2)
                   for kind in ("sorted", "csr")]
        check("bcast", pd.dist_bulk_count_bcast(mesh2, rtables, probe))
    return got


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One step of every distributed plan over `n_devices` ranks. Called on
    every rank of a running group of that size, it runs there; with no
    group it runs one rank in this process (n_devices 1) or spawns
    `n_devices` gloo ranks computing on `device` (`bootstrap.spawn_ranks`).
    Returns what each plan gave; raises if any plan disagrees with the
    one-device count."""
    if dist.is_initialized() or n_devices == 1:
        return _dryrun_rank(n_devices, device)
    from ccve_tpu_torch.parallel.bootstrap import spawn_ranks

    results = spawn_ranks(_dryrun_rank, n_devices, args=(n_devices, str(device)))
    if any(r != results[0] for r in results):
        raise AssertionError(f"the ranks disagree: {results}")
    return results[0]


if __name__ == "__main__":
    import sys

    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                           sys.argv[2] if len(sys.argv) > 2 else "cuda"))
