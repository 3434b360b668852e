"""Process bootstrap for the distributed tier: one process a rank on
`torch.distributed`.

Port of `ccve_tpu.parallel.bootstrap`, where `jax.distributed.initialize`
wires a process into the JAX runtime. Here `init_distributed` joins a
`torch.distributed` process group and `run_dist_join` runs the distributed
join harness over it: every rank makes the same host inputs
(deterministic generators), builds its own partition and reads the same
reduced count.

Launch, one command a process:

    CCVE_COORDINATOR=host0:9731 CCVE_NUM_PROCESSES=2 CCVE_PROCESS_ID=0 \\
        python -m ccve_tpu_torch.cli dist --n-build 100000 --n-probe 1000000
    CCVE_COORDINATOR=host0:9731 CCVE_NUM_PROCESSES=2 CCVE_PROCESS_ID=1 \\
        python -m ccve_tpu_torch.cli dist ...

or with flags (--coordinator, --num-processes, --process-id), or under
`torchrun --nproc-per-node N` (its MASTER_ADDR, MASTER_PORT, RANK and
WORLD_SIZE). With none of them the run has one rank. The backend follows
the device: NCCL on the card (each rank on cuda:LOCAL_RANK, so one rank a
GPU; NCCL refuses two ranks on one device), gloo on the CPU. `--backend
gloo` with the card runs several ranks on one GPU, their collectives
staged through the host.

`spawn_ranks` runs a function on N gloo ranks, each in a process of its
own, for the tests and the dry run.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ccve_tpu_torch.device import require_device


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value else None


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device="cuda",
                     backend: str | None = None) -> dict:
    """Join the process group of this launch.

    The identity comes from the arguments, then CCVE_COORDINATOR /
    CCVE_NUM_PROCESSES / CCVE_PROCESS_ID, then torchrun's MASTER_ADDR and
    MASTER_PORT, RANK and WORLD_SIZE. `coordinator` is rank 0's host:port,
    or an init-method URL (tcp://, file://). With no coordinator and one
    process, nothing is joined: the run has one rank (a plan's mesh then
    makes its own one-rank group). The backend follows `device` (NCCL for
    cuda, gloo for cpu) unless `backend` names it; on NCCL the rank takes
    cuda:LOCAL_RANK and raises where that card does not exist.

    Returns {"initialized", "process_id", "num_processes", "backend",
    "device", "local_world_size"}."""
    device = require_device(device)
    coordinator = coordinator or os.environ.get("CCVE_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("CCVE_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("CCVE_PROCESS_ID")
    if coordinator is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        num_processes = num_processes or _env_int("WORLD_SIZE")
        process_id = process_id if process_id is not None else _env_int("RANK")
    from ccve_tpu_torch.parallel.distributed import default_backend

    backend = backend or default_backend(device)
    local_rank = _env_int("LOCAL_RANK") or 0
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the NCCL backend carries CUDA tensors: pass a CUDA device")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local_rank}: this node has "
                               f"{torch.cuda.device_count()} GPUs")
        device = torch.device("cuda", local_rank)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    out = {"initialized": False, "process_id": 0, "num_processes": 1, "backend": backend,
           "device": str(device), "local_world_size": 1}
    if coordinator is None and (num_processes is None or num_processes == 1):
        return out
    if num_processes is None or process_id is None:
        raise ValueError("a launch of several processes needs the process count and this "
                         "process's id (flags, CCVE_* or torchrun's variables)")
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    out.update(initialized=True, process_id=dist.get_rank(),
               num_processes=dist.get_world_size(),
               local_world_size=_env_int("LOCAL_WORLD_SIZE") or 1)
    return out


def run_dist_join(n_build: int = 100_000, n_probe: int = 1_000_000, n_joins: int = 1,
                  kind: str = "sorted", pipeline_levels: int = 0,
                  cross_check: bool | None = None, hierarchical: bool | None = None,
                  zipf_alpha: float | None = None, shuffle: str | None = None,
                  device="cuda", backend: str | None = None,
                  local_world_size: int = 1) -> dict:
    """The distributed join harness over every rank of the process group
    (config 5's sizes by default), or over one rank when there is none:
    deterministic tables and probes (the same on every rank), a
    hash-partitioned build, the shuffled probe, the factorized count. With
    `pipeline_levels` > 0 also the materializing `dist_pipeline_expand` over
    that many levels on the first 8192 probe rows.

    `cross_check` (default: on one rank only) recounts with the
    single-device `bulk_count` and asserts equality. `hierarchical`
    (default: on when there is more than one node and more than one GPU a
    node, nodes = ranks / `local_world_size`) runs the 2D (dcn, ici) mesh
    whose leading dim is the node boundary and `dist_bulk_count_hier`.
    `shuffle` overrides the plan: "flat" or "hier" set `hierarchical`;
    "bcast" replicates the builds (`dist_bulk_count_bcast`). `zipf_alpha`
    draws Zipf probe keys and takes the PRPD path of the flat shuffle: the
    hot keys detected on the first 262,144 probes are replicated to every
    rank and kept out of the shuffle."""
    from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table, gen_zipf_keys
    from ccve_tpu_torch.parallel import distributed as pd

    n_devices = dist.get_world_size() if dist.is_initialized() else 1
    n_local = max(int(local_world_size), 1)
    n_nodes = max(n_devices // n_local, 1)
    if cross_check is None:
        cross_check = n_devices == 1
    if shuffle == "flat":
        hierarchical = False
    elif shuffle == "hier":
        hierarchical = True
    if hierarchical is None:
        hierarchical = shuffle != "bcast" and n_nodes > 1 and n_local > 1
    if shuffle == "bcast":
        hierarchical = False

    keys, payloads = gen_rhs_table(n_build, 1)
    hot = None
    if zipf_alpha is not None:
        probe = np.stack([gen_zipf_keys(n_probe, n_build, zipf_alpha, seed=11 + j)
                          for j in range(n_joins)], axis=1).astype(np.int64)
        hot = pd.detect_heavy_hitters(probe[: min(n_probe, 262_144)])
    else:
        probe = gen_probe_table(n_probe, n_joins, n_build)
    if hierarchical and zipf_alpha is not None:
        raise ValueError("PRPD (zipf) runs on the flat shuffle; pass hierarchical=False / "
                         "--shuffle flat")

    two_d = hierarchical or (shuffle == "bcast" and n_nodes > 1 and n_local > 1)
    mesh = (pd.make_join_mesh_2d(n_nodes, n_devices // n_nodes, device, backend) if two_d
            else pd.make_join_mesh(n_devices, device, backend))
    with mesh:
        if shuffle == "bcast":
            tables = [pd.replicate_tables(keys, payloads, kind, mesh) for _ in range(n_joins)]
            counter = pd.dist_bulk_count_bcast
        else:
            if hot is not None and hot.size:
                tables = [pd.partition_tables_split(keys, payloads, n_devices, hot, kind, mesh)
                          for _ in range(n_joins)]
            else:
                tables = [pd.partition_tables(keys, payloads, n_devices, kind, mesh)
                          for _ in range(n_joins)]
            counter = pd.dist_bulk_count_hier if hierarchical else pd.dist_bulk_count
        probe_dev = torch.from_numpy(probe).to(mesh.device)
        t0 = time.perf_counter()
        res = counter(mesh, tables, probe_dev)
        count = int(res.count)  # reading the count syncs
        seconds = time.perf_counter() - t0
        out = {
            "process_id": mesh.rank,
            "num_processes": n_devices,
            "n_devices": n_devices,
            "device": str(mesh.device),
            "backend": dist.get_backend(),
            "hierarchical": bool(hierarchical),
            "shuffle": shuffle or ("hier" if hierarchical else "flat"),
            "n_build": n_build,
            "n_probe": n_probe,
            "n_joins": n_joins,
            "count": count,
            "payload_checksums": res.payload_checksums.tolist(),
            "rows_per_s": n_probe / seconds,
            "seconds": seconds,
            "timer": "host clock",
            "skew": float(res.skew),
            "overflow": bool(res.overflow),
        }
        if cross_check:
            from ccve_tpu_torch.exec.bulk import bulk_count
            from ccve_tpu_torch.ops.hash_table import build_csr, build_lp
            from ccve_tpu_torch.ops.sort_merge import build_sorted

            builder = {"sorted": build_sorted, "lp": build_lp, "csr": build_csr}[kind]
            table = builder(keys, payloads, device=mesh.device)
            ref = bulk_count([table] * n_joins, probe_dev)
            if int(ref.count) != count:
                raise AssertionError(f"distributed count {count}, one device {int(ref.count)}")
            out["cross_checked"] = True
        if pipeline_levels > 0:
            # the materializing pipeline shuffles on the flat 1D mesh (over
            # the same group: a 2D mesh means several ranks, so this mesh
            # owns no group of its own)
            pmesh = pd.make_join_mesh(n_devices, device, backend) if two_d else mesh
            levels = [pd.partition_tables(keys, payloads, n_devices, "sorted", pmesh)
                      for _ in range(pipeline_levels)]
            sub = probe[: min(n_probe, 8192), :pipeline_levels]
            if sub.shape[1] < pipeline_levels:
                sub = np.concatenate([sub] + [sub[:, :1]] * (pipeline_levels - sub.shape[1]),
                                     axis=1)
            pres = pd.dist_pipeline_expand(pmesh, levels, sub)
            out["pipeline_rows"] = int(pres.total)
            out["pipeline_overflow"] = bool(pres.overflow)
    return out


def _rank_main(fn, rank: int, world_size: int, store_path: str, args, results) -> None:
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world_size),
                                rank=rank, world_size=world_size)
        try:
            value = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:  # the parent raises with this rank's traceback
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, world_size: int, args=(), store_dir: str | None = None,
                timeout: float = 600.0) -> list:
    """`fn(*args)` on each rank of a gloo group of `world_size`, each rank a
    process of its own (the spawn start method, so `fn` is imported by
    name: it lives in a module that a fresh process can import). The group
    meets on a FileStore in a fresh directory under `store_dir` (default
    the temporary directory), so no TCP port is taken. Returns the ranks'
    return values in rank order; raises with a rank's traceback if one
    raises, and if a rank dies or the ranks take longer than `timeout`
    seconds. Every process is ended before it returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, rank, world_size, os.path.join(tmp, "store"), args,
                                   results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank died (exit codes {dead})") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world_size} ranks: no result in {timeout} s") \
                            from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
        finally:
            grace = time.monotonic() + 10  # a failed rank's peers wait in a collective
            for p in procs:
                p.join(timeout=max(grace - time.monotonic(), 0))
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[rank] for rank in range(world_size)]
