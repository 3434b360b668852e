"""Command line of the port: `python -m ccve_tpu_torch.cli <command>`, one of
`pipeline`, `strategy-matrix`, `microbench`, `baseline`, `roofline` and
`dist`.

 - `pipeline` is the reference's main executable (`simd_compaction_sevector`,
   main.cpp:37-117), with the JAX CLI's flags and defaults plus `--device`:
   the N-way join of a generated probe table against `--join-num` build
   tables, on the cursor executor (`--executor pipeline`, the default, over
   `--table lp|csr`), the sorted-chunk executor (`--table sorted --executor
   sorted`) or the bulk engine (`--executor bulk`, any table kind).
   Strategies none, full, binary and dynamic, the last with the host bandit
   as in the JAX CLI. `--record-occupancy` keeps the per-level Zebra
   histograms of emitted-chunk occupancy; `--zebra-profile` (which implies
   it) also times each segment and writes the histograms as CSV files to
   `./zebra_log_0x<random>/`. Its stderr lines are the JAX CLI's:
   [Settings], the [Bee] timings on the host clock, [Total Time],
   [Throughput], [Result Rows] and, with `--zebra-profile`, [Zebra].
 - `strategy-matrix` runs `pipeline` on the cursor executor under every
   strategy (the reference's one binary a strategy, build_versions.sh:17-43,
   as a runtime sweep).
 - `microbench` is the reference's probe micro-benchmark
   (`simd_bench_sevector`, simd_micro_bench.cpp:35-73; `bench/micro.py`):
   the bulk, staged and phased variants over LP and CSR, in ns a key with
   each variant's tuple count, on stderr.
 - `baseline --config N` runs a benchmark configuration and prints one JSON
   line: config 1 (counting on the sort-merge engine or, with `--engine
   hash_lp|hash_csr`, on a hash table; on the sort-merge engine, with
   `--materialize`, emitting every matched triple, or with `--wide-span
   BITS` counting over int64 keys spread over 2^BITS), config 2 (the
   filtered chaining join on the cursor and sorted-chunk executors),
   config 3 (the bulk engine, the cursor executor over CSR and the
   sorted-chunk executor), config 4 (the Zipf join's pushed-down GROUP BY
   and ORDER BY, and its partition skew), config 5 (the distributed join:
   the one-device count, the flat shuffle and the broadcast join over the
   process group's ranks, or one rank; with the cost model's
   predictions), config 6 (phase-alternating selectivity on the cursor
   executor and both tuners) and config 7 (the sorted-chunk executor's
   static compaction policies and its device tuner).
 - `roofline` prints the per-operator roofline of the count-side join on
   the H100 (`bench/roofline.py`) at `--n-build` x `--n-probe`; with
   `--measured-ms` also the percent of the model's speed-of-light, and with
   `--anchor` the two STAGE_COST anchors measured on the card (the
   compare-exchange kernel's K-slope and the library sort); with `--dist`
   also the distributed cost model (`bench/dist_model.py`) at `--n-levels`
   levels.
 - `dist` is the distributed join harness (`parallel/bootstrap.py`), one
   command a process: the JAX CLI's flags (`--coordinator`,
   `--num-processes`, `--process-id`, or CCVE_COORDINATOR /
   CCVE_NUM_PROCESSES / CCVE_PROCESS_ID, or torchrun's variables; none of
   them for a one-rank run) plus `--device` and `--backend` (default: NCCL
   on the card, gloo on the CPU; `--backend gloo` runs several ranks on
   one card). It prints one JSON line a process.

The run goes to `--device` (default `cuda`); without a GPU it fails unless
`--device cpu` asks for the plain CPU path. `roofline` without `--anchor`
is arithmetic and touches no device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# the JAX CLI's --tiny sizes
TINY_KWARGS = {
    1: dict(n_build=4096, n_probe=65536),
    2: dict(lhs=5000, rhs=512, block=256),
    3: dict(lhs=4000, rhs=256, block=256),
    4: dict(n_probe=50_000, domain=1024),
    5: dict(n_build=2048, n_probe=20_000),
    6: dict(lhs=65536, rhs=2048, block=256, phase_chunks=32, segment_chunks=4),
    7: dict(lhs=16384, rhs=512, block=256, segment_chunks=4),
}
TINY_WIDE_KWARGS = dict(n_build=4096, n_probe=1 << 15)


def cmd_baseline(args) -> int:
    from ccve_tpu_torch.bench.configs import ALL_CONFIGS, config1_materialize, config1_wide

    kwargs = dict(TINY_KWARGS[args.config]) if args.tiny else {}
    if args.engine is not None or args.materialize or args.wide_span is not None:
        if args.config != 1:
            print("--engine, --materialize and --wide-span apply to --config 1 only",
                  file=sys.stderr)
            return 2
    if args.engine is not None:
        if args.engine != "sort_merge" and (args.materialize or args.wide_span is not None):
            print(f"--engine {args.engine} counts; it does not combine with "
                  "--materialize or --wide-span", file=sys.stderr)
            return 2
        if not (args.materialize or args.wide_span is not None):
            kwargs["engine"] = args.engine
    if args.wide_span is not None:
        if args.materialize:
            print("--wide-span counts; it does not combine with --materialize",
                  file=sys.stderr)
            return 2
        kwargs = dict(TINY_WIDE_KWARGS) if args.tiny else {}
        print(json.dumps(config1_wide(span_bits=args.wide_span, device=args.device, **kwargs)))
        return 0
    run = config1_materialize if args.materialize else ALL_CONFIGS[args.config]
    print(json.dumps(run(device=args.device, **kwargs)))
    return 0


def _refusal(args) -> str | None:
    """Why this `pipeline` command cannot run, or None."""
    if args.table == "sorted" and args.executor == "pipeline":
        return ("--table sorted pairs with --executor bulk or sorted (the pipelined "
                "executor's ScanStructure is a hash-table cursor)")
    if args.executor == "sorted" and args.table != "sorted":
        return "--executor sorted requires --table sorted"
    return None


def cmd_pipeline(args) -> int:
    from ccve_tpu_torch.config import CompactionStrategy, EngineConfig, PayloadMode
    from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table
    from ccve_tpu_torch.ops.hash_table import build_csr, build_lp
    from ccve_tpu_torch.device import require_device
    from ccve_tpu_torch.ops.sort_merge import build_sorted
    from ccve_tpu_torch.utils.profiler import BeeProfiler

    strategy = {
        "none": CompactionStrategy.NONE,
        "full": CompactionStrategy.FULL,
        "binary": CompactionStrategy.BINARY,
        "dynamic": CompactionStrategy.DYNAMIC,
    }[args.strategy]
    cfg = EngineConfig(
        block_size=args.block_size,
        n_joins=args.join_num,
        lhs_size=args.lhs_size,
        rhs_size=args.rhs_size,
        chunk_factor=args.chunk_factor,
        strategy=strategy,
        payload_mode=PayloadMode(args.payload),
        collect_tuples=args.collect_tuples,
        record_occupancy=args.record_occupancy or args.zebra_profile,
        tuner_segment_chunks=args.segment_chunks,
    )
    print(
        f" [Settings] #joins: {cfg.n_joins}, strategy: {strategy.value}, "
        f"table: {args.table}, executor: {args.executor}, "
        f"|LHS|: {cfg.lhs_size}, |RHS|: {cfg.rhs_size}, "
        f"chunk_factor: {cfg.chunk_factor}, block: {cfg.block_size}",
        file=sys.stderr,
    )
    refusal = _refusal(args)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    device = require_device(args.device)
    bee = BeeProfiler.get()
    with bee.time("[Generate Data]"):
        probe = gen_probe_table(cfg.lhs_size, cfg.n_joins, cfg.rhs_size)
        keys, payloads = gen_rhs_table(cfg.rhs_size, cfg.chunk_factor)
    builder = {"sorted": build_sorted, "lp": build_lp, "csr": build_csr}[args.table]
    with bee.time("[Build Hash Tables]"):
        tables = [builder(keys, payloads, device=device) for _ in range(cfg.n_joins)]

    if args.executor == "bulk":
        from ccve_tpu_torch.exec.bulk import bulk_count

        t0 = time.perf_counter()
        count = int(bulk_count(tables, probe).count)  # reading the count syncs
        elapsed = time.perf_counter() - t0
    else:
        if args.executor == "sorted":
            from ccve_tpu_torch.exec.sorted_pipeline import SortedPipeline as Executor
        else:
            from ccve_tpu_torch.exec.pipeline import JoinPipeline as Executor
        out = Executor(tables, cfg).run(
            probe, segment_chunks=args.segment_chunks, preload=args.preload,
            zebra_profile=args.zebra_profile)
        count, elapsed = out["count"], out["seconds"]
        if args.zebra_profile:
            import random

            from ccve_tpu_torch.utils.profiler import ZebraProfiler

            log_dir = f"./zebra_log_0x{random.getrandbits(32):08x}"
            ZebraProfiler.get().to_csv(log_dir)
            print(f" [Zebra] {out['zebra_segments']} measured segments -> {log_dir}/",
                  file=sys.stderr)

    print(f" [Total Time] {elapsed:.4f} s", file=sys.stderr)
    print(f" [Throughput] {cfg.lhs_size / elapsed / 1e6:.2f}M probe rows/s", file=sys.stderr)
    print(f" [Result Rows] {count}", file=sys.stderr)
    bee.end_profiling()
    return 0


def cmd_matrix(args) -> int:
    """`pipeline` on the cursor executor under each strategy in turn; exits
    non-zero if any run did."""
    rcs = []
    for strategy in ("none", "full", "binary", "dynamic"):
        sub_args = argparse.Namespace(
            join_num=args.join_num, chunk_factor=args.chunk_factor, lhs_size=args.lhs_size,
            rhs_size=args.rhs_size, block_size=args.block_size, strategy=strategy,
            table=args.table, executor="pipeline", payload="reference",
            collect_tuples=False, record_occupancy=False, segment_chunks=64, preload=False,
            zebra_profile=False, device=args.device,
        )
        print(f"\n==== strategy: {strategy} ====", file=sys.stderr)
        rcs.append(cmd_pipeline(sub_args))
    return max(rcs)


def cmd_micro(args) -> int:
    from ccve_tpu_torch.bench.micro import report, run_micro_bench

    results = run_micro_bench(scale=args.scale, hit_freq=args.hit_frequency,
                              chunk_factor=args.chunk_factor, n_keys=args.n_keys,
                              variants=tuple(args.variants.split(",")), device=args.device)
    print(report(results), file=sys.stderr)
    return 0


def cmd_roofline(args) -> int:
    from ccve_tpu_torch.bench.roofline import measure_anchors, report
    from ccve_tpu_torch.device import require_device

    device = require_device(args.device) if args.anchor else None
    measured = args.measured_ms / 1e3 if args.measured_ms else None
    print(report(args.n_build, args.n_probe, measured))
    if args.anchor:
        print(measure_anchors(device=device))
    if args.dist:
        from ccve_tpu_torch.bench.dist_model import report_dist

        print()
        print(report_dist(args.n_build, args.n_probe, args.n_levels))
    return 0


def cmd_dist(args) -> int:
    from ccve_tpu_torch.parallel.bootstrap import init_distributed, run_dist_join

    if args.zipf_alpha is not None and args.shuffle == "hier":
        print("--shuffle hier cannot be combined with --zipf-alpha: the PRPD skew path runs "
              "on the flat shuffle only. Drop one of the two flags (--shuffle auto maps to "
              "flat under --zipf-alpha).", file=sys.stderr)
        return 2
    info = init_distributed(coordinator=args.coordinator, num_processes=args.num_processes,
                            process_id=args.process_id, device=args.device,
                            backend=args.backend)
    try:
        out = run_dist_join(
            n_build=args.n_build, n_probe=args.n_probe, n_joins=args.n_joins, kind=args.kind,
            pipeline_levels=args.pipeline_levels,
            hierarchical=(None if args.shuffle == "auto" else args.shuffle == "hier")
            if args.zipf_alpha is None else False,
            zipf_alpha=args.zipf_alpha, shuffle=args.shuffle if args.shuffle != "auto" else None,
            device=info["device"], backend=info["backend"],
            local_world_size=info["local_world_size"],
        )
    finally:
        if info["initialized"]:
            import torch.distributed as dist

            dist.destroy_process_group()
    out["initialized"] = info["initialized"]
    print(json.dumps(out))
    return 0


def _add_pipeline(sub):
    p = sub.add_parser("pipeline", help="N-way join pipeline benchmark")
    p.add_argument("--join-num", type=int, default=3)
    p.add_argument("--chunk-factor", type=int, default=1)
    p.add_argument("--lhs-size", type=int, default=20_000_000)
    p.add_argument("--rhs-size", type=int, default=2_000_000)
    p.add_argument("--block-size", type=int, default=2048)
    p.add_argument(
        "--strategy", choices=["none", "full", "binary", "dynamic"], default="none",
        help="compaction strategy; 'dynamic' tunes per-level thresholds with the "
        "host bandit between segments",
    )
    p.add_argument(
        "--table", choices=["lp", "csr", "sorted"], default="csr",
        help="build-table kind; 'sorted' pairs with --executor bulk or sorted",
    )
    p.add_argument(
        "--executor", choices=["pipeline", "bulk", "sorted"], default="pipeline",
        help="'pipeline': the chunk-at-a-time cursor executor over LP or CSR tables "
        "(exec/pipeline.py); 'bulk': operator-at-a-time; 'sorted': chunk-at-a-time "
        "over sorted tables with the fused drain kernel (exec/sorted_pipeline.py)",
    )
    p.add_argument("--payload", choices=["reference", "full"], default="reference")
    p.add_argument("--collect-tuples", action="store_true")
    p.add_argument("--record-occupancy", action="store_true",
                   help="per-level chunk-occupancy histograms (the Zebra profiler's data)")
    p.add_argument("--segment-chunks", type=int, default=64)
    p.add_argument(
        "--preload", action="store_true",
        help="copy the whole chunk batch to the device before the timed window "
        "instead of streaming host chunk batches per segment",
    )
    p.add_argument("--zebra-profile", action="store_true",
                   help="measured Zebra latency per segment (implies --record-occupancy); "
                   "CSVs go to ./zebra_log_0x<random>/")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.set_defaults(func=cmd_pipeline)


def _add_matrix(sub):
    p = sub.add_parser("strategy-matrix",
                       help="the pipeline benchmark on the cursor executor under every "
                       "compaction strategy")
    p.add_argument("--join-num", type=int, default=3)
    p.add_argument("--chunk-factor", type=int, default=2)
    p.add_argument("--lhs-size", type=int, default=1_000_000)
    p.add_argument("--rhs-size", type=int, default=100_000)
    p.add_argument("--block-size", type=int, default=2048)
    p.add_argument("--table", choices=["lp", "csr"], default="csr")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.set_defaults(func=cmd_matrix)


def _add_micro(sub):
    p = sub.add_parser("microbench", help="single-join probe micro-benchmark")
    p.add_argument("--scale", type=int, default=0)
    p.add_argument("--hit-frequency", type=int, default=1)
    p.add_argument("--chunk-factor", type=int, default=1)
    p.add_argument("--n-keys", type=int, default=1 << 24)
    p.add_argument("--variants", default="bulk,staged,phased",
                   help="comma list from {bulk,staged,phased}")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.set_defaults(func=cmd_micro)


def _add_baseline(sub):
    p = sub.add_parser("baseline", help="run a BASELINE.json benchmark configuration")
    p.add_argument("--config", type=int, required=True, choices=[1, 2, 3, 4, 5, 6, 7])
    p.add_argument("--tiny", action="store_true", help="CI-sized workload")
    p.add_argument(
        "--engine", choices=["sort_merge", "hash_lp", "hash_csr"], default=None,
        help="probe engine for config 1's count (default sort_merge; hash_lp and "
        "hash_csr probe a linear-probing or a chaining table)",
    )
    p.add_argument(
        "--materialize", action="store_true",
        help="config 1 only: time the materializing join (sorted_expand_tiled "
        "emits every matched triple) instead of the count",
    )
    p.add_argument(
        "--wide-span", type=int, default=None, metavar="BITS",
        help="config 1 only: keys spread over 2^BITS (31..61), so the count "
        "side runs on int64 keys (bench.configs.config1_wide)",
    )
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.set_defaults(func=cmd_baseline)


def _add_roofline(sub):
    p = sub.add_parser(
        "roofline",
        help="per-operator roofline of the count-side join on the H100 "
        "(bench/roofline.py); --measured-ms overlays a measured time",
    )
    p.add_argument("--n-build", type=int, default=1_000_000)
    p.add_argument("--n-probe", type=int, default=16_000_000)
    p.add_argument("--measured-ms", type=float, default=None)
    p.add_argument(
        "--anchor", action="store_true",
        help="measure the STAGE_COST anchors on the card (a compare-exchange "
        "kernel that is not the engine's, and torch.sort) against the model constant",
    )
    p.add_argument("--dist", action="store_true",
                   help="also print the distributed cost model (bench/dist_model.py): bytes a "
                   "level of each plan, flat against hier against bcast, predicted scaling "
                   "efficiency over GPUs and nodes, at nominal H100 link rates")
    p.add_argument("--n-levels", type=int, default=1, help="join levels for --dist")
    p.add_argument("--device", default="cuda",
                   help="torch device of --anchor (default cuda)")
    p.set_defaults(func=cmd_roofline)


def _add_dist(sub):
    p = sub.add_parser(
        "dist",
        help="distributed join on torch.distributed, one command a process: the process "
        "identity from flags, CCVE_COORDINATOR / CCVE_NUM_PROCESSES / CCVE_PROCESS_ID or "
        "torchrun's variables (none of them for a one-rank run)",
    )
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0, or an init-method URL (tcp://, file://)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--n-build", type=int, default=100_000)
    p.add_argument("--n-probe", type=int, default=1_000_000)
    p.add_argument("--n-joins", type=int, default=1)
    p.add_argument("--kind", choices=["sorted", "lp", "csr"], default="sorted")
    p.add_argument("--pipeline-levels", type=int, default=0,
                   help="also run the materializing dist_pipeline_expand over this many "
                   "levels on the first 8192 probe rows")
    p.add_argument("--zipf-alpha", type=float, default=None,
                   help="Zipf-skewed probe keys with this exponent and PRPD: the detected "
                   "hot keys are replicated to every rank and kept out of the shuffle (flat "
                   "shuffle only)")
    p.add_argument("--shuffle", choices=["auto", "flat", "hier", "bcast"], default="auto",
                   help="the plan: 'hier' = 2D (node, local GPU) mesh with the two-hop "
                   "shuffle (keys cross nodes once, node-aggregated); 'bcast' = replicated "
                   "builds, no per-key traffic; 'auto' picks hier for more than one node of "
                   "more than one GPU")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="process-group backend (default: nccl on the card, gloo on the CPU)")
    p.set_defaults(func=cmd_dist)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ccve_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_pipeline(sub)
    _add_micro(sub)
    _add_matrix(sub)
    _add_baseline(sub)
    _add_roofline(sub)
    _add_dist(sub)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
