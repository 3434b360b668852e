"""Command line of the port: `python -m ccve_tpu_torch.cli pipeline|baseline|roofline`.

 - `pipeline` is the reference's main executable (`simd_compaction_sevector`,
   main.cpp:37-117), with the JAX CLI's flags and defaults plus `--device`:
   the N-way join of a generated probe table against `--join-num` build
   tables, on the sorted-chunk executor (`--table sorted --executor
   sorted`, strategies none, full, binary and dynamic, the last with the
   host bandit as in the JAX CLI) or the bulk engine (`--executor bulk`,
   any table kind). `--record-occupancy` keeps the per-level Zebra
   histograms of emitted-chunk occupancy; `--zebra-profile` (which implies
   it) also times each segment and writes the histograms as CSV files to
   `./zebra_log_0x<random>/`. Its stderr lines are the JAX CLI's:
   [Settings], the [Bee] timings on the host clock, [Total Time],
   [Throughput], [Result Rows] and, with `--zebra-profile`, [Zebra]. The
   cursor executor (`--executor pipeline`, ROADMAP Queue 1, slice 6) exits
   2 with "not ported yet".
 - `baseline --config N` runs a benchmark configuration and prints one JSON
   line: config 1 (counting on the sort-merge engine or, with `--engine
   hash_lp|hash_csr`, on a hash table; on the sort-merge engine, with
   `--materialize`, emitting every matched triple, or with `--wide-span
   BITS` counting over int64 keys spread over 2^BITS), config 3 (the bulk
   engine and the sorted-chunk executor) and config 7 (the sorted-chunk
   executor's static compaction policies and its device tuner). Other
   configurations exit non-zero with "not ported yet".
 - `roofline` prints the per-operator roofline of the count-side join on
   the H100 (`bench/roofline.py`) at `--n-build` x `--n-probe`; with
   `--measured-ms` also the percent of the model's speed-of-light, and with
   `--anchor` the two STAGE_COST anchors measured on the card (the
   compare-exchange kernel's K-slope and the library sort). `--dist` and
   `--n-levels` (the distributed cost model, ROADMAP Queue 1, slice 9) exit
   2 with "not ported yet".

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
    3: dict(lhs=4000, rhs=256, block=256),
    7: dict(lhs=16384, rhs=512, block=256, segment_chunks=4),
}
TINY_WIDE_KWARGS = dict(n_build=4096, n_probe=1 << 15)


def cmd_baseline(args) -> int:
    from ccve_tpu_torch.bench.configs import ALL_CONFIGS, config1_materialize, config1_wide

    if args.config not in ALL_CONFIGS:
        print(f"baseline --config {args.config}: not ported yet", file=sys.stderr)
        return 2
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
    if args.executor == "pipeline":
        return ("--executor pipeline (the cursor executor, ROADMAP Queue 1, slice 6): "
                "not ported yet")
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
        from ccve_tpu_torch.exec.sorted_pipeline import SortedPipeline

        out = SortedPipeline(tables, cfg).run(
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


def cmd_roofline(args) -> int:
    if args.dist or args.n_levels is not None:
        print("--dist and --n-levels (the distributed cost model, ROADMAP Queue 1): "
              "not ported yet (slice 9)", file=sys.stderr)
        return 2
    from ccve_tpu_torch.bench.roofline import measure_anchors, report
    from ccve_tpu_torch.device import require_device

    device = require_device(args.device) if args.anchor else None
    measured = args.measured_ms / 1e3 if args.measured_ms else None
    print(report(args.n_build, args.n_probe, measured))
    if args.anchor:
        print(measure_anchors(device=device))
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
        help="'pipeline': the chunk-at-a-time cursor executor (not ported yet, "
        "ROADMAP Queue 1, slice 6); 'bulk': operator-at-a-time; 'sorted': "
        "chunk-at-a-time over sorted tables with the fused drain kernel "
        "(exec/sorted_pipeline.py)",
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
                   help="the distributed cost model: not ported yet (slice 9)")
    p.add_argument("--n-levels", type=int, default=None,
                   help="join levels for --dist: not ported yet (slice 9)")
    p.add_argument("--device", default="cuda",
                   help="torch device of --anchor (default cuda)")
    p.set_defaults(func=cmd_roofline)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ccve_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_pipeline(sub)
    _add_baseline(sub)
    _add_roofline(sub)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
