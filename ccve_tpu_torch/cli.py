"""Command line of the port: `python -m ccve_tpu_torch.cli baseline --config N`.

Only the `baseline` subcommand is ported: config 1 (counting on the
sort-merge engine or, with `--engine hash_lp|hash_csr`, on a hash table;
on the sort-merge engine, with `--materialize`, emitting every matched
triple, or with `--wide-span BITS` counting over int64 keys spread over
2^BITS) and config 3's bulk engine. Other configurations exit non-zero
with "not ported yet". The run goes to `--device` (default `cuda`);
without a GPU it fails unless `--device cpu` asks for the plain CPU path.
"""

from __future__ import annotations

import argparse
import json
import sys

# the JAX CLI's --tiny sizes (its config-3 `block` belongs to the
# chunk-at-a-time executors, which are not ported)
TINY_KWARGS = {1: dict(n_build=4096, n_probe=65536), 3: dict(lhs=4000, rhs=256)}
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ccve_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
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
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
