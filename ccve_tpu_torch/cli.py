"""Command line of the port: `python -m ccve_tpu_torch.cli baseline --config 1`.

Only the `baseline` subcommand is ported, for config 1 with the
sort-merge engine. Other configurations and engines exit non-zero with
"not ported yet". The run goes to `--device` (default `cuda`); without a
GPU it fails unless `--device cpu` asks for the plain CPU path.
"""

from __future__ import annotations

import argparse
import json
import sys

TINY_KWARGS = {1: dict(n_build=4096, n_probe=65536)}


def cmd_baseline(args) -> int:
    from ccve_tpu_torch.bench.configs import ALL_CONFIGS

    if args.config not in ALL_CONFIGS:
        print(f"baseline --config {args.config}: not ported yet", file=sys.stderr)
        return 2
    kwargs = dict(TINY_KWARGS[args.config]) if args.tiny else {}
    if args.engine is not None:
        if args.engine != "sort_merge":
            print(f"--engine {args.engine}: not ported yet", file=sys.stderr)
            return 2
        kwargs["engine"] = args.engine
    result = ALL_CONFIGS[args.config](device=args.device, **kwargs)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ccve_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("baseline", help="run a BASELINE.json benchmark configuration")
    p.add_argument("--config", type=int, required=True, choices=[1, 2, 3, 4, 5, 6, 7])
    p.add_argument("--tiny", action="store_true", help="CI-sized workload")
    p.add_argument(
        "--engine", choices=["sort_merge", "hash_lp", "hash_csr"], default=None,
        help="probe engine for config 1 (sort_merge; the hash engines are not ported yet)",
    )
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.set_defaults(func=cmd_baseline)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
