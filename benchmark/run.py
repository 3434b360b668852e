"""Run one cell of `BENCHMARK.json` once on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root. The last line of standard output is the
result, one JSON object; the last lines of standard error are the numbers
that decided `correct`, each beside its limit. Without a CUDA card, or with
fewer cards than the cell asks for, it exits with 2 and prints no result;
on any failure it prints no result either.
"""

import time

T0 = time.perf_counter()  # before the heavy imports: set-up counts them

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import manifest
    from benchmark.harness import run_cell

    log(f"set-up: imports {time.perf_counter() - T0:.3f} s")

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on one", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.cuda.synchronize()  # the card's context
    log(f"set-up: the card's start {time.perf_counter() - T0:.3f} s")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T0, log=log)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
