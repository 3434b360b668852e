"""Run a cell with the control or a fault of `benchmark.faults` in the
port's place, at the cell's own size, over several seeds in one process,
and print what the judgement read on each:

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 \
        --seconds 2 [--fault control|stale|half|altered]

Each seed's line holds the numbers compared and `correct`. It exits with 0
when `correct` came out false on every seed, as it has to, and with 1
otherwise. The benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--fault", default="control")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from benchmark import manifest
    from benchmark.faults import FAULTS
    from benchmark.harness import run_cell

    cell = manifest.cell(args.workload)
    device = torch.device(args.device)
    caught = 0
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        r = run_cell(cell, seed, args.seconds, False, device, time.perf_counter(),
                     wrap=FAULTS[args.fault])
        caught += not r["correct"]
        print(json.dumps({"workload": cell.name, "fault": args.fault, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0 if caught == len(seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
