"""A cell's inputs, made on the device from `--seed`.

One `torch.Generator` on the run's device draws, in this order: each
build table's keys (its payloads are the row + `payload_base`, as the
source's tables have them), then the pool's probe batches column by
column, then the pool's first batch. The same seed gives the same inputs;
every seed gives the same sizes.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.manifest import plugin

DTYPES = {"int32": torch.int32, "int64": torch.int64}


@dataclasses.dataclass
class Inputs:
    build: list  # [(keys, payloads)], one a level, on the device
    pool: list  # [probe batch [rows, levels]] on the device
    start: int  # the pool's batch that the first query takes


def make_inputs(config: dict, mix: dict, seed: int, device) -> Inputs:
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)  # any whole number, as the 64-bit word it takes
    build = []
    for table in config["build"]:
        spec = table["keys"]
        keys = plugin("dists", spec["dist"]).draw(
            gen, table["rows"], spec, DTYPES[table["key_dtype"]])
        payloads = torch.arange(table["rows"], dtype=DTYPES[table["payload_dtype"]],
                                device=device) + table["payload_base"]
        build.append((keys, payloads))
    probe = config["probe"]
    rows = probe["rows"]
    dtype = DTYPES[probe["dtype"]]
    columns = [(spec, plugin("dists", spec["dist"])) for spec in probe["columns"]]
    pool = []
    for _ in range(mix["pool_batches"]):
        batch = torch.empty((rows, len(columns)), dtype=dtype, device=device)
        for j, (spec, dist) in enumerate(columns):
            batch[:, j] = dist.draw(gen, rows, spec, dtype)
        pool.append(batch)
    start = int(torch.randint(0, len(pool), (1,), generator=gen, device=device))
    return Inputs(build=build, pool=pool, start=start)
