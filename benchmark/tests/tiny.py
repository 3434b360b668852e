"""The benchmark's configurations shrunk to a size that a CPU test run
holds, with the same key distributions and the same shape of join, as
cells that report the metrics of the configuration's cell. `config3`, the
four-level join, has no cell yet: its tiny cell reports the metrics of the
manifest's first cell, so that the harness and the reference are rehearsed
on a chained join too."""

from __future__ import annotations

from benchmark import manifest

# configuration -> (build rows a table, probe rows, probe keys' upper end)
SIZES = {"config1": (1000, 16000, 1000), "config3": (50, 8000, 100)}
CONFIGS = sorted(SIZES)
CELL = {w["config"]: w["name"] for w in manifest.manifest()["workloads"]}


def tiny(config: str, traffic: str = "count_closed1") -> manifest.Cell:
    root = manifest.ROOT
    body = manifest.load_json(root / "benchmark" / "configs" / f"{config}.json")
    build_rows, probe_rows, hi = SIZES[config]
    for table in body["build"]:
        table["rows"] = build_rows
    body["probe"]["rows"] = probe_rows
    for column in body["probe"]["columns"]:
        column["hi"] = hi
    mix = manifest.load_json(root / "benchmark" / "traffic" / f"{traffic}.json")
    mix.update(trace_queries=6, span_queries=4)
    workloads = manifest.manifest()["workloads"]
    cell = manifest.cell(CELL.get(config, workloads[0]["name"]))
    return manifest.Cell(name=f"{config}_tiny", chips=1, config=body, mix=mix,
                         end_to_end=cell.end_to_end, per_layer=cell.per_layer)
