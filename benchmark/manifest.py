"""`BENCHMARK.json` and the files it names.

Everything that belongs to one configuration, traffic mix, query kind,
key distribution or metric is a file of its own, found by its name:

    benchmark/configs/<config>.json     (the configuration's `file`)
    benchmark/traffic/<traffic>.json    a traffic mix
    benchmark/queries/<query>.py        a query kind: calls the port
    benchmark/reference/<query>.py      its plain reference
    benchmark/dists/<dist>.py           a key distribution
    benchmark/metrics/<metric>.py       a metric's reader; `<metric>.<qualifier>`
                                        reads the same, for the cells whose
                                        end-to-end metric it is split by

so that a later change adds a cell as new files and new entries, and
edits no file that is here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = "BENCHMARK.json"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of `workloads`, with its configuration, its traffic mix
    and the metrics it reports."""

    name: str
    chips: int
    config: dict  # the configuration's file, as run
    mix: dict  # the traffic mix's file
    end_to_end: tuple  # the manifest's metric entries this cell reports
    per_layer: tuple


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / MANIFEST)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str) -> Cell:
    """The cell `name` of the manifest; raises KeyError for a name it
    does not hold."""
    m = manifest()
    entries = {w["name"]: w for w in m["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {MANIFEST}: {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in m["configs"]}
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(ROOT / configs[w["config"]]["file"]),
        mix=load_json(ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"),
        end_to_end=tuple(e for e in m["end_to_end"] if _reports(e, name)),
        per_layer=tuple(e for e in m["per_layer"] if _reports(e, name)),
    )


def plugin(kind: str, name: str) -> ModuleType:
    """The module `benchmark/<kind>/<name>.py`, loaded from its path (a
    name may hold `.` and `-`)."""
    if not NAME.fullmatch(name):
        raise ValueError(f"{kind} name {name!r} is no valid name")
    path = ROOT / "benchmark" / kind / f"{name}.py"
    module_name = re.sub(r"\W", "_", f"benchmark_{kind}_{name}")
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str) -> ModuleType:
    """The reader of `metric`: `benchmark/metrics/<name>.py`, where `name`
    is the metric's name up to its first `.`. A qualified name such as
    `query_p95_ms.serve` is the same quantity, split off for the cells
    whose end-to-end metric differs, so that each has its own bound."""
    return plugin("metrics", metric.split(".")[0])
