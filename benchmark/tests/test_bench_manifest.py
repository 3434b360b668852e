"""`BENCHMARK.json` against the benchmark's contract, and the files it
names."""

import json
import re

import pytest

from benchmark import manifest
from benchmark.manifest import NAME, ROOT, UNIT

M = manifest.manifest()
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]
TEXT = re.compile(r"[^\t\n\r]{1,200}")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert (ROOT / manifest.MANIFEST).stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(M["paths"]) <= 16 and 1 <= len(M["command"]) <= 32
    for path in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", path) and ".." not in path
        assert (ROOT / path).is_dir() and not path.endswith("_torch")
    for word in M["command"]:
        assert TEXT.fullmatch(word) and not word.startswith("/") and ".." not in word


def test_run_seconds_fit_the_check_with_24_cells():
    s = M["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in M["configs"]] + CELLS + [m["name"] for m in METRICS]
             + [w["traffic"] for w in M["workloads"]] + [w["config"] for w in M["workloads"]]
             + [k for c in M["configs"] for k in c["reduced"]])
    for name in names:
        assert NAME.fullmatch(name), name
    for m in METRICS:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in M[group]}) == len(M[group])
    assert len({m["name"] for m in METRICS}) == len(METRICS)


def test_entries_have_exactly_the_contract_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.fullmatch(c["source"]) and TEXT.fullmatch(c["why"])
        assert len(c["reduced"]) <= 16
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.fullmatch(w["why"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert TEXT.fullmatch(m["layer"])
    assert "setup_s" in {m["name"] for m in M["end_to_end"]}


def test_four_chip_cells_are_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(len(CELLS) // 4, 1)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_has_its_files_and_reports_enough(cell):
    c = manifest.cell(cell)
    w = {w["name"]: w for w in M["workloads"]}[cell]
    assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
    assert (ROOT / "benchmark" / "queries" / f"{c.mix['query']}.py").is_file()
    assert (ROOT / "benchmark" / "reference" / f"{c.mix['query']}.py").is_file()
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_each_configuration_file_states_its_source(config):
    assert config["file"].startswith(tuple(p + "/" for p in M["paths"]))
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["source"] == config["source"] and body["reduced"] == config["reduced"]
    for spec in [t["keys"] for t in body["build"]] + body["probe"]["columns"]:
        assert (ROOT / "benchmark" / "dists" / f"{spec['dist']}.py").is_file()
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])
    assert any(w["config"] == config["name"] for w in M["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_each_metric_has_a_reader(metric):
    base = metric["name"].split(".")[0]
    assert (ROOT / "benchmark" / "metrics" / f"{base}.py").is_file()
    assert manifest.reader(metric["name"]).__file__.endswith(f"/{base}.py")
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_moves_names_a_metric_that_its_cells_report(metric):
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric.get("workloads", CELLS):
        reported = {m["name"] for m in manifest.cell(cell).end_to_end}
        assert metric["moves"] in reported


def test_metrics_of_one_layer_name_it_alike():
    by_module = {}
    for m in M["per_layer"]:
        by_module.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values())


def test_file_names_under_paths_use_name_characters():
    for path in M["paths"]:
        for f in (ROOT / path).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", str(f.relative_to(ROOT))), f
