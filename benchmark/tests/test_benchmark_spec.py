"""BENCHMARK.json against the contract's shape, and every name it holds
found in a file of its own."""

import json
import re
from pathlib import Path

import pytest

from benchmark.run import ROOT, cell_metrics, load_spec, resolve

SPEC = load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_are_exactly_the_contracts():
    assert set(SPEC) == KEYS["top"]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry["name"]


def test_names_units_and_lines_use_only_allowed_characters():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert LINE.match(entry[key]), (entry["name"], key)
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for section in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[section]}) == len(SPEC[section])
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert all(LINE.match(w) and len(w) <= 200 for w in SPEC["command"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_paths_and_command_stay_inside_the_benchmark():
    assert SPEC["paths"] == ["benchmark"]
    for word in SPEC["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert word.startswith("benchmark/")
    assert 1 <= SPEC["run_seconds"] <= 51


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in layer for layer in layers)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_resolves_to_its_files(cell):
    w, cfg, mix = resolve(SPEC, cell)
    assert w["chips"] == 1
    assert (ROOT / "benchmark" / "drivers" / f"{cfg['entry']}.py").is_file()
    assert (ROOT / "benchmark" / "traffic" / f"{mix['kind']}.py").is_file()
    assert {"source", "assumed", "reduced", "limits", "precision"} <= set(cfg)
    assert cfg["reduced"] == []
    e2e = [m["name"] for m in cell_metrics(SPEC, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = [m["name"] for m in cell_metrics(SPEC, cell, True)]
    assert per_layer
    moved = {m["moves"] for m in cell_metrics(SPEC, cell, True)}
    assert moved <= set(e2e)


def test_every_config_is_used_and_has_its_own_file():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("benchmark/") and (ROOT / f).is_file()
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_every_metric_has_a_reader():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        path = ROOT / "benchmark" / "metrics" / f"{m['name']}.py"
        assert path.is_file(), path
        assert "def read(rec)" in path.read_text()
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in SPEC["workloads"]}


def test_gitignore_keeps_runs_out_of_the_tree():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored and "chiprun_out/" in ignored
    assert not any(Path(p).suffix == ".so" for p in (ROOT / "benchmark").rglob("*"))
