"""BENCHMARK.json against the contract's limits, and the files it names.
CPU only; from the repository's root: python -m pytest benchmark/tests -q"""
import json
import re

import pytest

import _paths  # noqa: F401
import run

MANIFEST = run.read_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        names.append(m["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for w in MANIFEST["workloads"]:
        cell = w["name"]
        mine = {m["name"] for m in run.cell_metrics(MANIFEST, cell,
                                                    "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        layer = run.cell_metrics(MANIFEST, cell, "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in mine, (cell, m["name"])
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_exist_and_load(cell):
    c, traffic, cfg = run.load_cell(MANIFEST, cell)
    assert cfg["name"] == c["config"] and traffic["name"] == c["traffic"]
    entry = [x for x in MANIFEST["configs"] if x["name"] == c["config"]][0]
    assert entry["file"] == f"benchmark/configs/{c['config']}.json"
    assert entry["reduced"] == cfg["reduced"]
    assert (run.BENCH / "modes" / f"{traffic['mode']}.py").is_file()


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_metric_file_loads(metric):
    mod = run.load_file(run.BENCH / "metrics" / f"{metric}.py", "m_" + metric)
    assert callable(mod.read)


def test_files_under_paths_are_named_from_name_characters():
    for f in run.BENCH.rglob("*"):
        if "__pycache__" in f.parts:
            continue
        rel = str(f.relative_to(run.ROOT))
        assert PATH.match(rel), rel
