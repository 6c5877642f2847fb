"""BENCHMARK.json and the files it names: every piece parses, every lookup
by name finds its file, and the file keeps the contract's shape."""
import json
import os
import re

import pytest

from benchmark import spec
from benchmark.tests.tiny import BENCH, ROOT, cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def one_line(text):
    """A ``why``, ``layer``, ``source`` or command word: 1 to 200
    characters on one line, with no tab."""
    return isinstance(text, str) and 1 <= len(text) <= 200 and not any(
        c in text for c in "\n\r\t")


def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1].startswith("benchmark/")
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32 and all(one_line(w) for w in b["command"])
    assert all(not w.startswith("/") and ".." not in w.split("/") for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    # A full check of 24 cells fits its time: 2 + 14 runs a cell, each
    # allowed run_seconds + 60 s, 2 x 90 s a cell to compile, 1,200 s spare.
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("path", sorted(
    os.path.join(d, f) for d in ("configs", "workloads", "limits") for f in
    os.listdir(os.path.join(BENCH, d))))
def test_every_data_file_parses(path):
    with open(os.path.join(BENCH, path)) as f:
        data = json.load(f)
    assert isinstance(data, dict) and data


def test_configs_are_named_files_used_by_cells():
    b = bench_json()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_cells_keep_the_contract():
    b = bench_json()
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and one_line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"]) == len({w["name"] for w in b["workloads"]})


def test_metrics_keep_the_contract():
    b = bench_json()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert {"name", "unit", "better", "bound", "source"} <= set(m) <= {
            "name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cell_names = set(cells())
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and one_line(m["layer"])
        assert m["better"] in ("lower", "higher") and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= cell_names
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("cell", cells())
def test_each_cell_finds_its_pieces(cell):
    c = spec.load_cell(cell, ROOT)
    assert c.chips == 1
    assert spec.kind_module(c.kind).Run
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no_such.cell", ROOT)
    with pytest.raises(ValueError):
        spec.reader("../run")
