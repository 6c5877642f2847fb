"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root, and under ``benchmark/`` one file per configuration
(``configs/<config>.json``), per traffic mix (``workloads/<traffic>.json``,
whose ``kind`` names a module ``kinds/<kind>.py``), per cell's limits
(``limits/<cell>.json``) and per per-layer metric (``readers/<metric>.py``).
A new cell, configuration or metric is new files and new entries here,
never an edit.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(name: str, what: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{what} name {name!r} is not a benchmark name")
    return name


@dataclass
class Cell:
    """Everything one run of one cell needs, found by name."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the end-to-end metrics this cell reports
    per_layer: list  # the per-layer metrics this cell reports

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: str, bench_dir: str = HERE) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``, with its files
    under ``bench_dir``. Raises KeyError for a name the file lacks and
    FileNotFoundError for a piece that is missing."""
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    config = _load_json(os.path.join(bench_dir, "configs", _named(w["config"], "config") + ".json"))
    traffic = _load_json(os.path.join(bench_dir, "workloads",
                                      _named(w["traffic"], "traffic") + ".json"))
    limits = _load_json(os.path.join(bench_dir, "limits", _named(workload, "cell") + ".json"))
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if ("workloads" in m and workload in m["workloads"])
             or ("workloads" not in m and m["moves"] in reported)]
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=layer)


def kind_module(kind: str):
    """``benchmark.kinds.<kind>``: the general generator and driver of one
    kind of traffic."""
    return importlib.import_module(f"benchmark.kinds.{_named(kind, 'kind')}")


def reader(metric: str, bench_dir: str = HERE):
    """The ``read(ctx)`` function of ``readers/<metric>.py``."""
    path = os.path.join(bench_dir, "readers", _named(metric, "metric") + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_reader_{metric}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
