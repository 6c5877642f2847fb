"""A copy of the benchmark's tree at sizes the CPU runs in seconds: the
same files and names, smaller graphs, widths and windows."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

SMALL_GRAPH = {"usair_pos": {"n": 40}, "blogcatalog_pos": {"n": 300, "n_undirected": 2000}}
SMALL_TRAFFIC = {"prep_stream_4096": {"chunk_links": 64},
                 "score_open_1_256": {"max_links": 16, "size_block": 8, "trace_requests": 4,
                                       "rate_per_s": 50.0},
                 "fit_5_epochs": {"epochs": 2}}


def _edit(path: str, fn) -> None:
    with open(path) as f:
        data = json.load(f)
    fn(data)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def make_tiny(dest: str) -> tuple[str, str]:
    """Write the tiny tree under ``dest``; returns (root, bench_dir)."""
    bench = os.path.join(dest, "benchmark")
    for sub in ("configs", "workloads", "limits", "readers"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(bench, sub))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    for name, graph in SMALL_GRAPH.items():
        def small(c, graph=graph):
            c["graph"].update(graph)
            c["model"]["hidden_channels"] = 16
            c["features"]["max_degree"] = 16
            c["pos"].update(buckets=[32, 64, 128], max_subgraph_nodes=128)
        _edit(os.path.join(bench, "configs", name + ".json"), small)
    for name, fields in SMALL_TRAFFIC.items():
        _edit(os.path.join(bench, "workloads", name + ".json"), lambda t, f=fields: t.update(f))
    return dest, bench


def cells() -> list:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]
