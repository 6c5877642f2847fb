"""What the kinds of traffic share: the inputs a configuration and a seed
make, the program's graph on the device, the comparisons, and what a traced
run hands the readers."""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from benchmark import graphs
from benchmark.reference import RefGraph


def sub_seed(seed: int, *tags: int) -> int:
    """A seed for one use of the run's ``seed``, below 2**63."""
    return int(np.random.SeedSequence([seed, *tags]).generate_state(2, np.uint64)[0] >> 1)


class Phases:
    """Prints, on standard error, the seconds each phase of set-up took."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"setup {name} {now - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = now


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class Inputs:
    """A configuration's graph (fixed by its own seed, as a dataset is), the
    split and negatives drawn from the run's seed, and the features."""

    n: int
    full: np.ndarray  # [2, E] the whole graph, symmetrized
    split: graphs.Split
    x: np.ndarray  # [n, F] float32 features of the observed graph


def make_inputs(config: dict, seed: int) -> Inputs:
    n, full = graphs.make_graph(config["graph"])
    sp = config["split"]
    split = graphs.split_edges(n, full, np.random.default_rng(sub_seed(seed, 1)),
                               sp["val_ratio"], sp["test_ratio"])
    feat = config["features"]
    if feat["kind"] != "one_hot_degree":
        raise ValueError(f"unknown features {feat['kind']!r}")
    x = graphs.one_hot_degree(n, split.observed, feat["max_degree"])
    return Inputs(n=n, full=full, split=split, x=x)


def ref_graph(inp: Inputs, dev) -> RefGraph:
    return RefGraph(inp.n, inp.split.observed, inp.x, dev)


def program_graph(inp: Inputs, dev):
    """The program's ``DeviceGraph`` of the observed graph and features."""
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph

    return DeviceGraph.from_graph(Graph(num_nodes=inp.n, edge_index=inp.split.observed, x=inp.x),
                                  device=dev)


def pos_keywords(config: dict, seed: int, dev) -> dict:
    """``precompute_pos``' keywords as the configuration states them."""
    p = config["pos"]
    return dict(num_hops=p["num_hops"], sign_k=p["sign_k"], buckets=tuple(p["buckets"]),
                batch_size=p["extract_batch_size"], max_subgraph_nodes=p["max_subgraph_nodes"],
                seed=seed % (1 << 31), device=dev)


def ref_keywords(config: dict) -> dict:
    p = config["pos"]
    return dict(num_hops=p["num_hops"], sign_k=p["sign_k"], max_nodes=p["max_subgraph_nodes"])


def worst_relative_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Over the leading axis: max |got - want| / max |want| of each entry's
    block; the largest of these. A block whose shape or finiteness is wrong
    reads infinity."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    if got.size == 0:
        return 0.0
    axes = tuple(range(1, got.ndim))
    diff = np.abs(got - want).max(axis=axes) if axes else np.abs(got - want)
    scale = np.abs(want).max(axis=axes) if axes else np.abs(want)
    return float((diff / np.maximum(scale, 1e-30)).max())


@dataclass
class TraceContext:
    """What a traced run measured, for the readers."""

    profile: Optional[object] = None  # trace.Profile of the profiled slice
    peaks: Optional[dict] = None  # the card's published peaks, None if unknown
    unprofiled_s: Optional[float] = None  # host seconds of the unprofiled slice
    work: dict = field(default_factory=dict)  # name -> (bytes, FLOP) the data needs
    counts: dict = field(default_factory=dict)  # name -> a count (steps, links)


@dataclass
class Check:
    """One number compared with its limit: correct where value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)
