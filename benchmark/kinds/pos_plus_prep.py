"""Traffic kind ``pos_plus_prep``: bulk dataset preparation by S3GRL's PoS
Plus, ``precompute_pos`` with the configuration's CCN keywords
(``k_heuristic``, ``k_node_set_strategy``, ``max_ccn_nodes``) over units of
links, one after another, for the whole window, as the runner's
``precompute_split`` calls it.

The configuration's graph and features come from
``benchmark/graphs_planetoid.py`` (its generator and feature kind by name),
the split from the run's seed by ``benchmark/graphs.split_edges``.

The traffic file's ``"source": "splits"``: the train, valid and test links
of the split, one ``precompute_pos`` call each, pass after pass. One pass
warms up.

After each unit the harness copies the rows and row masks of
``check_per_unit`` of its links (one drawn from the seed, then the link
with the most common neighbours, so that CCN rows are always compared) to
the host and drops the unit's dataset. A reservoir drawn from the seed
keeps ``check_max`` of all the rows so copied, each as likely as any other.
Once the window has closed they are compared with the plain reference
(``benchmark/reference_pos_plus.py``): ``ops_gap``, the worst relative gap
of a link's [K+1, R, F+1] block, and ``row_mask_wrong``, the rows whose
mask differs from the reference's 2 + |CCN|.

Set-up compares the same two links of each split of its warm pass (one
drawn, one with the most common neighbours) first: a program that fails
there, as one that stores the dataset in bfloat16 or leaves CCN rows out
does, cannot run this configuration, and the run stops with exit 1 before
any measurement.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import graphs, graphs_planetoid, reference_pos_plus, workmodel, workmodel_pos_plus
from benchmark.cellbase import (Check, Inputs, Phases, TraceContext, pos_keywords, program_graph,
                                ref_graph, sub_seed, sync, worst_relative_gap)

PARTS = ("train", "valid", "test")


def make_inputs(config: dict, seed: int) -> Inputs:
    """The configuration's generated graph and features (fixed by their own
    seeds, as a dataset is) and the split drawn from the run's ``seed``."""
    spec = config["graph"]
    kw = {k: v for k, v in spec.items() if k not in ("generator", "seed")}
    full = graphs_planetoid.GENERATORS[spec["generator"]](spec["seed"], **kw)
    n = int(kw["n"])
    sp = config["split"]
    split = graphs.split_edges(n, full, np.random.default_rng(sub_seed(seed, 1)),
                               sp["val_ratio"], sp["test_ratio"])
    feat = config["features"]
    fkw = {k: v for k, v in feat.items() if k not in ("kind", "seed")}
    x = graphs_planetoid.FEATURES[feat["kind"]](feat["seed"], n, **fkw)
    return Inputs(n=n, full=full, split=split, x=x)


class Run:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, dev):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.dev = seed, dev
        self.checked = []  # the reservoir: [(link [2], xs [K+1, R, F+1], row_mask [R])]
        self.offered = 0  # rows offered to the reservoir
        self.links_done = 0
        p = config["pos"]
        if p["sign_type"] != "PoS" or not p["optimize_sign"] or p["k_heuristic"] <= 0:
            raise ValueError(f"pos_plus_prep runs PoS with CCN rows and optimize_sign, not {p}")
        if traffic["source"] != "splits":
            raise ValueError(f"unknown pos_plus_prep source {traffic['source']!r}")
        self.ref_kw = dict(num_hops=p["num_hops"], sign_k=p["sign_k"],
                           max_nodes=p["max_subgraph_nodes"], strategy=p["k_node_set_strategy"])

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from s3grl_tpu_torch.operators.pos import precompute_pos

        phase = Phases()
        self.precompute_pos = precompute_pos
        self.inp = make_inputs(self.config, self.seed)
        phase("inputs")
        self.dg = program_graph(self.inp, self.dev)
        p = self.config["pos"]
        self.kw = pos_keywords(self.config, self.seed, self.dev)
        self.kw.update(k_heuristic=p["k_heuristic"], k_node_set_strategy=p["k_node_set_strategy"],
                       max_ccn=p["max_ccn_nodes"])
        self.rng = np.random.default_rng(sub_seed(self.seed, 2))
        g = ref_graph(self.inp, "cpu")
        self.ccn = [workmodel_pos_plus.ccn_sizes(g, self.inp.split.links(part)[0],
                                                 strategy=p["k_node_set_strategy"],
                                                 max_nodes=p["max_subgraph_nodes"])
                    for part in PARTS]
        phase("graph")
        warm = []
        pick_rng = np.random.default_rng(sub_seed(self.seed, 4))
        for i in range(len(PARTS)):
            links, y = self.unit(i)
            ds = self.precompute_pos(self.dg, links, y, **self.kw)
            warm += self._rows(ds, links, [int(pick_rng.integers(len(links))),
                                           int(np.argmax(self.ccn[i]))])
            del ds
        sync(self.dev)
        phase("warm unit")
        # A program whose warm pass fails the comparison (a dataset stored
        # below float32, or CCN rows left out) cannot run this configuration:
        # no measurement, exit 1.
        failed = [c for c in self._compare(warm) if not c.ok]
        if failed:
            raise SystemExit("benchmark: the warm pass's rows fail their checks: " + ", ".join(
                f"{c.name} {c.value!r} > {c.limit!r}" for c in failed))
        phase("warm rows checked")

    def unit(self, i: int):
        """The links and labels of the ``i``-th unit of the window."""
        return self.inp.split.links(PARTS[i % len(PARTS)])

    # -- the timed path -------------------------------------------------
    def _run_unit(self, i: int, keep_rows: bool = True) -> int:
        links, y = self.unit(i)
        ds = self.precompute_pos(self.dg, links, y, **self.kw)
        if keep_rows:
            picks = [int(self.rng.integers(len(links))),
                     int(np.argmax(self.ccn[i % len(PARTS)]))]
            for row in self._rows(ds, links, picks[:self.traffic["check_per_unit"]]):
                self._offer(row)
        del ds
        return len(links)

    @staticmethod
    def _rows(ds, links: np.ndarray, picks: list) -> list:
        """[(link, xs [K+1, R, F+1], row_mask [R])] of ``picks``, on the host."""
        idx = torch.as_tensor(picks, device=ds.xs.device)
        xs = ds.xs[idx].float().cpu().numpy()
        mask = ds.row_mask[idx].cpu().numpy()
        return [(links[p], xs[j], mask[j]) for j, p in enumerate(picks)]

    def _offer(self, row) -> None:
        """Reservoir sampling: the n-th row offered replaces a kept one
        with chance check_max / n."""
        self.offered += 1
        if len(self.checked) < self.traffic["check_max"]:
            self.checked.append(row)
            return
        j = int(self.rng.integers(self.offered))
        if j < len(self.checked):
            self.checked[j] = row

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            self.links_done += self._run_unit(i)
            i += 1
        sync(self.dev)
        elapsed = time.perf_counter() - t0
        return {"prep_links_per_s": self.links_done / elapsed, "window_s": elapsed,
                "attempted": self.links_done}

    # -- the traced run -------------------------------------------------
    def trace(self, peaks) -> TraceContext:
        from benchmark import trace

        n_units = self.traffic["trace_units"]
        t0 = time.perf_counter()
        links = 0
        for i in range(n_units):
            links += self._run_unit(i)
        sync(self.dev)
        unprofiled = time.perf_counter() - t0
        self.links_done = links

        def active():
            for i in range(n_units):
                self._run_unit(i, keep_rows=False)

        prof = trace.profile(lambda: self._run_unit(0, keep_rows=False), active,
                             lambda: sync(self.dev))
        ctx = TraceContext(profile=prof, peaks=peaks, unprofiled_s=unprofiled)
        all_links = np.concatenate([self.unit(i)[0] for i in range(n_units)])
        ccn = np.concatenate([self.ccn[i % len(PARTS)] for i in range(n_units)])
        kw = self.ref_kw
        w = workmodel.link_work(ref_graph(self.inp, self.dev), all_links,
                                num_hops=kw["num_hops"], max_nodes=kw["max_nodes"])
        ctx.work["pos"] = workmodel_pos_plus.pos_plus_work(
            w, ccn, features=int(self.inp.x.shape[1]), sign_k=kw["sign_k"])
        ctx.counts["links"] = len(all_links)
        return ctx

    # -- the comparison -------------------------------------------------
    def release(self) -> None:
        del self.dg

    def check(self, control: bool = False) -> list:
        return self._compare(self.checked, control)

    def _compare(self, rows: list, control: bool = False) -> list:
        """The checks of ``rows`` against the reference; sets ``failed``."""
        if not rows:  # nothing kept reads as a failed comparison, never as a pass
            return [Check("ops_gap", float("inf"), self.limits["ops_gap"]),
                    Check("row_mask_wrong", float("inf"), 0.0)]
        g = ref_graph(self.inp, self.dev)
        links = np.asarray([r[0] for r in rows], dtype=np.int64).reshape(-1, 2)
        width = max(r[1].shape[1] for r in rows)
        want, want_mask = (t.cpu().numpy() for t in reference_pos_plus.pos_plus_rows(
            g, links, width=width, **self.ref_kw))
        R = want.shape[2]
        got = np.zeros(want.shape, np.float32)
        mask = np.zeros(want_mask.shape, bool)
        for i, (_, xs, m) in enumerate(rows):
            got[i, :, :xs.shape[1]] = xs
            mask[i, :m.shape[0]] = m
        out = [Check("ops_gap", worst_relative_gap(got, want), self.limits["ops_gap"]),
               Check("row_mask_wrong", float((mask != want_mask).sum()), 0.0)]
        if control:
            ctl, _ = reference_pos_plus.pos_plus_rows(g, links, width=R, precision="tf32",
                                                      **self.ref_kw)
            out.append(Check("control_ops_gap", worst_relative_gap(ctl.cpu().numpy(), want),
                             self.limits["ops_gap"]))
        self.failed = sum(
            worst_relative_gap(got[i:i + 1], want[i:i + 1]) > self.limits["ops_gap"]
            or bool((mask[i] != want_mask[i]).any())
            for i in range(len(rows)))
        return out
