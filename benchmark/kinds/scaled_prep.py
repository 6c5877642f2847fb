"""Traffic kind ``scaled_prep``: bulk dataset preparation by S3GRL's PoS
Plus on ScaLed's random-walk subgraphs, ``precompute_pos`` with the
configuration's walk keywords (``m``, ``M``) and CCN keywords over units of
links, one after another, for the whole window, as the runner's
``precompute_split`` calls it.

The configuration's graph and features come from
``benchmark/graphs_planetoid.py``, as ``pos_plus_prep``'s do; the split
from the configuration's own fixed seed (``split.seed``), so that every run
has the same links, CCN widths and batches. The run's seed drives the
walks (``precompute_pos``' ``seed``) and the links checked.

The traffic file's ``"source": "splits"``: the train, valid and test links
of the split, one ``precompute_pos`` call each, pass after pass. One pass
warms up.

After each unit the harness copies the rows and row masks of
``check_per_unit`` of its links (one drawn from the seed, then the link
with the most CCN rows in its walk subgraph, by the reference's walks) to
the host and drops the unit's dataset; ``pos_plus_prep``'s reservoir keeps
``check_max`` of them. Once the window has closed they are compared with
the plain reference (``benchmark/reference_scaled.py``), which works each
link's walks out again from the call's seed and the link's place in its
call: ``ops_gap``, the worst relative gap of a link's [K+1, R, F+1] block,
and ``row_mask_wrong``, the rows whose mask differs from the reference's
2 + |CCN|.

Set-up compares the same two links of each split of its warm pass first:
a program that fails there cannot run this configuration, and the run
stops with exit 1 before any measurement.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import graphs, graphs_planetoid, reference_scaled, workmodel_pos_plus
from benchmark import workmodel_scaled
from benchmark.cellbase import (Check, Inputs, Phases, TraceContext, pos_keywords, program_graph,
                                ref_graph, sub_seed, sync, worst_relative_gap)
from benchmark.kinds import pos_plus_prep

PARTS = pos_plus_prep.PARTS


def make_inputs(config: dict) -> Inputs:
    """The configuration's generated graph and features and its split, all
    fixed by the configuration's own seeds."""
    spec = config["graph"]
    kw = {k: v for k, v in spec.items() if k not in ("generator", "seed")}
    full = graphs_planetoid.GENERATORS[spec["generator"]](spec["seed"], **kw)
    n = int(kw["n"])
    sp = config["split"]
    split = graphs.split_edges(n, full, np.random.default_rng(sp["seed"]), sp["val_ratio"],
                               sp["test_ratio"])
    feat = config["features"]
    fkw = {k: v for k, v in feat.items() if k not in ("kind", "seed")}
    x = graphs_planetoid.FEATURES[feat["kind"]](feat["seed"], n, **fkw)
    return Inputs(n=n, full=full, split=split, x=x)


class Run(pos_plus_prep.Run):
    """``pos_plus_prep``'s run, window and reservoir, with walk subgraphs:
    a kept row also holds the link's place in its call, which seeds its
    walks."""

    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, dev):
        super().__init__(config, traffic, limits, seed, dev)
        p = config["pos"]
        if not (p["m"] > 0 and p["M"] > 0):
            raise ValueError(f"scaled_prep runs ScaLed's walks, m and M above 0, not {p}")
        self.ref_kw = dict(seed=seed % (1 << 31), rw_m=p["m"], rw_M=p["M"], sign_k=p["sign_k"],
                           strategy=p["k_node_set_strategy"], max_ccn=p["max_ccn_nodes"])

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from s3grl_tpu_torch.operators.pos import precompute_pos

        phase = Phases()
        self.precompute_pos = precompute_pos
        self.inp = make_inputs(self.config)
        phase("inputs")
        self.dg = program_graph(self.inp, self.dev)
        p = self.config["pos"]
        self.kw = pos_keywords(self.config, self.seed, self.dev)
        self.kw.update(k_heuristic=p["k_heuristic"], k_node_set_strategy=p["k_node_set_strategy"],
                       max_ccn=p["max_ccn_nodes"], rw_m=p["m"], rw_M=p["M"])
        self.rng = np.random.default_rng(sub_seed(self.seed, 2))
        g = ref_graph(self.inp, "cpu")
        kw = self.ref_kw
        self.work = []
        for part in PARTS:
            links = self.inp.split.links(part)[0]
            self.work.append(workmodel_scaled.walk_work(
                g, links, reference_scaled.link_seeds(kw["seed"], np.arange(len(links))),
                rw_m=kw["rw_m"], rw_M=kw["rw_M"], strategy=kw["strategy"],
                max_ccn=kw["max_ccn"]))
        self.ccn = [ccn for _, ccn in self.work]
        phase("walks")
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
        failed = [c for c in self._compare(warm) if not c.ok]
        if failed:
            raise SystemExit("benchmark: the warm pass's rows fail their checks: " + ", ".join(
                f"{c.name} {c.value!r} > {c.limit!r}" for c in failed))
        phase("warm rows checked")

    @staticmethod
    def _rows(ds, links: np.ndarray, picks: list) -> list:
        """[(link, its place in the call, xs [K+1, R, F+1], row_mask [R])]
        of ``picks``, on the host."""
        idx = torch.as_tensor(picks, device=ds.xs.device)
        xs = ds.xs[idx].float().cpu().numpy()
        mask = ds.row_mask[idx].cpu().numpy()
        return [(links[p], p, xs[j], mask[j]) for j, p in enumerate(picks)]

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
        units = [self.work[i % len(PARTS)] for i in range(n_units)]
        w = {k: np.concatenate([u[0][k] for u in units]) for k in units[0][0]}
        ccn = np.concatenate([u[1] for u in units])
        ctx.work["pos"] = workmodel_pos_plus.pos_plus_work(
            w, ccn, features=int(self.inp.x.shape[1]), sign_k=self.ref_kw["sign_k"])
        ctx.counts["links"] = len(ccn)
        return ctx

    # -- the comparison -------------------------------------------------
    def _compare(self, rows: list, control: bool = False) -> list:
        """The checks of ``rows`` against the reference; sets ``failed``."""
        if not rows:  # nothing kept reads as a failed comparison, never as a pass
            return [Check("ops_gap", float("inf"), self.limits["ops_gap"]),
                    Check("row_mask_wrong", float("inf"), 0.0)]
        g = ref_graph(self.inp, self.dev)
        links = np.asarray([r[0] for r in rows], dtype=np.int64).reshape(-1, 2)
        index = np.asarray([r[1] for r in rows], dtype=np.int64)
        width = max(r[2].shape[1] for r in rows)
        want, want_mask = (t.cpu().numpy() for t in reference_scaled.scaled_rows(
            g, links, index, width=width, **self.ref_kw))
        got = np.zeros(want.shape, np.float32)
        mask = np.zeros(want_mask.shape, bool)
        for i, (_, _, xs, m) in enumerate(rows):
            got[i, :, :xs.shape[1]] = xs
            mask[i, :m.shape[0]] = m
        out = [Check("ops_gap", worst_relative_gap(got, want), self.limits["ops_gap"]),
               Check("row_mask_wrong", float((mask != want_mask).sum()), 0.0)]
        if control:
            ctl, _ = reference_scaled.scaled_rows(g, links, index, width=want.shape[2],
                                                  precision="tf32", **self.ref_kw)
            out.append(Check("control_ops_gap", worst_relative_gap(ctl.cpu().numpy(), want),
                             self.limits["ops_gap"]))
        self.failed = sum(
            worst_relative_gap(got[i:i + 1], want[i:i + 1]) > self.limits["ops_gap"]
            or bool((mask[i] != want_mask[i]).any())
            for i in range(len(rows)))
        return out
