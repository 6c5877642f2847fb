"""Traffic kind ``prep``: bulk dataset preparation, ``precompute_pos`` over
units of links, one after another, for the whole window.

The traffic file says where the units come from:
- ``"source": "stream"``: chunks of ``chunk_links`` links, half train
  positives (each edge once, in an order drawn from the seed, then the
  other orientation) and half non-edges of the observed graph drawn from
  the seed; no link repeats until the stream is spent (BlogCatalog's
  holds 277 chunks), then it starts again. One chunk, drawn apart, warms up.
- ``"source": "splits"``: the train, valid and test links of the split,
  one ``precompute_pos`` call each, pass after pass. One pass warms up.

After each unit the harness copies the rows of ``check_per_unit`` of its
links (one drawn from the seed, then the link of the largest endpoint
degrees) to the host and drops the unit's dataset. Once the window has
closed, ``check_max`` of those rows, drawn from the seed, are compared with
the plain reference.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import graphs, reference, workmodel
from benchmark.cellbase import (Check, Phases, TraceContext, make_inputs, pos_keywords, program_graph,
                                ref_graph, ref_keywords, sub_seed, sync, worst_relative_gap)


class Run:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, dev):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.dev = seed, dev
        self.checked = []  # [(link [2], xs [K+1, R, F+1], row_mask [R])]
        self.links_done = 0

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from s3grl_tpu_torch.operators.pos import precompute_pos

        phase = Phases()
        self.precompute_pos = precompute_pos
        self.inp = make_inputs(self.config, self.seed)
        phase("inputs")
        self.dg = program_graph(self.inp, self.dev)
        self.kw = pos_keywords(self.config, self.seed, self.dev)
        self.rng = np.random.default_rng(sub_seed(self.seed, 2))
        self.deg = np.bincount(self.inp.split.observed[0], minlength=self.inp.n)
        if self.traffic["source"] == "stream":
            self._make_stream()
            warm = self._chunk(-1)
        elif self.traffic["source"] == "splits":
            warm = None
        else:
            raise ValueError(f"unknown prep source {self.traffic['source']!r}")
        phase("graph and stream")
        for links, y in ([warm] if warm else [self.inp.split.links(p)
                                               for p in ("train", "valid", "test")]):
            self.precompute_pos(self.dg, links, y, **self.kw)
        sync(self.dev)
        phase("warm unit")

    def _make_stream(self) -> None:
        sp = self.inp.split
        up = sp.train_pos[sp.train_pos[:, 0] < sp.train_pos[:, 1]]
        up = up[self.rng.permutation(len(up))]
        self.pos = np.concatenate([up, up[:, ::-1]])
        keys = np.sort(sp.observed[0].astype(np.int64) * self.inp.n + sp.observed[1])
        self.neg = graphs.sample_non_edges(self.rng, self.inp.n, keys, len(self.pos),
                                           unordered=False)
        self.half = int(self.traffic["chunk_links"] * self.traffic["positive_share"])
        self.n_chunks = len(self.pos) // self.half - 1  # the last chunk warms up

    def _chunk(self, c: int):
        if c < 0:
            c = self.n_chunks
        h = self.half
        n_neg = self.traffic["chunk_links"] - h
        links = np.concatenate([self.pos[c * h:(c + 1) * h],
                                self.neg[c * n_neg:(c + 1) * n_neg]]).astype(np.int32)
        y = np.concatenate([np.ones(h), np.zeros(n_neg)]).astype(np.float32)
        return links, y

    def unit(self, i: int):
        """The links and labels of the ``i``-th unit of the window."""
        if self.traffic["source"] == "stream":
            return self._chunk(i % self.n_chunks)
        return self.inp.split.links(("train", "valid", "test")[i % 3])

    # -- the timed path -------------------------------------------------
    def _run_unit(self, i: int, keep_rows: bool = True) -> int:
        links, y = self.unit(i)
        ds = self.precompute_pos(self.dg, links, y, **self.kw)
        if keep_rows:
            picks = [int(self.rng.integers(len(links))),
                     int(np.argmax(self.deg[links[:, 0]] + self.deg[links[:, 1]]))]
            picks = picks[:self.traffic["check_per_unit"]]
            idx = torch.as_tensor(picks, device=ds.xs.device)
            xs = ds.xs[idx].float().cpu().numpy()
            mask = ds.row_mask[idx].cpu().numpy()
            self.checked += [(links[p], xs[j], mask[j]) for j, p in enumerate(picks)]
        del ds
        return len(links)

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
        import s3grl_tpu_torch.operators.pos as pos_module

        n_units = self.traffic["trace_units"]
        t0 = time.perf_counter()
        links = 0
        for i in range(n_units):
            links += self._run_unit(i)
        sync(self.dev)
        unprofiled = time.perf_counter() - t0
        self.links_done = links

        seen = []  # the links of the active step's local_table calls
        armed = []
        built = getattr(pos_module, "local_table", None)

        def recording(*args, **kwargs):
            if armed:
                seen.append(args[4] if len(args) > 4 else kwargs["links"])
            return built(*args, **kwargs)

        def active():
            armed.append(True)
            for i in range(n_units):
                self._run_unit(i, keep_rows=False)

        warm_unit = n_units if self.traffic["source"] == "stream" else 0
        if built is not None:
            pos_module.local_table = recording
        try:
            prof = trace.profile(lambda: self._run_unit(warm_unit, keep_rows=False), active,
                                 lambda: sync(self.dev))
        finally:
            if built is not None:
                pos_module.local_table = built
        ctx = TraceContext(profile=prof, peaks=peaks, unprofiled_s=unprofiled)
        all_links = np.concatenate([self.unit(i)[0] for i in range(n_units)])
        g = ref_graph(self.inp, self.dev)
        kw = ref_keywords(self.config)
        w = workmodel.link_work(g, all_links, num_hops=kw["num_hops"], max_nodes=kw["max_nodes"])
        ctx.work["pos"] = workmodel.pos_work(w, features=int(self.inp.x.shape[1]),
                                             sign_k=kw["sign_k"])
        ctx.counts["links"] = len(all_links)
        if seen:
            got = np.concatenate([t.cpu().numpy().reshape(-1, 2) for t in seen]).astype(np.int64)
            n = self.inp.n
            where = {k: i for i, k in enumerate(all_links[:, 0].astype(np.int64) * n
                                                + all_links[:, 1])}
            idx = np.asarray([where[k] for k in got[:, 0] * n + got[:, 1]], dtype=np.int64)
            ctx.work["local_table"] = workmodel.local_table_work({k: v[idx] for k, v in w.items()})
        return ctx

    # -- the comparison -------------------------------------------------
    def release(self) -> None:
        del self.dg

    def check(self, control: bool = False) -> list:
        rng = np.random.default_rng(sub_seed(self.seed, 3))
        rows = self.checked
        if len(rows) > self.traffic["check_max"]:
            pick = rng.choice(len(rows), self.traffic["check_max"], replace=False)
            rows = [rows[i] for i in sorted(pick)]
        g = ref_graph(self.inp, self.dev)
        links = np.stack([r[0] for r in rows])
        want = reference.pos_rows(g, links, **ref_keywords(self.config)).cpu().numpy()
        got = np.stack([r[1] for r in rows])
        mask = np.stack([r[2] for r in rows])
        out = [Check("ops_gap", worst_relative_gap(got, want), self.limits["ops_gap"]),
               Check("row_mask_wrong", float((~mask.astype(bool)).sum()), 0.0)]
        if control:
            ctl = reference.pos_rows(g, links, precision="tf32",
                                     **ref_keywords(self.config)).cpu().numpy()
            out.append(Check("control_ops_gap", worst_relative_gap(ctl, want),
                             self.limits["ops_gap"]))
        self.failed = sum(
            worst_relative_gap(got[i:i + 1], want[i:i + 1]) > self.limits["ops_gap"]
            for i in range(len(rows)))
        return out
