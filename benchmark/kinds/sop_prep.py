"""Traffic kind ``sop_prep``: bulk dataset preparation by S3GRL's SoP,
``precompute_sop`` over units of links, one after another, for the whole
window, called as the runner's ``precompute_split`` calls it for
``sign_type`` SoP with ``optimize_sign`` (the program's own batch size).

The traffic file's ``"source": "splits"``: the train, valid and test links
of the split, one ``precompute_sop`` call each, pass after pass. One pass
warms up.

After each unit the harness copies the rows of ``check_per_unit`` of its
links (one drawn from the seed, then the link of the largest endpoint
degrees) to the host and drops the unit's dataset. A reservoir drawn from
the seed keeps ``check_max`` of all the rows so copied, each as likely as
any other, so the host holds a fixed number of rows however many units
the window runs. Once the window has closed they are compared with the
plain reference (``benchmark/reference_sop.py``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import reference_sop, workmodel_sop
from benchmark.cellbase import (Check, Phases, TraceContext, make_inputs, program_graph,
                                ref_graph, sub_seed, sync, worst_relative_gap)

PARTS = ("train", "valid", "test")


class Run:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, dev):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.dev = seed, dev
        self.checked = []  # the reservoir: [(link [2], xs [K+1, 2, F+1], row_mask [2])]
        self.offered = 0  # rows offered to the reservoir
        self.links_done = 0
        sop = config["sop"]
        if sop["sign_type"] != "SoP" or not sop["optimize_sign"]:
            raise ValueError(f"sop_prep runs SoP with optimize_sign, not {sop}")
        if traffic["source"] != "splits":
            raise ValueError(f"unknown sop_prep source {traffic['source']!r}")
        self.sign_k = int(sop["sign_k"])

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from s3grl_tpu_torch.operators.sop import precompute_sop

        phase = Phases()
        self.precompute_sop = precompute_sop
        self.inp = make_inputs(self.config, self.seed)
        phase("inputs")
        self.dg = program_graph(self.inp, self.dev)
        self.rng = np.random.default_rng(sub_seed(self.seed, 2))
        self.deg = np.bincount(self.inp.split.observed[0], minlength=self.inp.n)
        phase("graph")
        for i in range(len(PARTS)):
            self.precompute_sop(self.dg, *self.unit(i), sign_k=self.sign_k, device=self.dev)
        sync(self.dev)
        phase("warm unit")

    def unit(self, i: int):
        """The links and labels of the ``i``-th unit of the window."""
        return self.inp.split.links(PARTS[i % len(PARTS)])

    # -- the timed path -------------------------------------------------
    def _run_unit(self, i: int, keep_rows: bool = True) -> int:
        links, y = self.unit(i)
        ds = self.precompute_sop(self.dg, links, y, sign_k=self.sign_k, device=self.dev)
        if keep_rows:
            picks = [int(self.rng.integers(len(links))),
                     int(np.argmax(self.deg[links[:, 0]] + self.deg[links[:, 1]]))]
            picks = picks[:self.traffic["check_per_unit"]]
            idx = torch.as_tensor(picks, device=ds.xs.device)
            xs = ds.xs[idx].float().cpu().numpy()
            mask = ds.row_mask[idx].cpu().numpy()
            for j, p in enumerate(picks):
                self._offer((links[p], xs[j], mask[j]))
        del ds
        return len(links)

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
        from s3grl_tpu_torch.profiling import counters

        from benchmark import trace

        n_units = self.traffic["trace_units"]
        t0 = time.perf_counter()
        links = 0
        for i in range(n_units):
            links += self._run_unit(i)
        sync(self.dev)
        unprofiled = time.perf_counter() - t0
        self.links_done = links

        counted = {}

        def active():
            before = counters()
            for i in range(n_units):
                self._run_unit(i, keep_rows=False)
            after = counters()
            counted.update({k: after[k] - before.get(k, 0) for k in after
                            if k.startswith("sop.")})

        prof = trace.profile(lambda: self._run_unit(0, keep_rows=False), active,
                             lambda: sync(self.dev))
        ctx = TraceContext(profile=prof, peaks=peaks, unprofiled_s=unprofiled)
        ctx.counts.update(counted)
        sizes = [len(self.unit(i)[0]) for i in range(n_units)]
        obs = self.inp.split.observed
        ctx.work["bsr_spmm"] = workmodel_sop.sop_work(
            workmodel_sop.nonzeros(self.inp.n, obs), self.inp.n,
            features=int(self.inp.x.shape[1]), sign_k=self.sign_k, call_links=sizes)
        ctx.counts["links"] = sum(sizes)
        return ctx

    # -- the comparison -------------------------------------------------
    def release(self) -> None:
        del self.dg

    def check(self, control: bool = False) -> list:
        rows = self.checked
        g = ref_graph(self.inp, self.dev)
        F1 = int(self.inp.x.shape[1]) + 1
        links = np.asarray([r[0] for r in rows], dtype=np.int64).reshape(-1, 2)
        got = np.asarray([r[1] for r in rows], dtype=np.float32).reshape(
            -1, self.sign_k + 1, 2, F1)
        mask = np.asarray([r[2] for r in rows], dtype=bool).reshape(-1, 2)
        want = reference_sop.sop_rows(g, links, sign_k=self.sign_k).cpu().numpy()
        # No row kept reads as a failed comparison, never as a pass.
        gap = worst_relative_gap(got, want) if len(rows) else float("inf")
        out = [Check("ops_gap", gap, self.limits["ops_gap"]),
               Check("row_mask_wrong", float((~mask).sum()), 0.0)]
        if control:
            ctl = reference_sop.sop_rows(g, links, sign_k=self.sign_k,
                                         precision="tf32").cpu().numpy()
            out.append(Check("control_ops_gap", worst_relative_gap(ctl, want),
                             self.limits["ops_gap"]))
        self.failed = sum(
            worst_relative_gap(got[i:i + 1], want[i:i + 1]) > self.limits["ops_gap"]
            for i in range(len(rows)))
        return out
