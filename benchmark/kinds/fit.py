"""Traffic kind ``fit``: training, ``fit_signnet`` run after run for the
whole window on the datasets set-up precomputed.

Each run trains a fresh model for ``epochs`` epochs with the evaluation of
the valid and test links every ``eval_steps`` epochs, seeded from the run's
seed and its index, as a user who trains model after model on one prepared
dataset does. The rate counts train links times epochs over all the work and
all the time of the window (the run that crosses its end is finished and
counted, with its time).

Set-up's warm run is the checked one: the same call on the same datasets,
its first ``check_steps`` steps recorded by a forward hook on the program's
model (each step's logits) and an optimizer hook (the first gradient as Adam
takes it, worked out from its state after one step, and the parameters
after the last of those steps); the hooks are gone before the window opens.
Once the window has closed the plain reference, trained from the same seed
on its own operator rows of the same batches, follows those steps; the
set-up's operator rows of those batches and of ``check_links`` more links
drawn from the seed are held against the reference's. Later steps are not
compared: float32 and float64 runs part by rounding as training goes on.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from benchmark import reference, workmodel
from benchmark.cellbase import (Check, Phases, TraceContext, make_inputs, pos_keywords,
                                program_graph, ref_graph, ref_keywords, sub_seed, sync,
                                worst_relative_gap)

PARTS = ("train", "valid", "test")
# The program's SIGNNet state-dict names of the reference's trained leaves.
LEAVES = {
    "w1": "operator_diff.lins.0.weight", "b1": "operator_diff.lins.0.bias",
    "g1": "operator_diff.norms.0.weight", "be1": "operator_diff.norms.0.bias",
    "w2": "link_pred_mlp.lins.0.weight", "b2": "link_pred_mlp.lins.0.bias",
    "g2": "link_pred_mlp.norms.0.weight", "be2": "link_pred_mlp.norms.0.bias",
    "w3": "link_pred_mlp.lins.1.weight", "b3": "link_pred_mlp.lins.1.bias",
}


class Run:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, dev):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.dev = seed, dev

    def run_seed(self, r: int) -> int:
        return sub_seed(self.seed, 4, r)

    def setup(self) -> None:
        from s3grl_tpu_torch.operators.pos import precompute_pos
        from s3grl_tpu_torch.train.loop import fit_signnet

        phase = Phases()
        self.fit_signnet = fit_signnet
        self.inp = make_inputs(self.config, self.seed)
        self.links = {p: self.inp.split.links(p) for p in PARTS}
        phase("inputs")
        dg = program_graph(self.inp, self.dev)
        kw = pos_keywords(self.config, self.seed, self.dev)
        self.ds = {p: precompute_pos(dg, *self.links[p], **kw) for p in PARTS}
        del dg
        sync(self.dev)
        phase("datasets")
        self._recorded_run()
        sync(self.dev)
        phase("warm run")

    def _fit(self, epochs: int, seed: int):
        m = self.config["model"]
        return self.fit_signnet(
            self.ds["train"], self.ds["valid"], self.ds["test"],
            sign_k=self.config["pos"]["sign_k"], hidden_channels=m["hidden_channels"],
            batch_size=m["batch_size"], lr=m["lr"], dropout=m["dropout"], epochs=epochs,
            eval_steps=self.traffic["eval_steps"], seed=seed, device=self.dev)

    def _recorded_run(self) -> None:
        """Set-up's warm run, its first steps recorded by hooks that are
        removed when it ends."""
        n = self.traffic["check_steps"]
        rec = {"seed": self.run_seed(0), "logits": [], "steps": 0, "names": {}}

        def on_forward(module, args, output):
            if module.training and type(module).__name__ == "SIGNNet" and len(rec["logits"]) < n:
                rec["logits"].append(output.detach().clone())
                rec["names"] = {id(q): k for k, q in module.named_parameters()}

        def on_step(opt, args, kwargs):
            rec["steps"] += 1
            params = [q for g in opt.param_groups for q in g["params"]]
            if rec["steps"] == 1:
                beta1 = opt.param_groups[0]["betas"][0]
                rec["grad0"] = {rec["names"][id(q)]: opt.state[q]["exp_avg"] / (1.0 - beta1)
                                for q in params if "exp_avg" in opt.state[q]}
            if rec["steps"] == n:
                rec["params"] = {rec["names"][id(q)]: q.detach().clone() for q in params}

        hooks = [torch.nn.modules.module.register_module_forward_hook(on_forward),
                 register_optimizer_step_post_hook(on_step)]
        try:
            self._fit(self.traffic["warm_epochs"], rec["seed"])
        finally:
            for h in hooks:
                h.remove()
        self.record = rec

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        runs = 0
        while time.perf_counter() - t0 < seconds:
            runs += 1
            self._fit(self.traffic["epochs"], self.run_seed(runs))
        sync(self.dev)
        elapsed = time.perf_counter() - t0
        links = len(self.links["train"][0]) * self.traffic["epochs"] * runs
        return {"fit_links_per_s": links / elapsed, "window_s": elapsed, "attempted": runs}

    def trace(self, peaks) -> TraceContext:
        from benchmark import trace

        t0 = time.perf_counter()
        self._fit(self.traffic["epochs"], self.run_seed(1))
        sync(self.dev)
        unprofiled = time.perf_counter() - t0
        prof = trace.profile(lambda: self._fit(1, self.run_seed(2)),
                             lambda: self._fit(1, self.run_seed(3)), lambda: sync(self.dev))
        m = self.config["model"]
        L = len(self.links["train"][0])
        steps = -(-L // m["batch_size"])
        d_in = (self.config["pos"]["sign_k"] + 1) * (self.inp.x.shape[1] + 1)
        n_eval = len(self.links["valid"][0]) + len(self.links["test"][0])
        per_epoch = (steps * workmodel.signnet_flops(rows=m["batch_size"], d_in=d_in,
                                                     hidden=m["hidden_channels"], train=True)
                     + workmodel.signnet_flops(rows=n_eval, d_in=d_in,
                                               hidden=m["hidden_channels"], train=False))
        ctx = TraceContext(profile=prof, peaks=peaks, unprofiled_s=unprofiled)
        ctx.work["signnet"] = (0.0, per_epoch * self.traffic["epochs"])
        ctx.counts["steps"] = steps
        return ctx

    def _checked_links(self) -> dict:
        """Per split, the indices whose operator rows are compared: the
        recorded steps' batches (train) and ``check_links`` drawn from the
        seed over the three splits."""
        rng = np.random.default_rng(sub_seed(self.seed, 9))
        sizes = [len(self.links[p][0]) for p in PARTS]
        drawn = rng.choice(sum(sizes), self.traffic["check_links"], replace=False)
        bounds = np.cumsum([0] + sizes)
        idx = {p: np.sort(drawn[(drawn >= bounds[i]) & (drawn < bounds[i + 1])] - bounds[i])
               for i, p in enumerate(PARTS)}
        idx["train"] = np.union1d(idx["train"], self._batch_order())
        return idx

    def _batch_order(self) -> np.ndarray:
        """The train links of the recorded steps, in order: the first
        epoch's permutation from the run's seed, as the train loop draws it."""
        B = self.config["model"]["batch_size"]
        L = len(self.links["train"][0])
        perm = np.random.default_rng(self.record["seed"]).permutation(L)
        return perm[:self.traffic["check_steps"] * B]

    def release(self) -> None:
        """Copy the checked operator rows to the host; free the program's."""
        self.idx = self._checked_links()
        self.rows = {p: self.ds[p].xs[torch.as_tensor(self.idx[p], device=self.ds[p].xs.device)]
                     .float().cpu().numpy() for p in PARTS}
        del self.ds

    def check(self, control: bool = False) -> list:
        """The comparisons of the recorded steps; with ``control`` the same
        numbers for the reference computed in TF32 in the program's place."""
        g = ref_graph(self.inp, self.dev)
        rk = ref_keywords(self.config)
        links = {p: self.links[p][0][self.idx[p]] for p in PARTS}
        want = {p: reference.pos_rows(g, links[p], **rk) for p in PARTS}
        ref = self._reference(want["train"], "float64")
        out = self._compare("", self.rows, self._program_steps(), ref, want)
        if control:
            ctl_rows = {p: reference.pos_rows(g, links[p], precision="tf32", **rk) for p in PARTS}
            ctl = self._reference(ctl_rows["train"], "tf32")
            out += self._compare("control_", {p: ctl_rows[p].cpu().numpy() for p in PARTS},
                                 ctl, ref, want)
        self.failed = 0 if all(c.ok for c in out if not c.name.startswith("control_")) else 1
        return out

    def _reference(self, train_rows: torch.Tensor, precision: str) -> dict:
        """The reference's steps from the recorded run's seed, on its own
        rows (``train_rows``: of ``self.idx["train"]``) of the same batches."""
        m = self.config["model"]
        B = m["batch_size"]
        arith = reference.Arith(precision)
        d_in = train_rows.shape[1] * train_rows.shape[3]
        p = reference.init_params(self.record["seed"], d_in, m["hidden_channels"], self.dev,
                                  arith.dtype)
        start = {k: p[k].clone() for k in reference.TRAINED}
        where = {int(i): j for j, i in enumerate(self.idx["train"])}
        order = self._batch_order()
        y = torch.as_tensor(self.links["train"][1], device=self.dev)
        batches = []
        for s in range(self.traffic["check_steps"]):
            ids = order[s * B:(s + 1) * B]
            rows = train_rows[torch.as_tensor([where[int(i)] for i in ids], device=self.dev)]
            batches.append((rows.to(arith.dtype),
                            torch.ones(len(ids), rows.shape[2], dtype=torch.bool, device=self.dev),
                            y[torch.as_tensor(ids, device=self.dev)]))
        gen = torch.Generator(device=self.dev).manual_seed(self.record["seed"] + 1)
        if precision == "tf32" and self.dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = True
        try:
            out = reference.first_steps(p, batches, gen, lr=m["lr"],
                                        weight_decay=m["weight_decay"], dropout=m["dropout"],
                                        arith=arith)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        out["start"] = start
        return out

    def _program_steps(self) -> dict:
        """The recorded run in the reference's names; what it lacks stays out."""
        rec = self.record
        return {"logits": rec["logits"],
                "grad0": {k: rec["grad0"][LEAVES[k]] for k in LEAVES
                          if LEAVES[k] in rec.get("grad0", {})},
                "params": {k: rec["params"][LEAVES[k]] for k in LEAVES
                           if LEAVES[k] in rec.get("params", {})}}

    @staticmethod
    def _worst_leaf(got: dict, want: dict, leaves) -> float:
        """Over ``leaves``: |norm(got) - norm(want)| over the larger of
        norm(want) and the median leaf's; infinity where a leaf is missing."""
        norms = {k: float(want[k].double().norm()) for k in want}
        med = float(np.median(list(norms.values())))
        worst = 0.0
        for k in leaves:
            if k not in got:
                return float("inf")
            gap = abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], med)
            worst = max(worst, gap)
        return worst

    def _compare(self, prefix: str, rows: dict, run: dict, ref: dict, want: dict) -> list:
        lim = self.limits
        ops = max(worst_relative_gap(rows[p], want[p].cpu().numpy()) for p in PARTS)
        logit = float("inf")
        if len(run["logits"]) == self.traffic["check_steps"]:
            logit = max(worst_relative_gap(a.double().cpu().numpy()[None],
                                           b.double().cpu().numpy()[None])
                        for a, b in zip(run["logits"], ref["logits"]))
        grad = self._worst_leaf(run["grad0"], ref["grad0"], reference.TRAINED)
        # Leaves whose first gradient is nought to rounding move by round-off
        # alone: under a thousandth of the median leaf's, they are left out.
        g_norm = {k: float(ref["grad0"][k].double().norm()) for k in reference.TRAINED}
        g_med = float(np.median(list(g_norm.values())))
        moved = [k for k in reference.TRAINED if g_norm[k] >= 1e-3 * g_med]
        got_change = {k: run["params"][k].double().to(self.dev) - ref["start"][k].double()
                      for k in run["params"]}
        want_change = {k: ref["params"][k].double() - ref["start"][k].double()
                       for k in reference.TRAINED}
        change = self._worst_leaf(got_change, want_change, moved)
        return [Check(prefix + "ops_gap", ops, lim["ops_gap"]),
                Check(prefix + "logit_gap", logit, lim["logit_gap"]),
                Check(prefix + "grad_gap", grad, lim["grad_gap"]),
                Check(prefix + "change_gap", change, lim["change_gap"])]
