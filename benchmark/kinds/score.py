"""Traffic kind ``score``: on-demand link scoring, requests arriving in an
open loop at ``rate_per_s``.

Independent callers send requests on a schedule whatever the server is
doing; the program serves them one at a time, in order of arrival. A
request holds candidate links: ``positive_share`` test positives, the rest
non-edges of the whole graph, drawn from the run's seed. Its size comes
from blocks of ``size_block`` sizes spread log-uniformly over
[``min_links``, ``max_links``] and its gap after the previous request from
blocks of as many exponential gaps of mean 1 / ``rate_per_s``, each block
in an order drawn from ``schedule_seed``: every run sends the same sizes
at the same times, and the seed draws the links. (With the order drawn
from the run's seed, the order set the queue: the 95th percentile read
588-895 ms from seed to seed while two runs of one seed agreed within 2 %.)
The program answers a request with ``precompute_pos`` and then
SIGNNet's forward pass in eval mode, as ``fit_signnet``'s ``predict_all``
does, with weights the harness makes on the device from the seed. A
request's latency runs from when it was due to its scores on the host, so
it counts the wait behind earlier requests; every request due in the window
is served.

Once the window has closed, ``check_requests`` finished requests, the
largest among them, are scored again by the plain reference.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import graphs, reference
from benchmark.cellbase import (Check, Phases, TraceContext, make_inputs, pos_keywords, program_graph,
                                ref_graph, ref_keywords, sub_seed, sync)
from benchmark.kinds.fit import LEAVES


def block_gaps(rate: float, n: int) -> np.ndarray:
    """``n`` gaps in seconds: the quantiles at the midpoints of equal steps
    of an exponential law of mean 1 / ``rate``."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


def block_sizes(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` request sizes: the floors of the ``n`` quantiles at the
    midpoints of equal steps of a log-uniform law on [lo, hi + 1)."""
    q = (np.arange(n) + 0.5) / n
    return np.floor(lo * ((hi + 1) / lo) ** q).astype(np.int64)


class Run:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, dev):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.dev = seed, dev
        self.done = []  # [(links, scores, seconds)]

    def setup(self) -> None:
        from s3grl_tpu_torch.models.signnet import SIGNNet
        from s3grl_tpu_torch.operators.pos import precompute_pos
        from s3grl_tpu_torch.train.loop import flat_operators

        self.precompute_pos, self.flat_operators = precompute_pos, flat_operators
        t = self.traffic
        phase = Phases()
        self.inp = make_inputs(self.config, self.seed)
        phase("inputs")
        self.dg = program_graph(self.inp, self.dev)
        self.kw = pos_keywords(self.config, self.seed, self.dev)
        self.rng = np.random.default_rng(sub_seed(self.seed, 5))
        self.schedule = np.random.default_rng(t["schedule_seed"])
        keys = np.sort(self.inp.full[0].astype(np.int64) * self.inp.n + self.inp.full[1])
        self.pos = self.inp.split.test_pos
        self.neg = graphs.sample_non_edges(self.rng, self.inp.n, keys, 4 * len(self.pos),
                                           unordered=True)
        self.sizes = block_sizes(t["min_links"], t["max_links"], t["size_block"])
        self.gaps = block_gaps(t["rate_per_s"], t["size_block"])
        self.params = self._weights()
        m = self.config["model"]
        d_in = self.params["w1"].shape[1]
        self.model = SIGNNet(d_in, m["hidden_channels"], self.config["pos"]["sign_k"],
                             dropout=m["dropout"])
        self.model.load_state_dict({LEAVES[k]: v for k, v in self.params.items() if k in LEAVES}
                                   | {"operator_diff.norms.0.running_mean": self.params["rm1"],
                                      "operator_diff.norms.0.running_var": self.params["rv1"],
                                      "link_pred_mlp.norms.0.running_mean": self.params["rm2"],
                                      "link_pred_mlp.norms.0.running_var": self.params["rv2"]})
        self.model.to(self.dev).eval()
        phase("graph, requests and model")
        for n in sorted(set(int(s) for s in self.sizes)):  # every size once
            self._serve(self._request(n))
        self.i = 0
        sync(self.dev)
        phase("warm requests")

    def _weights(self) -> dict:
        """SIGNNet's weights and BatchNorm statistics, drawn on the device
        from the seed in one call and shaped: Linear weights and biases
        U(+-1/sqrt(fan_in)), BatchNorm scales in [0.5, 1.5], shifts and
        running means in [-0.1, 0.1], running variances in [0.5, 1.5]."""
        m = self.config["model"]
        H = m["hidden_channels"]
        d_in = (self.config["pos"]["sign_k"] + 1) * (self.inp.x.shape[1] + 1)
        shapes = {"w1": (H, d_in), "b1": (H,), "w2": (H, H), "b2": (H,), "w3": (1, H),
                  "b3": (1,), "g1": (H,), "be1": (H,), "rm1": (H,), "rv1": (H,),
                  "g2": (H,), "be2": (H,), "rm2": (H,), "rv2": (H,)}
        total = sum(int(np.prod(s)) for s in shapes.values())
        gen = torch.Generator(device=self.dev).manual_seed(sub_seed(self.seed, 6))
        u = torch.rand(total, generator=gen, device=self.dev) * 2.0 - 1.0  # U(-1, 1)
        fan = {"w1": d_in, "b1": d_in, "w2": H, "b2": H, "w3": H, "b3": H}
        out, at = {}, 0
        for k, s in shapes.items():
            n = int(np.prod(s))
            v = u[at:at + n].reshape(s)
            at += n
            if k in fan:
                v = v / np.sqrt(fan[k])
            elif k[:1] in ("g",) or k[:2] == "rv":
                v = 1.0 + 0.5 * v
            else:
                v = 0.1 * v
            out[k] = v.contiguous()
        return out

    def _request(self, n: int) -> np.ndarray:
        n_pos = int(np.ceil(n * self.traffic["positive_share"]))
        pos = self.pos[self.rng.integers(len(self.pos), size=n_pos)]
        neg = self.neg[self.rng.integers(len(self.neg), size=n - n_pos)]
        return np.concatenate([pos, neg]).astype(np.int32)

    def _next(self) -> tuple[int, float]:
        """The next request's size and its gap after the previous one."""
        b = self.traffic["size_block"]
        if self.i % b == 0:
            self.order = (self.schedule.permutation(self.sizes),
                          self.schedule.permutation(self.gaps))
        n, gap = int(self.order[0][self.i % b]), float(self.order[1][self.i % b])
        self.i += 1
        return n, gap

    def _serve(self, links: np.ndarray):
        t0 = time.perf_counter()
        ds = self.precompute_pos(self.dg, links, np.zeros(len(links), np.float32), **self.kw)
        with torch.no_grad():
            scores = torch.cat([
                self.model(self.flat_operators(ds.xs[s:s + 1024]), ds.row_mask[s:s + 1024])
                for s in range(0, len(links), 1024)]).cpu().numpy()
        return links, scores, time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        due, late = 0.0, []
        while True:
            n, gap = self._next()
            due += gap
            if due >= seconds:
                break
            links = self._request(n)
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(max(-wait, 0.0))
            links, scores, _ = self._serve(links)
            self.done.append((links, scores, time.perf_counter() - t0 - due))
        elapsed = time.perf_counter() - t0
        lat = np.array([d[2] for d in self.done])
        print(f"score: {len(lat)} requests, p50 {np.percentile(lat, 50) * 1e3:.3f} ms, "
              f"start behind schedule by up to {max(late) * 1e3:.3f} ms, mean "
              f"{np.mean(late) * 1e3:.3f} ms", file=sys.stderr)
        return {"score_ms_p95": float(np.percentile(lat, 95) * 1e3), "window_s": elapsed,
                "attempted": len(self.done)}

    def trace(self, peaks) -> TraceContext:
        from benchmark import trace

        n = self.traffic["trace_requests"]
        warm = [self._request(self._next()[0]) for _ in range(n)]
        active = [self._request(self._next()[0]) for _ in range(n)]
        prof = trace.profile(lambda: [self._serve(r) for r in warm],
                             lambda: self.done.extend(self._serve(r) for r in active),
                             lambda: sync(self.dev))
        ctx = TraceContext(profile=prof, peaks=peaks)
        ctx.counts["requests"] = n
        return ctx

    def release(self) -> None:
        del self.dg, self.model

    def check(self, control: bool = False) -> list:
        rng = np.random.default_rng(sub_seed(self.seed, 7))
        k = self.traffic["check_requests"]
        by_size = np.argsort([-len(d[0]) for d in self.done], kind="stable")
        picked = list(by_size[:k // 4])
        rest = [i for i in range(len(self.done)) if i not in set(picked)]
        picked += list(rng.choice(rest, min(k - len(picked), len(rest)), replace=False))
        g = ref_graph(self.inp, self.dev)
        rk = ref_keywords(self.config)
        p64 = {key: v.double() for key, v in self.params.items()}
        worst = ctl_worst = 0.0
        bad = 0
        for i in picked:
            links, got, _ = self.done[i]
            want = self._ref_scores(g, links, rk, p64, "float64")
            gap = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)) \
                if got.shape == want.shape and np.isfinite(got).all() else float("inf")
            bad += gap > self.limits["score_gap"]
            worst = max(worst, gap)
            if control:
                ctl = self._ref_scores(g, links, rk, self.params, "tf32")
                ctl_worst = max(ctl_worst, float(np.abs(ctl - want).max()
                                                 / max(np.abs(want).max(), 1e-30)))
        self.failed = bad
        out = [Check("score_gap", worst, self.limits["score_gap"])]
        if control:
            out.append(Check("control_score_gap", ctl_worst, self.limits["score_gap"]))
        return out

    def _ref_scores(self, g, links, rk, params, precision) -> np.ndarray:
        arith = reference.Arith(precision)
        xs = reference.pos_rows(g, links, precision=precision, **rk)
        mask = torch.ones(xs.shape[0], xs.shape[2], dtype=torch.bool, device=self.dev)
        return reference.predict(params, xs, mask, arith).cpu().numpy()
