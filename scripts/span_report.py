#!/usr/bin/env python3
"""A benchmark cell's profiled slice by the program's spans and counters.

    python3 scripts/span_report.py --workload blogcatalog_pos.prep --seed 7

Runs ``benchmark/run.py``'s traced run of the cell (the same set-up, slices,
``torch.profiler`` session, readers and comparison) and keeps what the
benchmark's reading of the session drops: the session's events and the
program's counters over its profiled slice. Prints one JSON line: the
benchmark's result (``result``), a row for each of the program's span names
(``spans``, from :func:`span_table`), the counter differences over the
profiled slice (``counters``), the per-span readings of :func:`readings`
and the card's idle seconds by span (``idle_by_span``).
Needs a CUDA card, as the benchmark does; the span names are those of
``PERF.md`` §3.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = ("pos.", "fit.")  # the program's span names start so
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch"})
# The runtime calls that wait for the card: a copy by plain cudaMemcpy
# returns when it has finished; cudaMemcpyAsync does not wait.
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy"})
OUTSIDE = "outside the program's spans"


def _spans(events):
    """The program's spans of a session (user annotations named ``pos.*`` or
    ``fit.*``) on the thread that holds most of them, sorted by start, and
    each one's enclosing span (-1 for none)."""
    from torch.autograd import DeviceType

    by_thread = {}
    for e in events:
        if (e.device_type != DeviceType.CUDA and getattr(e, "is_user_annotation", False)
                and e.name.startswith(PROGRAM)):
            by_thread.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end, e.name))
    spans = sorted(max(by_thread.values(), key=len) if by_thread else [],
                   key=lambda s: (s[0], -s[1]))
    parent, stack = [-1] * len(spans), []
    for i, (a, _, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= a:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    return spans, parent


def _innermost(spans, points) -> list:
    """For each of ``points`` (sorted), the index of the innermost span that
    holds it, or -1."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            while stack and spans[stack[-1]][1] <= spans[i][0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def span_table(events) -> dict:
    """For each program span name (``pos.*``, ``fit.*``) of a session's
    ``events``: ``n``, ``total_s``, ``self_s`` (the spans' seconds less those
    of the program spans nested in them), ``median_ms`` (of one span's
    duration), and ``launches`` and ``syncs``: the CUDA runtime's kernel
    launches and waits whose host start lies inside a span, nested spans
    included. The spans are those of the thread that holds most of them;
    the runtime calls count on every host thread, since the autograd
    engine launches a step's backward from a thread of its own while the
    step's span is open."""
    from torch.autograd import DeviceType

    spans, parent = _spans(events)
    calls = sorted((e.time_range.start, e.name) for e in events
                   if e.device_type != DeviceType.CUDA and e.name in LAUNCHES | SYNCS)
    launches, syncs = [0] * len(spans), [0] * len(spans)
    for (_, name), at in zip(calls, _innermost(spans, [t for t, _ in calls])):
        while at >= 0:
            (launches if name in LAUNCHES else syncs)[at] += 1
            at = parent[at]
    child_us = [0.0] * len(spans)
    for i, (a, b, _) in enumerate(spans):
        if parent[i] >= 0:
            child_us[parent[i]] += b - a
    table, durations = {}, {}
    for i, (a, b, name) in enumerate(spans):
        row = table.setdefault(name, {"n": 0, "total_s": 0.0, "self_s": 0.0, "launches": 0,
                                      "syncs": 0})
        row["n"] += 1
        row["total_s"] += (b - a) * 1e-6
        row["self_s"] += (b - a - child_us[i]) * 1e-6
        row["launches"] += launches[i]
        row["syncs"] += syncs[i]
        durations.setdefault(name, []).append((b - a) * 1e-3)
    for name, row in table.items():
        row["median_ms"] = statistics.median(durations[name])
    return table


def idle_by_span(events) -> dict:
    """The card's idle gaps (between the device's operations, as
    ``benchmark/trace.profile`` finds them) in seconds by the innermost
    program span open at each gap's midpoint; ``OUTSIDE`` for none."""
    from torch.autograd import DeviceType

    busy = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    gaps, end = [], float("-inf")
    for a, b in busy:
        if end != float("-inf") and a > end:
            gaps.append((end, a))
        end = max(end, b)
    spans, _ = _spans(events)
    out = {}
    for (a, b), at in zip(gaps, _innermost(spans, [(a + b) / 2 for a, b in gaps])):
        key = spans[at][2] if at >= 0 else OUTSIDE
        out[key] = out.get(key, 0.0) + (b - a) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def readings(table: dict, counters: dict, wall_s: float, kind: str) -> dict:
    """The per-span numbers ``PERF.md`` §3 names, where their spans or
    counters are there: a training step's launches and median host
    milliseconds and the evaluation's share of the slice's wall
    (``fit.*``); the BFS's self time as a share of the wall, the waits on
    the card a batch and the kernel's slot fill (``<kind>.*``)."""
    out = {}
    step = table.get("fit.step")
    if step:
        out["fit.step_launches"] = step["launches"] / step["n"]
        out["fit.step_host_ms"] = step["median_ms"]
    if "fit.eval" in table:
        out["fit.eval_share"] = 100.0 * table["fit.eval"]["total_s"] / wall_s
    bfs = [table[k]["self_s"] for k in ("pos.host_bfs", "pos.device_bfs") if k in table]
    if bfs:
        out[f"{kind}.bfs_share"] = 100.0 * sum(bfs) / wall_s
    batches = sum(row["n"] for k, row in table.items() if k.startswith("pos.batch/"))
    if batches and "pos.precompute" in table:
        out[f"{kind}.syncs_per_batch"] = table["pos.precompute"]["syncs"] / batches
    if counters.get("pos.slots"):
        used = counters.get("pos.slots_used", 0)
        out[f"{kind}.slot_fill"] = 100.0 * used / counters["pos.slots"]
    return out


def traced_run(workload: str, seed: int, **run_kw):
    """``benchmark/run.run_cell``'s traced run of ``workload`` (``run_kw``
    are its keywords), keeping the profiler session (through a subclass of
    ``torch.profiler.profile`` that records itself) and the counters'
    differences over the profiled slice (around the slice's own function);
    returns (result, events, counters)."""
    import torch.profiler

    from benchmark import trace
    from benchmark.run import run_cell
    from s3grl_tpu_torch.profiling import counters

    sessions, delta = [], {}
    base_profile, base_session = trace.profile, torch.profiler.profile

    class Kept(base_session):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            sessions.append(self)

    def profile(warm, active, sync, top=10):
        def counted():
            before = counters()
            active()
            delta.update({k: v - before.get(k, 0) for k, v in counters().items()
                          if v != before.get(k, 0)})
        return base_profile(warm, counted, sync, top)

    trace.profile, torch.profiler.profile = profile, Kept
    try:
        result, _ = run_cell(workload, seed, 0.0, True, **run_kw)
    finally:
        trace.profile, torch.profiler.profile = base_profile, base_session
    return result, sessions[-1].events(), delta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    from benchmark import spec
    from benchmark.run import fixed_caches

    fixed_caches(ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    kind = spec.load_cell(args.workload, ROOT).kind
    result, events, delta = traced_run(args.workload, args.seed)
    table = span_table(events)
    out = {"workload": args.workload, "seed": args.seed, "result": result, "spans": table,
           "counters": delta,
           "readings": readings(table, delta, result["device"]["window_s"], kind),
           "idle_by_span": idle_by_span(events)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
