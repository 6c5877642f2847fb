"""Kernel timers on one CUDA card.

A kernel call can be read three ways, and each reads something else:

- :func:`call_ms`: CUDA events around back-to-back eager calls. This is
  the time a call takes on the stream, and it counts any gap in which the
  card waits for the host to enqueue the next launch.
- :func:`graph_ms`: the same calls captured once in a CUDA graph and
  replayed, the replay timed by events. No host work lies in the window.
- :func:`profile_kernels`: the durations of the device events that
  ``torch.profiler`` records, averaged by kernel name, and the idle time
  between them.

A kernel's device time (what a share of its bound divides by) is the graph
replay's reading, held against the profiler's per-launch means; ``call_ms``
is reported beside it under its own name.
"""
from __future__ import annotations

import re
import subprocess
import time
from typing import Callable


def call_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Mean milliseconds per call on the stream over ``reps`` eager calls,
    by CUDA events, after two warm calls."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Mean host milliseconds to enqueue one call (no synchronize inside
    the window), after a warm call: where it passes the device time, the
    stream runs dry between calls and :func:`call_ms` counts the wait."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


def graph_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Mean device milliseconds per call: ``reps`` calls captured once in a
    CUDA graph (after a warm eager call), replayed once warm, then one
    replay timed by CUDA events. The calls' scratch and outputs come from
    the graph's own memory pool, freed with it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def kernel_name(name: str) -> str:
    """A device event's short name: no ``void``, namespace or arguments."""
    name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", name)
    return re.split(r"[<(]", name)[0][:60]


def profile_kernels(fn: Callable[[], object], reps: int = 20) -> dict:
    """``torch.profiler`` over ``reps`` calls after a warm one.

    Late in a long process a session misses the device events of its first
    launches (``PERF.md`` §6): the events it keeps are whole and right,
    but fewer than the launches. So a kernel's time is the mean over the
    events kept of it: ``by_name`` gives device milliseconds per launch by
    short kernel name and ``launches`` the events kept of each; a caller
    whose function launches each kernel once a call sums the means. Also
    ``kept_sum_ms`` (all kept events' time over ``reps``: a sum that reads
    short where events were missed), ``gap_ms`` (the mean idle time between
    consecutive kept events), ``events`` (kept in all) and the window's two
    edges: ``lag_ms``, from the host op of a marker kernel launched first to
    the first device event kept (milliseconds where the first launches were
    missed), and ``tail_ms``, from the last one's end to the end of the
    host's synchronize."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        marker.add_(1)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device, marker_op, sync_end = [], None, None
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            device.append((e.time_range.start, e.time_range.end, e.name))
        elif marker_op is None and e.name == "aten::add_":
            marker_op = e.time_range.start
        elif e.name == "cudaDeviceSynchronize":
            sync_end = max(sync_end or e.time_range.end, e.time_range.end)
    device.sort()
    lag = (device[0][0] - marker_op) / 1e3 if device and marker_op is not None else None
    if device and "FunctorOnSelf_add" in device[0][2]:
        device = device[1:]  # the marker's kernel
    total: dict[str, float] = {}
    launches: dict[str, int] = {}
    for a, b, name in device:
        name = kernel_name(name)
        total[name] = total.get(name, 0.0) + (b - a) / 1e3
        launches[name] = launches.get(name, 0) + 1
    gaps = [max(0.0, a - b) for (_, b, _), (a, _, _) in zip(device, device[1:])]
    tail = (sync_end - device[-1][1]) / 1e3 if device and sync_end is not None else None
    return dict(by_name={k: v / launches[k] for k, v in total.items()}, launches=launches,
                kept_sum_ms=sum(total.values()) / reps, events=len(device),
                gap_ms=sum(gaps) / len(gaps) / 1e3 if gaps else None, lag_ms=lag,
                tail_ms=tail)


class ClockSampler:
    """``nvidia-smi``'s SM and memory clocks (MHz), sampled every
    ``every_ms`` while the block runs; :meth:`summary` gives the least,
    median and most of each after it."""

    def __init__(self, every_ms: int = 20):
        self.every_ms = every_ms
        self.samples: list[tuple[float, float]] = []

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem", "--format=csv,noheader,nounits",
             "-lms", str(self.every_ms)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        time.sleep(0.3)  # nvidia-smi's start; its first sample precedes the work
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            if len(parts) == 2 and all(p.replace(".", "", 1).isdigit() for p in parts):
                self.samples.append((float(parts[0]), float(parts[1])))
        return False

    def summary(self) -> dict:
        import numpy as np

        if not self.samples:
            return {"samples": 0}
        sm, mem = np.array(self.samples).T
        return {"samples": len(sm), "sm_mhz": [float(sm.min()), float(np.median(sm)), float(sm.max())],
                "mem_mhz": [float(mem.min()), float(np.median(mem)), float(mem.max())]}
