"""Reading a ``torch.profiler`` session: device busy time as the union of
the device's intervals, device time by operation, kernel launches, and the
longest idle gaps by the host operation that ran during them.

The union of intervals is a frozen copy of ``chip_smoke.device_time``;
idle = 1 - busy / wall is ``scripts/profile_torch_main_path.profiled``'s.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Profile:
    """What one profiled slice gave."""

    wall_s: float  # host clock from the slice's start to its synchronised end
    busy_s: float  # union of the device's intervals
    device_s: dict = field(default_factory=dict)  # seconds by device operation name
    kernels: int = 0  # kernel launches seen on the device
    idle_gaps: list = field(default_factory=list)  # [[host operation, seconds]], longest first

    def kernel_s(self, prefix: str) -> float:
        """Summed device seconds of the kernels whose function name (after
        its namespaces, before its template and call arguments) starts with
        ``prefix``."""
        return sum(v for k, v in self.device_s.items() if function_name(k).startswith(prefix))


def function_name(kernel: str) -> str:
    """``pos_xpass_kernel`` of ``void (anonymous namespace)::pos_xpass_kernel<2>(int ...)``."""
    head = kernel.replace("(anonymous namespace)", "").split("(", 1)[0].split("<", 1)[0]
    return head.split()[-1].split("::")[-1] if head.split() else ""


def _union(spans):
    busy, end = 0.0, float("-inf")
    gaps = []
    for a, b in sorted(spans):
        if b > end:
            if end != float("-inf") and a > end:
                gaps.append((end, a))
            busy += b - max(a, end)
            end = b
    return busy, gaps


def _innermost(cpu_events, points):
    """For each point (sorted), the name of the innermost host event of the
    main thread that spans it, or None."""
    names = []
    stack = []
    i = 0
    for p in points:
        while i < len(cpu_events) and cpu_events[i][0] <= p:
            a, b, name = cpu_events[i]
            while stack and stack[-1][1] <= a:
                stack.pop()
            stack.append((a, b, name))
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        names.append(stack[-1][2] if stack else None)
    return names


def profile(warm, active, sync, top: int = 10) -> Profile:
    """Profile ``active()`` after ``warm()`` under one session (the warm
    step lets the tracer start before the launches that count), each
    followed by ``sync()``; returns the active step's :class:`Profile`.
    The session ends inside the active step: a ``step()`` after it would
    close the cycle and clear its events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile, schedule

    walls = []
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        warm()
        sync()
        prof.step()
        t0 = time.perf_counter()
        active()
        sync()
        walls.append(time.perf_counter() - t0)
    spans, by_name, cpu, kernels = [], {}, [], 0
    events = prof.events()
    threads = {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            threads[e.thread] = threads.get(e.thread, 0) + 1
    main = max(threads, key=threads.get) if threads else None
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) * 1e-6
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels += 1
        elif e.thread == main:
            cpu.append((e.time_range.start, e.time_range.end, e.name))
    busy_us, gaps = _union(spans)
    cpu.sort()
    gaps.sort(key=lambda g: g[0])
    names = _innermost(cpu, [(a + b) / 2 for a, b in gaps])
    by_host = {}
    for (a, b), name in zip(gaps, names):
        # Inside the step's own span but no torch operation: Python, or
        # native code such as the host BFS.
        key = "host outside torch ops" if not name or name.startswith("ProfilerStep") else name
        by_host[key] = by_host.get(key, 0.0) + (b - a) * 1e-6
    return Profile(
        wall_s=walls[0], busy_s=busy_us * 1e-6, device_s=by_name, kernels=kernels,
        idle_gaps=sorted(([k, v] for k, v in by_host.items()), key=lambda kv: -kv[1])[:top],
    )


def breakdown(p: Profile, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time, and the idle gaps by what the host was doing."""
    ops = sorted(([k, v] for k, v in p.device_s.items()), key=lambda kv: -kv[1])[:top]
    return {"device_ops": ops, "idle_gaps": p.idle_gaps[:top]}


def idle_percent(ctx):
    """100 x (1 - busy / wall) of a traced run's profiled slice, or None."""
    p = ctx.profile
    if p is None or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.wall_s)


ROOFLINE_LIMIT = 105.0


def roofline_percent(ctx, work: str, kernel: str):
    """100 x the least time the card could take for ``ctx.work[work]`` over
    the summed device time of the kernels whose name starts with
    ``kernel``, or None where either is missing. A share above
    :data:`ROOFLINE_LIMIT` is an impossible reading (the bytes or operations
    counted too high, or the time missing part of the work): it raises."""
    from benchmark.workmodel import bound_s

    if ctx.work.get(work) is None or ctx.peaks is None or ctx.profile is None:
        return None
    seconds = ctx.profile.kernel_s(kernel)
    if seconds <= 0:
        return None
    share = 100.0 * bound_s(*ctx.work[work], ctx.peaks) / seconds
    if share > ROOFLINE_LIMIT:
        raise ValueError(f"{kernel} share {share} > {ROOFLINE_LIMIT}: an impossible reading")
    return share
