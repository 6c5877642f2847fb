#!/usr/bin/env python3
"""Where the torch port's main path spends its time on a CUDA card.

    python3 scripts/profile_torch_main_path.py [--seed 1] [--epochs 1] \
        [--sign_type PoS|SoP|hybrid]

Runs the two halves of one of ``chip_smoke.py``'s end-to-end runs, the
operator precompute of all three splits (PoS by default; SoP and hybrid
with ``pool_operatorwise``) and SIGNNet training, once to warm up and
once under ``torch.profiler``. For each half it prints the host wall time
(ending at ``torch.cuda.synchronize()``), the device's busy time (the union
of all kernel, copy and set intervals), its idle share, the device time by
kernel and the host operators by their own CPU time. Fails where CUDA is
missing.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chip_smoke.py's graph comes from the tests' helpers, imported by module name.
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def device_time(prof) -> tuple[float, dict[str, float], int]:
    """(busy microseconds, device microseconds by event name, number of
    device events) of a trace.
    Annotations on the device timeline (``Optimizer.step#...``) span other
    kernels and are left out."""
    from torch.autograd import DeviceType

    spans, by_name = [], defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] += e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, by_name, len(spans)


def profiled(label: str, fn, top: int = 12):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm: library load, cuBLAS handles, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name, n_events = device_time(prof)
    print(f"{label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"over {n_events} device events, idle share {1 - busy / wall_us:.3f}")
    total = sum(by_name.values())
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  device {us / 1e3:10.3f} ms {us / total:6.1%}  {name[:100]}")
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    for a in ops[:top]:
        print(f"  host   {a.self_cpu_time_total / 1e3:10.3f} ms {a.count:7d} calls  {a.key[:80]}")


def main(argv=None) -> None:
    import numpy as np
    import torch

    from chip_smoke import bench_config, split_graph
    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.ops import _build
    from s3grl_tpu_torch.runner import build_split_links, precompute_split
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from s3grl_tpu_torch.train.loop import fit_signnet
    from s3grl_tpu_torch.utils.device import resolve_device
    from s3grl_tpu_torch.utils.seeding import seed_everything

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--sign_type", choices=("PoS", "SoP", "hybrid"), default="PoS")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    _build.build_all()
    cfg = dataclasses.replace(
        bench_config(args.seed, args.epochs, os.path.join(ROOT, "build", "profile_results")),
        sign_type=args.sign_type, pool_operatorwise=args.sign_type != "PoS",
    )
    # The runner's operator count: hybrid appends K - 1 SoP operators.
    num_layers = 2 * cfg.sign_k - 1 if cfg.sign_type == "hybrid" else cfg.sign_k
    graph, split = split_graph(cfg)
    graph = init_features(graph, cfg.init_features)
    dg = DeviceGraph.from_graph(graph, device=dev)
    rng, _ = seed_everything(cfg.seed)
    links = {s: build_split_links(s, split, getattr(cfg, f"{p}_percent"), rng)
             for s, p in (("train", "train"), ("valid", "val"), ("test", "test"))}
    datasets = {}

    def precompute():
        for s, (lk, y) in links.items():
            datasets[s] = precompute_split(dg, lk, y, cfg, device=dev)

    def train():
        fit_signnet(
            datasets["train"], datasets["valid"], datasets["test"],
            sign_k=num_layers, hidden_channels=cfg.hidden_channels,
            num_layers=num_layers, batch_size=cfg.batch_size, lr=cfg.lr,
            epochs=cfg.epochs, dropout=cfg.dropout,
            pool_operatorwise=cfg.pool_operatorwise, seed=cfg.seed, device=dev,
        )

    n = sum(len(y) for _, y in links.values())
    print(f"{torch.cuda.get_device_name(0)}; {cfg.sign_type}; {n} links, "
          f"{len(links['train'][1])} train links x {cfg.epochs} epoch(s)")
    profiled(f"{cfg.sign_type} precompute (3 splits)", precompute)
    profiled(f"train ({cfg.epochs} epoch(s) + eval)", train)
    print(f"train links/step {cfg.batch_size}, steps/epoch "
          f"{int(np.ceil(len(links['train'][1]) / cfg.batch_size))}")


if __name__ == "__main__":
    main()
