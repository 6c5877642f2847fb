#!/usr/bin/env python3
"""Where the torch port's main path spends its time on a CUDA card.

    python3 scripts/profile_torch_main_path.py [--seed 1] [--epochs 1] \
        [--sign_type PoS|SoP|hybrid] [--model SIGN|DGCNN|GCN]

With ``--model SIGN`` (default) it runs the two halves of one of
``chip_smoke.py``'s end-to-end runs, the operator precompute of all three
splits (PoS by default; SoP and hybrid with ``pool_operatorwise``) and
SIGNNet training, once to warm up and once under ``torch.profiler``. For
each half it prints the host wall time (ending at
``torch.cuda.synchronize()``), the device's busy time (the union of all
kernel, copy and set intervals), its idle share, the device time by kernel
and the host operators by their own CPU time.

With ``--model DGCNN`` (or GCN) it profiles ``chip_smoke.py``'s SEAL (or
GCN-DE) path, ``run_gnn_learning`` in the static-cache mode, at
``--epochs`` and at one epoch more. Each run prints the same figures, plus
the device time of each annotated piece: extraction, dense adjacency,
labels (these three build the cache), the re-densified adjacency of each
step, the conv stack, sort-pool, and the Conv1d stages with the MLP (the
score MLP for GCN); backward and Adam are the rest. The difference of the
two runs gives one epoch's launches and wall time per step.
Fails where CUDA is missing.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chip_smoke.py's graph comes from the tests' helpers, imported by module name.
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def profiled(label: str, fn, top: int = 12):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_time

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
    return prof, wall_us


def annotate(module, attr: str, label: str) -> None:
    """Wrap ``module.attr`` in a ``record_function`` named ``label``."""
    from torch.profiler import record_function

    fn = getattr(module, attr)

    def wrapped(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)

    setattr(module, attr, wrapped)


def annotate_span(first, last, label: str) -> None:
    """A ``record_function`` named ``label`` from the start of ``first``'s
    forward to the end of ``last``'s, entered and left by module hooks."""
    from torch.profiler import record_function

    open_ = []
    first.register_forward_pre_hook(lambda m, i: open_.append(record_function(label).__enter__()))
    last.register_forward_hook(lambda m, i, o: open_.pop().__exit__(None, None, None))


def between(after, before, label: str) -> None:
    """A span from the end of ``after``'s forward to the start of ``before``'s."""
    from torch.profiler import record_function

    open_ = []
    after.register_forward_hook(lambda m, i, o: open_.append(record_function(label).__enter__()))
    before.register_forward_pre_hook(lambda m, i: open_.pop().__exit__(None, None, None))


def profile_gnn(args) -> None:
    import torch
    from torch.autograd import DeviceType

    from chip_smoke import LABEL_PATHS, bench_config, split_graph, split_links
    from s3grl_tpu_torch.train import gnn_loop
    from s3grl_tpu_torch.utils.seeding import seed_everything

    path = "SEAL" if args.model == "DGCNN" else "GCN-DE"
    cfg = dataclasses.replace(
        bench_config(args.seed, args.epochs, os.path.join(ROOT, "build", "profile_results")),
        **LABEL_PATHS[path],
    )
    graph, split = split_graph(cfg)
    pieces = {"extract_subgraphs": "extraction", "dense_adjacency": "dense adjacency",
              "label_nodes": "labels", "batch_from_cache": "densify (each step)"}
    for attr, label in pieces.items():
        annotate(gnn_loop, attr, label)
    build = gnn_loop.build_gnn_model

    def build_annotated(*a, **kw):
        model = build(*a, **kw)
        annotate_span(model.convs[0], model.convs[-1], "conv stack")
        if hasattr(model, "conv1"):  # DGCNN
            between(model.convs[-1], model.conv1, "sort-pool")
            annotate_span(model.conv1, model.mlp, "Conv1d + MLP")
        else:
            annotate_span(model.mlp, model.mlp, "score MLP")
        return model

    gnn_loop.build_gnn_model = build_annotated
    labels = list(pieces.values()) + ["conv stack", "sort-pool", "Conv1d + MLP", "score MLP"]
    n_train = len(split_links(cfg, split)["train"])
    steps = -(-n_train // cfg.batch_size)
    print(f"{torch.cuda.get_device_name(0)}; {path} ({cfg.model}, {cfg.node_label}); "
          f"{n_train} train links, {steps} steps an epoch")
    runs = {}
    for epochs in (cfg.epochs, cfg.epochs + 1):
        c = dataclasses.replace(cfg, epochs=epochs)

        def run():
            rng, _ = seed_everything(c.seed)
            gnn_loop.run_gnn_learning(graph, split, c, rng, device="cuda")

        prof, wall_us = profiled(f"{path} run_gnn_learning, {epochs} epoch(s)", run)
        launches, pieces_us = 0, {}
        for a in prof.key_averages():
            if a.key.startswith("cudaLaunchKernel"):
                launches += a.count
            if a.key in labels:
                # The host-side range carries the device time of the kernels
                # launched inside it; the device-side annotation spans from
                # its first kernel to its last, gaps included.
                kind = "span" if a.device_type == DeviceType.CUDA else "kernels"
                dev_us = getattr(a, "device_time_total", None)
                dev_us = a.cuda_time_total if dev_us is None else dev_us
                pieces_us.setdefault(a.key, {})[kind] = (dev_us, a.count)
        for key, got in pieces_us.items():
            (k_us, n), span_us = got.get("kernels", (0.0, 0)), got.get("span", (0.0, 0))[0]
            print(f"  piece  {key}: kernels {k_us / 1e3:.3f} ms, span on the device "
                  f"{span_us / 1e3:.3f} ms, {n} calls")
        runs[epochs] = (launches, wall_us)
    (l0, w0), (l1, w1) = runs[cfg.epochs], runs[cfg.epochs + 1]
    print(f"one epoch: {l1 - l0} kernel launches ({(l1 - l0) / steps:.1f} a step, eval "
          f"included), wall {(w1 - w0) / 1e3:.1f} ms ({(w1 - w0) / 1e3 / steps:.3f} ms a step)")


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
    ap.add_argument("--model", choices=("SIGN", "DGCNN", "GCN"), default="SIGN")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    if args.model != "SIGN":
        return profile_gnn(args)
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
