#!/usr/bin/env python3
"""Find which op of a path adds in a varying order on the card.

    python3 scripts/repeat_probe.py

Runs each suspect op several times on one CUDA card from the same inputs,
and prints whether every run gives the same bits as the first (and the
largest difference where one does not), beside the fixed-order version
that the port uses in its place:

- the edge-list SpMM's sum: ``index_add_`` against ``ops/segment.segment_sum``,
  ``ops/spmm.spmm`` over the once-sorted edge list (and its backward) and
  the ``bsr_spmm`` kernel, at SoP's widths;
- the gradient of a row gather: ``F.embedding``'s and indexing's backward
  against ``ops/segment.gather_rows``, at node2vec's and at SEAL's label
  index counts, and at GAE's loss (the train edges' endpoints);
- DGCNN's two Conv1d stages on one SEAL batch at the SEAL path's S and
  sort-pool k: the weight gradients, and the time of a train step
  (forward and backward) by CUDA events, with cuDNN's convolutions, with
  cuDNN's deterministic flag on the forward calls only, with it over
  forward and backward, and as the port runs them
  (``models/gnn.conv1d_by_matmul``, cuBLAS products);
- whole seeded runs, twice each (each in a results dir of its own, so
  node2vec trains anew): SEAL with each of those conv stages, then
  PoS-n2v, SoP and hybrid.

The graph is ``chip_smoke.py``'s synthetic USAir-shaped one. Exits 2
without CUDA.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
RUNS = 5


def repeats(what: str, fn, n: int = RUNS) -> bool:
    """Run ``fn`` n times; report whether all results equal the first."""
    import torch

    outs = [fn() for _ in range(n)]
    outs = [o if isinstance(o, (tuple, list)) else (o,) for o in outs]
    same = all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
               for o in outs[1:] for a, b in zip(outs[0], o))
    diff = max(float((torch.as_tensor(a).double() - torch.as_tensor(b).double()).abs().max())
               for o in outs[1:] for a, b in zip(outs[0], o))
    print(f"  {what}: {'same bits' if same else 'DIFFERS'} in {n} runs "
          f"(max abs diff {diff:.3e})")
    return same


def probe_sums(graph, dev):
    import torch
    import torch.nn.functional as F

    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.ops.segment import gather_rows, segment_sum
    from s3grl_tpu_torch.ops.spmm import edge_list, normalized_adjacency_weights, spmm
    from s3grl_tpu_torch.ops.spmm_kernel import blockify, bsr_spmm
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph

    print("edge-list SpMM")
    gen = torch.Generator(device=dev).manual_seed(3)
    dg = DeviceGraph.from_graph(init_features(graph, "degree"), device=dev)
    w = normalized_adjacency_weights(dg.edge_src, dg.edge_dst, dg.num_nodes)
    src_h, dst_h, _ = dg.host_edges()
    adj = blockify(src_h, dst_h, w.cpu().numpy(), dg.num_nodes, device=dev)
    for C in (1025, 8192):  # the chain's width; 2B one-hot columns of a SoP batch
        x = torch.rand((dg.num_nodes, C), generator=gen, device=dev)
        contrib = x[dg.edge_src] * w[:, None]
        repeats(f"C={C} index_add_", lambda: torch.zeros_like(x).index_add_(
            0, dg.edge_dst, contrib))
        repeats(f"C={C} segment_sum", lambda: segment_sum(contrib, dg.edge_dst, dg.num_nodes))
        edges = edge_list(dg.edge_src, dg.edge_dst, w, dg.num_nodes)
        repeats(f"C={C} spmm (sorted edge list)", lambda: spmm(edges, x))
        g = torch.rand_like(x)

        def spmm_grad():
            xg = x.clone().requires_grad_()
            (spmm(edges, xg) * g).sum().backward()
            return xg.grad

        repeats(f"C={C} spmm backward", spmm_grad)
        repeats(f"C={C} bsr_spmm kernel", lambda: bsr_spmm(adj, x))

    print("row-gather gradients")
    for rows, n_idx, hi, H, label in ((332, 61440, 332, 16, "node2vec windows"),
                                      (1000, 16384, 30, 32, "SEAL labels"),
                                      (332, 7276, 332, 64, "GAE loss endpoints")):
        idx = torch.randint(0, hi, (n_idx,), generator=gen, device=dev)
        g_out = torch.rand((n_idx, H), generator=gen, device=dev)
        w0 = torch.rand((rows, H), generator=gen, device=dev)

        def grad_of(gather):
            e = w0.clone().requires_grad_()
            (gather(e) * g_out).sum().backward()
            return e.grad

        repeats(f"{label}: F.embedding backward", lambda: grad_of(lambda e: F.embedding(idx, e)))
        repeats(f"{label}: indexing backward", lambda: grad_of(lambda e: e[idx]))
        repeats(f"{label}: gather_rows backward", lambda: grad_of(lambda e: gather_rows(e, idx)))


def _cudnn_conv1d(x, conv):
    """DGCNN's conv stage on cuDNN, in ``conv1d_by_matmul``'s length-major
    layout."""
    return conv(x).transpose(1, 2)


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms for as long as the block runs (a
    backward reads the flag when it runs)."""
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _cudnn_conv1d_deterministic_forward(x, conv):
    """:func:`_cudnn_conv1d` with the deterministic flag around the forward
    call only."""
    with _deterministic_cudnn():
        return _cudnn_conv1d(x, conv)


# (name, DGCNN's conv stage, the scope around the steps)
CONV_VARIANTS = [
    ("cuDNN", _cudnn_conv1d, contextlib.nullcontext),
    ("cuDNN, deterministic flag on the forward calls only",
     _cudnn_conv1d_deterministic_forward, contextlib.nullcontext),
    ("cuDNN, deterministic flag over forward and backward", _cudnn_conv1d,
     _deterministic_cudnn),
]


def probe_seal_convs(cfg, graph, split, dev):
    import torch

    from chip_smoke import TABLE_2
    from s3grl_tpu_torch.models import gnn
    from s3grl_tpu_torch.operators.pos import measure_subgraph_sizes
    from s3grl_tpu_torch.runner import build_split_links
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from s3grl_tpu_torch.train.gnn_loop import (
        build_gnn_model,
        extract_and_label,
        pad_size_and_sortpool_k,
    )
    from s3grl_tpu_torch.train.loop import bce_with_logits

    c = dataclasses.replace(cfg, **TABLE_2)
    dg = DeviceGraph.from_graph(graph, device=dev)
    split_links = {s: build_split_links(s, split, 100.0, np.random.default_rng(1))
                   for s in ("train", "valid", "test")}
    sizes = {s: measure_subgraph_sizes(dg, links.astype(np.int32), num_hops=c.num_hops)
             for s, (links, _) in split_links.items()}
    S, k = pad_size_and_sortpool_k(c, sizes)
    print(f"DGCNN conv stages, one SEAL batch (32 links, S = {S}, sort-pool k = {k})")
    links, y = split_links["train"]
    order = np.random.default_rng(0).permutation(len(links))[:32]
    lb = torch.as_tensor(links[order].astype(np.int64), device=dev)
    yb = torch.as_tensor(y[order].astype(np.float32), device=dev)
    adj, z, m, _ = extract_and_label(dg, lb, num_hops=c.num_hops, max_nodes=S,
                                     node_label="drnl", max_iters=min(c.max_label_dist, S))
    model = build_gnn_model(c, k, 0, generator=torch.Generator().manual_seed(1)).to(dev)
    model.eval()  # dropout off: the same graph every run

    def step():
        model.zero_grad(set_to_none=True)
        bce_with_logits(model(adj, z, m), yb).mean().backward()

    def conv_grads():
        step()
        return tuple(p.grad.clone() for p in (model.conv1.weight, model.conv2.weight))

    def step_ms(reps=50):
        for _ in range(5):
            step()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            step()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    real = gnn.conv1d_by_matmul
    try:
        for name, stage, scope in CONV_VARIANTS + [
                ("conv1d_by_matmul (the port)", real, contextlib.nullcontext)]:
            gnn.conv1d_by_matmul = stage
            with scope():
                repeats(f"Conv1d weight gradients, {name}", conv_grads, n=8)
                print(f"    a train step (forward and backward): {step_ms():.4f} ms")
    finally:
        gnn.conv1d_by_matmul = real


def probe_runs(cfg, graph, split, dev):
    from chip_smoke import INIT_PATHS, TABLE_2
    from s3grl_tpu_torch.models import gnn
    from s3grl_tpu_torch.runner import run_sgrl_learning

    print("whole runs, 2 epochs, twice each")

    def twice(name, fields):
        best = []
        for i in range(2):
            c = dataclasses.replace(cfg, **fields, epochs=2, results_dir=os.path.join(
                cfg.results_dir, f"{name}-{i}"))
            best.append(run_sgrl_learning(c, graph, split, device=dev)[1])
        same = best[0] == best[1]
        print(f"  {name}: best test AUC {best[0]!r} / {best[1]!r}: "
              f"{'same bits' if same else 'DIFFERS'}")

    real = gnn.conv1d_by_matmul
    try:
        for name, stage, scope in CONV_VARIANTS:
            gnn.conv1d_by_matmul = stage
            with scope():
                twice(f"SEAL, {name}", TABLE_2)
    finally:
        gnn.conv1d_by_matmul = real
    twice("SEAL", TABLE_2)
    twice("PoS-n2v", INIT_PATHS["PoS-n2v"])
    twice("SoP", dict(sign_type="SoP", pool_operatorwise=True))
    twice("hybrid", dict(sign_type="hybrid", pool_operatorwise=True))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("repeat_probe: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import SEED, bench_config, split_graph

    dev = torch.device("cuda")
    cfg = bench_config(SEED, 5, os.path.join(ROOT, "build", "repeat_probe"))
    graph, split = split_graph(cfg)
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    probe_sums(graph, dev)
    probe_seal_convs(cfg, graph, split, dev)
    probe_runs(cfg, graph, split, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
