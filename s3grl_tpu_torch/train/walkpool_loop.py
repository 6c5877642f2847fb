"""WalkPool training engine on the GPU.

Port of ``s3grl_tpu/train/walkpool_loop.py`` (reference
Software/WalkPooling/src/main.py: Adam at lr 5e-5, BCE-with-logits, or MSE
after a sigmoid with --MSE, batch 32). Each step runs

    link batch -> extraction without the target link -> candidate link
    injected -> DRNL labels -> WalkPool forward/backward

on the device (src/utils.py:165-212, the candidate link present in the
plus graph). Features are the graph's node features, or a ones column
(the reference's ``init_attribute='ones'`` default). One padded size S
serves every split: the largest measured subgraph rounded up to a power of
two, capped at ``max_subgraph_nodes``.

The train batch order comes from ``np.random.default_rng(seed)``, as in
the JAX package; the last train batch is padded with link 0 at loss weight
0, and the padded rows still enter the classifier's batch norm. Eval runs
the last batch ragged (the JAX package pads it with the last link; in eval
mode that changes no real row's score).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.data.split import EdgeSplit
from s3grl_tpu_torch.models.walkpool import WalkPoolLinkPred
from s3grl_tpu_torch.operators.pos import measure_subgraph_sizes
from s3grl_tpu_torch.runner_utils import round_up_pow2
from s3grl_tpu_torch.sampling.extraction import (
    DeviceGraph,
    dense_adjacency,
    extract_subgraphs,
    link_seeds_of,
)
from s3grl_tpu_torch.sampling.labeling import label_nodes
from s3grl_tpu_torch.train.logger import Logger
from s3grl_tpu_torch.train.loop import bce_with_logits
from s3grl_tpu_torch.train.metrics import evaluate_auc
from s3grl_tpu_torch.utils.device import resolve_device


def walkpool_batch(dg: DeviceGraph, links: torch.Tensor, cfg: RunConfig, S: int,
                   link_seeds: Optional[torch.Tensor] = None):
    """(adj, z, mask, x) of a link batch: the subgraph without the target
    link, then the candidate link injected at slots (0, 1) before the DRNL
    labels are made (JAX walkpool_loop.py:85-103). ``max_nodes_per_hop``
    samples each hop with the links' seeds; ``ratio_per_hop`` is not read,
    as in the JAX package's WalkPool loop."""
    sub = extract_subgraphs(
        dg, links, num_hops=cfg.num_hops, max_nodes=S,
        max_nodes_per_hop=cfg.max_nodes_per_hop, remove_target_link=True,
        link_seeds=link_seeds,
    )
    adj = dense_adjacency(sub)
    adj[:, 0, 1] = 1.0
    adj[:, 1, 0] = 1.0
    if cfg.node_label == "drnl":
        z = label_nodes(adj, sub.dist, sub.node_mask, node_label="drnl",
                        max_iters=min(cfg.max_label_dist, S))
    else:
        z = torch.zeros_like(sub.dist)
    if dg.x is not None:
        x = dg.x[sub.nodes.long()] * sub.node_mask[:, :, None].to(torch.float32)
    else:
        x = torch.ones((links.shape[0], S, 1), device=links.device)
    return adj, z, sub.node_mask, x


def run_walkpool_learning(
    graph: Graph,
    edge_split: EdgeSplit,
    cfg: RunConfig,
    rng,
    *,
    walk_len: int = 7,
    heads: int = 2,
    mse: bool = False,
    device="cuda",
):
    """End-to-end WalkPool run; returns the reference's tuple
    (prep_time, best_test, train_times, inference_times, total_params)."""
    from s3grl_tpu_torch.runner import build_split_links

    dev = resolve_device(device)
    t_prep0 = time.perf_counter()
    dg = DeviceGraph.from_graph(graph, device=dev)

    splits = {}
    sizes = []
    for split, percent in (
        ("train", cfg.train_percent),
        ("valid", cfg.val_percent),
        ("test", cfg.test_percent),
    ):
        links, y = build_split_links(split, edge_split, percent, rng, neg_ratio=cfg.neg_ratio)
        seeds = link_seeds_of(cfg.seed, len(links))
        sizes.append(measure_subgraph_sizes(
            dg, links.astype(np.int32), seeds, num_hops=cfg.num_hops,
            max_nodes_per_hop=cfg.max_nodes_per_hop,
        ))
        splits[split] = (torch.as_tensor(links.astype(np.int64), device=dev),
                         torch.as_tensor(y.astype(np.float32), device=dev),
                         torch.as_tensor(seeds, device=dev))
    S = min(round_up_pow2(max(int(z.max()) for z in sizes)), cfg.max_subgraph_nodes)

    # Weights from a generator on the CPU, so a seeded run starts from the
    # same weights on every device; dropout masks from one on the device.
    model = WalkPoolLinkPred(
        graph.num_features if dg.x is not None else 1, cfg.hidden_channels, heads=heads,
        walk_len=walk_len, drnl=cfg.node_label == "drnl", mse=mse,
        generator=torch.Generator().manual_seed(cfg.seed),
    ).to(dev)
    drop_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)  # optax.adam: no decay
    n_params = sum(p.numel() for p in model.parameters())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    total_prep = time.perf_counter() - t_prep0

    bsz = cfg.batch_size

    @torch.no_grad()
    def predict_split(split: str) -> np.ndarray:
        model.eval()
        links, _, seeds = splits[split]
        outs = [model(*walkpool_batch(dg, links[s : s + bsz], cfg, S, seeds[s : s + bsz]))
                for s in range(0, len(links), bsz)]
        model.train()
        return torch.cat(outs).cpu().numpy()

    loggers = {"AUC": Logger(cfg.runs), "AP": Logger(cfg.runs)}
    np_rng = np.random.default_rng(cfg.seed)
    train_links, train_y, train_seeds = splits["train"]
    L = len(train_y)
    steps = (L + bsz - 1) // bsz
    pad_n = steps * bsz - L
    w_full = torch.zeros(steps * bsz, dtype=torch.float32, device=dev)
    w_full[:L] = 1.0
    train_times, inference_times = [], []
    model.train()
    for epoch in range(1, cfg.epochs + 1):
        t0 = time.perf_counter()
        perm = np.concatenate([np_rng.permutation(L), np.zeros(pad_n, dtype=np.int64)])
        perm = torch.as_tensor(perm, device=dev)
        for s in range(steps):
            idx = perm[s * bsz : (s + 1) * bsz]
            wb = w_full[s * bsz : (s + 1) * bsz]
            out = model(*walkpool_batch(dg, train_links[idx], cfg, S, train_seeds[idx]),
                        generator=drop_gen)
            yb = train_y[idx]
            losses = (out - yb) ** 2 if mse else bce_with_logits(out, yb)
            loss = (losses * wb).sum() / torch.clamp(wb.sum(), min=1.0)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the epoch's work has finished
        train_times.append(time.perf_counter() - t0)
        if epoch % cfg.eval_steps == 0:
            val_pred = predict_split("valid")
            t1 = time.perf_counter()
            test_pred = predict_split("test")
            inference_times.append(time.perf_counter() - t1)
            results = evaluate_auc(val_pred, splits["valid"][1].cpu().numpy(),
                                   test_pred, splits["test"][1].cpu().numpy())
            for k, r in results.items():
                loggers[k].add_result(0, r)

    best_scores = []
    for k in loggers:
        loggers[k].add_info(cfg.epochs, cfg.runs)
        best_scores.append(loggers[k].print_statistics())
    return total_prep, best_scores[0], train_times, inference_times, n_params
