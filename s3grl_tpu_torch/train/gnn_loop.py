"""Training engine for the SEAL-style GNN baselines (DGCNN/GCN/SAGE/GIN).

Port of ``s3grl_tpu/train/gnn_loop.py``. Each step runs

    link batch -> batched BFS extraction -> batched labeling -> GNN fwd/bwd

on the device, or, in the static-cache mode (the reference's SEALDataset
semantics, sgrl_link_pred.py:54-220), extraction and labeling run once per
link before training: the node set, labels and mask of every link are
kept on the device (a few MB), and each step re-densifies the subgraph
adjacency from the global neighbor table. With no per-hop sampling both
modes give the same batches; sampled configs keep per-epoch extraction,
which is the reference's dynamic-dataset resampling.

The JAX package picks the mode from the environment variable
``S3GRL_TPU_GNN_STATIC``; here it is ``run_gnn_learning``'s
``static_cache`` argument, whose default is the same "auto" rule.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.data.split import EdgeSplit
from s3grl_tpu_torch.models.gnn import DGCNN, GCNModel, GINModel, SAGEModel
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
from s3grl_tpu_torch.train.loop import bce_with_logits, make_optimizer
from s3grl_tpu_torch.train.metrics import evaluate_auc
from s3grl_tpu_torch.utils.device import resolve_device

# f32 elements of the [B, S, S] adjacency per static-cache batch.
CACHE_ELEM_BUDGET = 64_000_000


def build_gnn_model(cfg: RunConfig, sortpool_k: int, num_features: int, generator=None):
    """The model ``cfg.model`` names; ``num_features`` is the width of the
    node features concatenated to the label embedding (0 for none)."""
    common = dict(use_feature=cfg.use_feature, num_features=num_features,
                  generator=generator)
    if cfg.model == "DGCNN":
        return DGCNN(cfg.hidden_channels, cfg.num_layers, sortpool_k,
                     dropedge=cfg.dropedge, **common)
    if cfg.model == "GCN":
        return GCNModel(cfg.hidden_channels, cfg.num_layers, dropout=cfg.dropout,
                        dropedge=cfg.dropedge, use_edge_weight=cfg.use_edge_weight,
                        **common)
    if cfg.model == "SAGE":
        return SAGEModel(cfg.hidden_channels, cfg.num_layers, dropout=cfg.dropout,
                         dropedge=cfg.dropedge, **common)
    if cfg.model == "GIN":
        return GINModel(cfg.hidden_channels, cfg.num_layers, **common)
    raise NotImplementedError(f"model {cfg.model}")


def pad_size_and_sortpool_k(cfg: RunConfig, sizes: dict) -> tuple[int, int]:
    """(S, sortpool_k) from per-split subgraph sizes: S pads the largest
    subgraph of any split to a power of two, capped at max_subgraph_nodes;
    k is the train split's 60th percentile (models.py:148-158), at least 10,
    or ``cfg.sortpool_k`` itself when it is above 1. Non-DGCNN models get
    k = 30, which they never read."""
    max_size = max(int(v.max()) for v in sizes.values())
    S = min(round_up_pow2(max_size), cfg.max_subgraph_nodes)
    k = 30
    if cfg.model == "DGCNN":
        if cfg.sortpool_k <= 1:
            train_sizes = np.sort(sizes["train"])
            k = max(10, int(train_sizes[int(math.ceil(cfg.sortpool_k * len(train_sizes))) - 1]))
        else:
            k = int(cfg.sortpool_k)
    return S, k


def static_cache_allowed(cfg: RunConfig) -> bool:
    """The JAX package's "auto" rule: extraction and labeling are the same
    every epoch when no per-hop sampling is configured; the re-densified
    adjacency is binary, so edge weights rule the cache out."""
    return cfg.ratio_per_hop >= 1.0 and cfg.max_nodes_per_hop is None and not cfg.use_edge_weight


def extract_and_label(
    dg: DeviceGraph, links: torch.Tensor, *, num_hops: int, max_nodes: int,
    node_label: str, max_iters: int, binary_adj: bool = True,
    ratio_per_hop: float = 1.0, max_nodes_per_hop: Optional[int] = None,
    link_seeds: Optional[torch.Tensor] = None,
):
    """(adj [B, S, S], z, node_mask [B, S], nodes [B, S]) for a link batch:
    extraction (sampled per hop with the links' seeds where asked), the
    dense adjacency, then the labels."""
    sub = extract_subgraphs(dg, links, num_hops=num_hops, max_nodes=max_nodes,
                            ratio_per_hop=ratio_per_hop, max_nodes_per_hop=max_nodes_per_hop,
                            binary_adj=binary_adj, link_seeds=link_seeds)
    adj = dense_adjacency(sub)
    z = label_nodes(adj, sub.dist, sub.node_mask, node_label=node_label,
                    max_iters=max_iters)
    return adj, z, sub.node_mask, sub.nodes


def batch_from_cache(
    dg: DeviceGraph, links: torch.Tensor, nodes: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """The binary, target-link-removed subgraph adjacency [B, S, S] of
    cached node sets, rebuilt from the global neighbor table.

    ``adj[b, t, s]`` is 1 when the node in slot t is a neighbor of the
    valid node in slot s. The JAX package compares every neighbor id with
    every slot's id over [B, S, S, D], which XLA fuses into its reduction;
    here each neighbor id is looked up among the row's sorted slot ids
    (``searchsorted``) and its slot scattered, so no 4-D tensor exists.
    """
    B, S = nodes.shape
    dev = nodes.device
    nodes_l = nodes.long()
    gnbr = dg.nbr[nodes_l].long().reshape(B, -1)  # [B, S*D] global ids
    D = gnbr.shape[1] // S
    live = (dg.nbr_mask[nodes_l] & mask[:, :, None]).reshape(B, -1)
    row_ids = torch.where(mask, nodes_l, torch.full_like(nodes_l, -1))
    sorted_ids, order = torch.sort(row_ids, dim=1)
    pos = torch.searchsorted(sorted_ids, gnbr).clamp_(max=S - 1)
    found = (torch.gather(sorted_ids, 1, pos) == gnbr) & live
    t = torch.gather(order, 1, pos)  # slot of each neighbor entry
    s = torch.arange(S, device=dev).repeat_interleave(D)  # slot of its row
    acc = torch.zeros((B, S * S), dtype=torch.float32, device=dev)
    acc.scatter_add_(1, t * S + s, found.to(torch.float32))
    adj = (acc > 0).reshape(B, S, S)
    # Target-link removal (slot 0 = src, slot 1 = dst), as extraction did
    # before the labels were made.
    is_src = nodes_l == links[:, 0:1].long()
    is_dst = nodes_l == links[:, 1:2].long()
    adj[:, 0, :] &= ~is_dst
    adj[:, :, 0] &= ~is_dst
    adj[:, 1, :] &= ~is_src
    adj[:, :, 1] &= ~is_src
    return adj.to(torch.float32)


def run_gnn_learning(
    graph: Graph,
    edge_split: EdgeSplit,
    cfg: RunConfig,
    rng,
    *,
    device="cuda",
    static_cache: Optional[bool] = None,
):
    """End-to-end SEAL-baseline run; returns the reference's tuple
    (prep_time, best_test, train_times, inference_times, total_params).

    ``static_cache``: None takes the "auto" rule (:func:`static_cache_allowed`),
    False extracts every batch anew, True asks for the cache and raises
    where the rule rules it out.
    """
    from s3grl_tpu_torch.runner import build_split_links

    dev = resolve_device(device)
    allowed = static_cache_allowed(cfg)
    if static_cache is None:
        static_cache = allowed
    elif static_cache and not allowed:
        raise ValueError(
            "static_cache needs no per-hop sampling and no edge weights "
            "(ratio_per_hop 1, max_nodes_per_hop None, use_edge_weight off)"
        )
    t_prep0 = time.perf_counter()
    dg = DeviceGraph.from_graph(graph, device=dev)

    splits, sizes = {}, {}
    for split, percent in (
        ("train", cfg.train_percent),
        ("valid", cfg.val_percent),
        ("test", cfg.test_percent),
    ):
        links, y = build_split_links(split, edge_split, percent, rng, neg_ratio=cfg.neg_ratio)
        seeds = link_seeds_of(cfg.seed, len(links))
        sizes[split] = measure_subgraph_sizes(
            dg, links.astype(np.int32), seeds, num_hops=cfg.num_hops,
            ratio_per_hop=cfg.ratio_per_hop, max_nodes_per_hop=cfg.max_nodes_per_hop,
        )
        splits[split] = (torch.as_tensor(links.astype(np.int64), device=dev),
                         torch.as_tensor(y.astype(np.float32), device=dev),
                         torch.as_tensor(seeds, device=dev))
    S, sortpool_k = pad_size_and_sortpool_k(cfg, sizes)
    use_x = cfg.use_feature and dg.x is not None
    label_kw = dict(num_hops=cfg.num_hops, max_nodes=S, node_label=cfg.node_label or "drnl",
                    max_iters=min(cfg.max_label_dist, S), binary_adj=not cfg.use_edge_weight,
                    ratio_per_hop=cfg.ratio_per_hop, max_nodes_per_hop=cfg.max_nodes_per_hop)

    # Weights from a generator on the CPU, so a seeded run starts from the
    # same weights on every device; dropout masks from one on the device.
    model = build_gnn_model(
        cfg, sortpool_k, graph.num_features if use_x else 0,
        generator=torch.Generator().manual_seed(cfg.seed),
    ).to(dev)
    drop_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    opt = make_optimizer(model.parameters(), cfg.lr)
    n_params = sum(p.numel() for p in model.parameters())

    # Static-mode caches: (z, mask, nodes) of every link, built once.
    caches = {}
    if static_cache:
        cache_bsz = max(1, min(cfg.extract_batch_size, CACHE_ELEM_BUDGET // (S * S)))
        for split, (links, _, seeds) in splits.items():
            parts = [extract_and_label(dg, links[s : s + cache_bsz],
                                       link_seeds=seeds[s : s + cache_bsz], **label_kw)[1:]
                     for s in range(0, len(links), cache_bsz)]
            caches[split] = tuple(torch.cat(p) for p in zip(*parts))  # z, mask, nodes
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # bill all device work to prep
    total_prep_time = time.perf_counter() - t_prep0

    def batch(split: str, idx: torch.Tensor):
        """(adj, z, mask, x) of the links ``idx`` of ``split``."""
        lb = splits[split][0][idx]
        if static_cache:
            z, m, nodes = (c[idx] for c in caches[split])
            adj = batch_from_cache(dg, lb, nodes, m)
        else:
            adj, z, m, nodes = extract_and_label(dg, lb, link_seeds=splits[split][2][idx],
                                                 **label_kw)
        x = dg.x[nodes.long()] * m[:, :, None].to(torch.float32) if use_x else None
        return adj, z, m, x

    bsz = cfg.batch_size

    @torch.no_grad()
    def predict_split(split: str) -> np.ndarray:
        model.eval()
        n = len(splits[split][0])
        outs = [model(*batch(split, torch.arange(s, min(s + bsz, n), device=dev)))
                for s in range(0, n, bsz)]
        model.train()
        return torch.cat(outs).cpu().numpy()

    loggers = {"AUC": Logger(cfg.runs), "AP": Logger(cfg.runs)}
    np_rng = np.random.default_rng(cfg.seed)
    y_train = splits["train"][1]
    L = len(y_train)
    steps = (L + bsz - 1) // bsz
    pad_n = steps * bsz - L
    # The last batch is padded with link 0 at loss weight 0; the padded
    # rows still enter the batch-norm statistics, as in the JAX package.
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
            out = model(*batch("train", idx), generator=drop_gen)
            loss = (bce_with_logits(out, y_train[idx]) * wb).sum() / torch.clamp(wb.sum(), min=1.0)
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
    return total_prep_time, best_scores[0], train_times, inference_times, n_params
