"""Preprocessing-cost analyzer (the calc_ratio mode).

Port of ``s3grl_tpu/analysis.py`` (reference utils.py:319-422): the node
and edge counts of SEAL's k-hop subgraphs against ScaLed's random-walk
ones (named SWEAL in the reference), their means accumulated over seeds in
an ``.npz`` scratch file, and on the final seed written to
``calc_ratio/preprocessing_stats_{ds}_{split}.json``. The counts come from
the batched extractors on the device.
"""
from __future__ import annotations

import json
import os
from pprint import pprint

import numpy as np
import torch

from s3grl_tpu_torch.sampling.extraction import DeviceGraph, extract_subgraphs
from s3grl_tpu_torch.sampling.random_walk import extract_rw_subgraphs


def subgraph_counts(
    dg: DeviceGraph,
    links: np.ndarray,
    *,
    num_hops: int,
    max_nodes: int,
    rw_m: int = 0,
    rw_M: int = 0,
    seed: int = 1,
    batch_size: int = 256,
) -> tuple[np.ndarray, np.ndarray]:
    """(num_nodes [L], num_edges [L]) of every link's subgraph: SEAL's BFS
    extraction, or ScaLed's walks where ``rw_m`` and ``rw_M`` are both set.
    Edges are the directed neighbor entries, the target link removed; link
    i's walks are seeded ``seed * 1_000_003 + i``, as in the JAX package."""
    L = len(links)
    nodes_out = np.empty(L, dtype=np.int64)
    edges_out = np.empty(L, dtype=np.int64)
    seeds = (np.int64(seed) * 1_000_003 + np.arange(L)).astype(np.int32)
    for s in range(0, L, batch_size):
        lb = torch.as_tensor(links[s : s + batch_size].astype(np.int64), device=dg.device)
        if rw_m and rw_M:
            ls = torch.as_tensor(seeds[s : s + batch_size].astype(np.int64), device=dg.device)
            sub = extract_rw_subgraphs(dg, lb, ls, rw_m=rw_m, rw_M=rw_M, max_nodes=max_nodes)
        else:
            sub = extract_subgraphs(dg, lb, num_hops=num_hops, max_nodes=max_nodes)
        nodes_out[s : s + len(lb)] = sub.node_mask.sum(dim=1).cpu().numpy()
        edges_out[s : s + len(lb)] = (sub.nbr_w > 0).sum(dim=(1, 2)).cpu().numpy()
    return nodes_out, edges_out


def calc_ratio_helper(
    pos_links: np.ndarray,
    neg_links: np.ndarray,
    dg: DeviceGraph,
    *,
    num_hops: int,
    max_nodes: int,
    rw_m: int,
    rw_M: int,
    split: str = "train",
    dataset_name: str = "",
    seed: int = 1,
    out_dir: str = "calc_ratio",
    scratch_dir: str = ".",
    final_seed: int = 5,
):
    """Add this seed's SEAL and ScaLed mean counts to the scratch file
    ``saved_calc_ratio{dataset_name}.npz`` (started afresh at seed 1); at
    ``final_seed`` write the stats JSON, delete the scratch file and return
    the stats (utils.py:348-422). Returns None before that."""
    links = np.concatenate([pos_links, neg_links], axis=0)
    seal_n, seal_e = subgraph_counts(dg, links, num_hops=num_hops, max_nodes=max_nodes,
                                     seed=seed)
    sweal_n, sweal_e = subgraph_counts(dg, links, num_hops=num_hops, max_nodes=max_nodes,
                                       rw_m=rw_m, rw_M=rw_M, seed=seed)

    scratch = os.path.join(scratch_dir, f"saved_calc_ratio{dataset_name}.npz")
    if seed == 1 or not os.path.exists(scratch):
        acc = {k: np.array([], dtype=np.float64) for k in
               ("seal_nodes", "sweal_nodes", "seal_edges", "sweal_edges")}
    else:
        with np.load(scratch) as loaded:
            acc = {k: loaded[k] for k in loaded.files}

    acc["seal_nodes"] = np.append(acc["seal_nodes"], seal_n.mean())
    acc["sweal_nodes"] = np.append(acc["sweal_nodes"], sweal_n.mean())
    acc["seal_edges"] = np.append(acc["seal_edges"], seal_e.mean())
    acc["sweal_edges"] = np.append(acc["sweal_edges"], sweal_e.mean())
    np.savez(scratch, **acc)

    if seed != final_seed:
        return None
    stats = {
        split: {
            "SEAL average no of nodes": f"{round(acc['seal_nodes'].mean())}",
            "SWEAL average no of nodes": f"{round(acc['sweal_nodes'].mean())}",
            "SEAL average no of edges": f"{round(acc['seal_edges'].mean())}",
            "SWEAL average no of edges": f"{round(acc['sweal_edges'].mean())}",
        }
    }
    pprint(stats, sort_dicts=False)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"preprocessing_stats_{dataset_name}_{split}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(stats, f, ensure_ascii=False)
    os.remove(scratch)
    return stats
