"""Link-prediction heuristics: CN, AA, PPR.

Port of ``s3grl_tpu/heuristics.py`` (reference: utils.py:681-742, scipy row
products and fast_pagerank): adjacency rows are densified per link batch
from the padded neighbor table with one ``scatter_add_``, and PPR is a
batched power iteration whose dense state advances by the edge-list SpMM.
Plain torch on the run's device.
"""
from __future__ import annotations

import numpy as np
import torch

from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.data.split import EdgeSplit
from s3grl_tpu_torch.ops.spmm import edge_list, spmm
from s3grl_tpu_torch.sampling.extraction import DeviceGraph
from s3grl_tpu_torch.train.metrics import evaluate_auc

PPR_DAMPING = 0.85
PPR_ITERS = 100
BATCH_SIZE = 4096  # links scored per call of a heuristic


def _dense_rows(dg: DeviceGraph, nodes: torch.Tensor) -> torch.Tensor:
    """Adjacency rows A[nodes] -> [B, N] from the padded neighbor table."""
    w = dg.nbr_w[nodes] * dg.nbr_mask[nodes]
    out = torch.zeros((nodes.shape[0], dg.num_nodes), device=w.device)
    return out.scatter_add_(1, dg.nbr[nodes].long(), w)


def cn_scores(dg: DeviceGraph, links: torch.Tensor) -> torch.Tensor:
    """Common Neighbors: sum(A[src] * A[dst]) (utils.py:681-690)."""
    return (_dense_rows(dg, links[:, 0]) * _dense_rows(dg, links[:, 1])).sum(dim=1)


def aa_scores(dg: DeviceGraph, links: torch.Tensor) -> torch.Tensor:
    """Adamic-Adar: sum(A[src] * A[dst] / log deg) (utils.py:693-706); a
    degree of 0 or 1 weighs 0."""
    deg = torch.zeros(dg.num_nodes, device=dg.device).index_add_(
        0, dg.edge_dst, dg.edge_weight
    )
    mult = torch.where(deg > 0, 1.0 / torch.log(deg), torch.zeros_like(deg))
    mult = torch.where(torch.isfinite(mult), mult, torch.zeros_like(mult))
    rd = _dense_rows(dg, links[:, 1]) * mult[None, :]
    return (_dense_rows(dg, links[:, 0]) * rd).sum(dim=1)


def ppr_scores(dg: DeviceGraph, links: torch.Tensor) -> torch.Tensor:
    """Personalized PageRank of dst under src's PPR vector (utils.py:709-742,
    fast_pagerank.pagerank_power), damping PPR_DAMPING, PPR_ITERS steps: a
    column-stochastic transition, the dangling nodes' mass returned to the
    personalization. The state is [N, B], one column per link, so each step
    is one edge-list SpMM."""
    N = dg.num_nodes
    out_deg = torch.zeros(N, device=dg.device).index_add_(0, dg.edge_src, dg.edge_weight)
    inv_out = torch.where(out_deg > 0, 1.0 / out_deg, torch.zeros_like(out_deg))
    dangling = (out_deg == 0).to(torch.float32)
    edges = edge_list(dg.edge_src, dg.edge_dst, dg.edge_weight * inv_out[dg.edge_src], N)
    src = links[:, 0].long()
    p0 = torch.zeros((N, links.shape[0]), device=dg.device)
    p0[src, torch.arange(links.shape[0], device=dg.device)] = 1.0
    s = p0
    for _ in range(PPR_ITERS):
        sw = spmm(edges, s)
        dang = (s * dangling[:, None]).sum(dim=0, keepdim=True)
        s = PPR_DAMPING * (sw + dang * p0) + (1.0 - PPR_DAMPING) * p0
    return s[links[:, 1].long(), torch.arange(links.shape[0], device=dg.device)]


HEURISTICS = {"CN": cn_scores, "AA": aa_scores, "PPR": ppr_scores}


def heuristic_scores(graph: Graph, links: np.ndarray, name: str, *, device="cuda") -> np.ndarray:
    """Scores of ``links`` [L, 2] by heuristic ``name``, in batches of
    BATCH_SIZE."""
    from s3grl_tpu_torch.utils.device import resolve_device

    dg = DeviceGraph.from_graph(graph, device=resolve_device(device))
    fn = HEURISTICS[name]
    links = torch.as_tensor(np.asarray(links, dtype=np.int64), device=dg.device)
    outs = [fn(dg, links[s : s + BATCH_SIZE]) for s in range(0, len(links), BATCH_SIZE)]
    return torch.cat(outs).cpu().numpy() if outs else np.zeros(0, np.float32)


def run_heuristic(graph: Graph, edge_split: EdgeSplit, cfg: RunConfig, *, device="cuda"):
    """Heuristic evaluation path (sgrl_link_pred.py:1049-1095). Returns the
    reference's result tuple with the RAW test AUC in [0, 1]: the reference
    returns ``results[0][0][-1]`` without the x100 of the learning path."""
    sd = edge_split.as_dict()
    preds = {
        (split, kind): heuristic_scores(
            graph, sd[split][kind], cfg.use_heuristic, device=device
        )
        for split in ("valid", "test")
        for kind in ("edge", "edge_neg")
    }

    def pred_true(split):
        pos, neg = preds[(split, "edge")], preds[(split, "edge_neg")]
        return (np.concatenate([pos, neg]),
                np.concatenate([np.ones(len(pos)), np.zeros(len(neg))]))

    results = evaluate_auc(*pred_true("valid"), *pred_true("test"))
    return 0.0, results["AUC"][1], [], [], 0
