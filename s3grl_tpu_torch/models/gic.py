"""GIC (Graph InfoClust) init-representation model.

Port of ``s3grl_tpu/models/gic.py`` (reference: Software/GIC/): one GCN
layer (a Linear with xavier init, the SpMM over D^-1/2 (A+I) D^-1/2, then
PReLU), a DGI bilinear discriminator against row-shuffled features, and a
ClusterNet cosine soft-k-means cluster discriminator (10 iterations from a
fixed random init, then 1 from the stopped-gradient centres). Loss =
alpha * BCE(DGI logits) + (1 - alpha) * BCE(cluster logits) with (beta,
alpha, K) per dataset (GICEmbs.py:96-108).

Reference quirks kept:
- the optimizer steps ONLY on epochs whose loss does not improve the best
  so far (GICEmbs.py:156-166 puts backward and step in the else branch);
- early stopping with patience 100 on the training loss;
- the embeddings are the L2-normalized encoder rows of the last
  evaluation, NaN rows zeroed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.models.gae import NormEdges, features_or_identity
from s3grl_tpu_torch.train.metrics import evaluate_auc

DATASET_HPARAMS = {
    # data_name -> (beta, alpha, num_clusters)  (GICEmbs.py:96-108)
    "cora": (100.0, 0.5, 128),
    "citeseer": (100.0, 0.5, 128),
    "pubmed": (10.0, 0.75, 32),
}
DEFAULT_HPARAMS = (100.0, 0.5, 10)


def _norm_adj_with_self_loops(edge_index: np.ndarray, n: int, device="cpu") -> NormEdges:
    """normalize_adj(A + I): D^-1/2 (A+I) D^-1/2 (GICEmbs.py:121), degrees
    counted on the source side in float64 on the host."""
    edge_index = np.asarray(edge_index, dtype=np.int64)
    ei = np.concatenate([edge_index, np.tile(np.arange(n, dtype=np.int64), (2, 1))], axis=1)
    deg = np.zeros(n)
    np.add.at(deg, ei[0], 1.0)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-300)), 0.0)
    w = dinv[ei[0]] * dinv[ei[1]]
    return NormEdges(
        torch.as_tensor(ei[0], device=device), torch.as_tensor(ei[1], device=device),
        torch.as_tensor(w, dtype=torch.float32, device=device), n,
    )


def _soft_kmeans(h: torch.Tensor, mu_init: torch.Tensor, beta: float, num_iter: int):
    """ClusterNet cosine soft k-means (layers/cluster.py:13-51): (the
    centres after ``num_iter`` updates, the soft assignment of the last
    iteration's similarities)."""
    data = h / (torch.linalg.norm(h, dim=1, keepdim=True) + 1e-6)
    mu = mu_init
    for _ in range(num_iter):
        mu = mu / (torch.linalg.norm(mu, dim=1, keepdim=True) + 1e-6)
        dist = data @ mu.T  # [N, K]
        r = torch.softmax(beta * dist, dim=1)
        mu = (r.T @ data) / r.sum(dim=0)[:, None]
    return mu, torch.softmax(beta * dist, dim=1)


class GICModel(nn.Module):
    """The GCN encoder and the DGI bilinear discriminator, with the JAX
    package's parameter names (``w_gcn``, ``b_gcn``, ``prelu_a``, ``w_bil``,
    ``b_bil``) and the fixed cluster init ``mu_init`` as a buffer."""

    def __init__(self, in_channels: int, hidden: int, num_clusters: int, *,
                 generator: torch.Generator, device="cpu"):
        super().__init__()

        def uniform(shape, lim):
            return torch.rand(shape, generator=generator, device=device) * (2 * lim) - lim

        self.w_gcn = nn.Parameter(uniform((in_channels, hidden),
                                          float(np.sqrt(6.0 / (in_channels + hidden)))))
        self.b_gcn = nn.Parameter(torch.zeros(hidden, device=device))
        self.prelu_a = nn.Parameter(torch.full((1,), 0.25, device=device))
        # DGI bilinear f(h, c) = h W c + b (xavier init, bias 0)
        self.w_bil = nn.Parameter(uniform((hidden, hidden), float(np.sqrt(6.0 / (2 * hidden)))))
        self.b_bil = nn.Parameter(torch.zeros(1, device=device))
        self.register_buffer(
            "mu_init", torch.rand((num_clusters, hidden), generator=generator, device=device)
        )

    def encode(self, edges: NormEdges, feats: torch.Tensor) -> torch.Tensor:
        h = edges.propagate(feats @ self.w_gcn) + self.b_gcn
        return torch.where(h > 0, h, self.prelu_a * h)  # PReLU


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, mean."""
    return -(labels * F.logsigmoid(logits) + (1 - labels) * F.logsigmoid(-logits)).mean()


def gic_loss(model: GICModel, edges: NormEdges, x: torch.Tensor, shuf_idx: torch.Tensor,
             beta: float, alpha: float) -> torch.Tensor:
    """alpha * DGI BCE + (1 - alpha) * cluster BCE for one shuffle."""
    N = x.shape[0]
    h1 = model.encode(edges, x)
    h2 = model.encode(edges, x[shuf_idx])
    # The cluster summary of each node: c2 = sigmoid(R @ mu).
    mu0, _ = _soft_kmeans(h1, model.mu_init, beta, 10)
    mu, r = _soft_kmeans(h1, mu0.detach(), beta, 1)
    c2 = torch.sigmoid(r @ mu)  # [N, H]
    c = torch.sigmoid(h1.mean(dim=0))  # the DGI graph summary [H]
    sc1 = (h1 @ model.w_bil) @ c + model.b_bil[0]
    sc2 = (h2 @ model.w_bil) @ c + model.b_bil[0]
    lbl = torch.cat([torch.ones(N, device=x.device), torch.zeros(N, device=x.device)])
    bce1 = _bce(torch.cat([sc1, sc2]), lbl)
    bce2 = _bce(torch.cat([(h1 * c2).sum(dim=1), (h2 * c2).sum(dim=1)]), lbl)
    return alpha * bce1 + (1 - alpha) * bce2


def run_gic(
    graph: Graph,
    edge_index: np.ndarray,  # [2, E] train edges
    test_and_val: Tuple[np.ndarray, ...],
    *,
    embedding_dim: int = 128,
    lr: float = 1e-4,
    epochs: int = 50,
    eval_steps: int = 1,
    patience: int = 100,
    seed: int = 1,
    dataset: str = "",
    init_params: Optional[dict] = None,
    device="cuda",
) -> Tuple[float, np.ndarray]:
    """Train GIC on ``device``; returns (best test AUC x100, embeddings
    [N, D]). ``init_params`` replaces the initial weights with ones in the
    JAX package's layout (``models/convert.gic_state_dict_from_jax``'s
    input); the shuffles come from ``np.random.default_rng(seed)``."""
    from s3grl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    beta, alpha, num_clusters = DATASET_HPARAMS.get(dataset.lower(), DEFAULT_HPARAMS)
    N = graph.num_nodes
    x = features_or_identity(graph, dev)
    edges = _norm_adj_with_self_loops(edge_index, N, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = GICModel(x.shape[1], embedding_dim, num_clusters, generator=gen, device=dev)
    if init_params is not None:
        from s3grl_tpu_torch.models.convert import gic_state_dict_from_jax

        model.load_state_dict(gic_state_dict_from_jax(init_params))
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    def embed() -> np.ndarray:
        with torch.no_grad():
            h = model.encode(edges, x)
            return torch.nan_to_num(h / torch.linalg.norm(h, dim=1, keepdim=True)).cpu().numpy()

    def roc(embs, pos, neg):
        s = embs @ embs.T
        pred = 1 / (1 + np.exp(-np.concatenate([s[pos[0], pos[1]], s[neg[0], neg[1]]])))
        return pred, np.concatenate([np.ones(pos.shape[1]), np.zeros(neg.shape[1])])

    test_pos, test_neg, val_pos, val_neg = [np.asarray(a) for a in test_and_val]
    rng = np.random.default_rng(seed)
    best = np.inf
    cnt_wait = 0
    history = []
    embs = embed()
    for epoch in range(epochs):
        shuf = torch.as_tensor(rng.permutation(N), device=dev)
        loss = gic_loss(model, edges, x, shuf, beta, alpha)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.item()
        if loss < best:
            # The reference quirk: an improving epoch only records its loss.
            best = loss
            cnt_wait = 0
        else:
            cnt_wait += 1
            if cnt_wait == patience:
                break
            opt.step()
        if epoch % eval_steps == 0:
            embs = embed()
            r = evaluate_auc(*roc(embs, val_pos, val_neg), *roc(embs, test_pos, test_neg))
            history.append((r["AUC"][0], r["AUC"][1]))

    best_test = max(history, key=lambda h: h[0])[1] if history else 0.0
    return 100 * best_test, embs
