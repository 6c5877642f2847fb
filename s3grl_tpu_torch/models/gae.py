"""Graph autoencoder init-representation models: GAE / VGAE / ARGVA.

Port of ``s3grl_tpu/models/gae.py`` (reference: baselines/vgae.py): GCN
encoders and an inner-product decoder trained on the observed
(train-positive) graph; the learned node embeddings replace ``data.x``
(sgrl_link_pred.py:973-988: hidden = hidden/2, out = embedding_dim).

Reference bug kept (``faithful_bug=True``): the reference compares the
module object with the strings 'ARGVA'/'VGAE' (baselines/vgae.py:120,126),
so no KL term is ever added and the ARGVA discriminator never trains; every
variant optimizes the reconstruction loss only. ``faithful_bug=False``
adds the textbook KL term.

The global GCN convolution is the edge-list SpMM (``ops/spmm.spmm``), as
the JAX package uses its XLA SpMM here and no Pallas kernel. It and the
row gathers of the loss (``ops/segment.gather_rows``) add in a fixed
order, so the embeddings repeat bit for bit on the card.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.ops.segment import gather_rows
from s3grl_tpu_torch.ops.spmm import EdgeList, edge_list, spmm
from s3grl_tpu_torch.train.metrics import evaluate_auc


def _gcn_norm_edges(edge_index: np.ndarray, num_nodes: int, device="cpu") -> EdgeList:
    """GCNConv normalization with self loops (degrees counted on the
    destination side, in float64 on the host as the JAX package does)."""
    edge_index = np.asarray(edge_index, dtype=np.int64)
    ei = np.concatenate(
        [edge_index, np.tile(np.arange(num_nodes, dtype=np.int64), (2, 1))], axis=1
    )
    deg = np.zeros(num_nodes)
    np.add.at(deg, ei[1], 1.0)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-300)), 0.0)
    w = dinv[ei[0]] * dinv[ei[1]]
    return edge_list(
        torch.as_tensor(ei[0], device=device), torch.as_tensor(ei[1], device=device),
        torch.as_tensor(w, dtype=torch.float32, device=device), num_nodes,
    )


def _glorot(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform(-a, a), a = sqrt(6 / (fan_in + fan_out))."""
    lim = float(np.sqrt(6.0 / (shape[0] + shape[1])))
    return torch.rand(shape, generator=generator, device=device) * (2 * lim) - lim


class GCNAutoEncoder(nn.Module):
    """The GAE encoder (two GCN layers) or, ``variational``, the VGAE/ARGVA
    one (a GCN layer, then GCN heads for mu and log sigma). Parameters carry
    the JAX package's names: ``w1``, ``w2`` or ``w1``, ``w_mu``, ``w_ls``."""

    def __init__(self, in_channels: int, hidden_channels: int, embedding_dim: int,
                 variational: bool, *, generator: torch.Generator, device="cpu"):
        super().__init__()
        self.variational = variational
        heads = ("w_mu", "w_ls") if variational else ("w2",)
        self.w1 = nn.Parameter(_glorot((in_channels, hidden_channels), generator, device))
        for name in heads:
            setattr(self, name, nn.Parameter(
                _glorot((hidden_channels, embedding_dim), generator, device)))

    def forward(self, edges: EdgeList, x: torch.Tensor, *,
                generator: torch.Generator | None = None, sample: bool = False):
        """(z, mu, logstd); mu and logstd are None for GAE, and z = mu
        unless ``sample``, which draws ``mu + eps * exp(logstd)``."""
        h = torch.relu(spmm(edges, x @ self.w1))
        if not self.variational:
            return spmm(edges, h @ self.w2), None, None
        mu = spmm(edges, h @ self.w_mu)
        logstd = spmm(edges, h @ self.w_ls)
        if sample:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device)
            return mu + eps * torch.exp(logstd), mu, logstd
        return mu, mu, logstd


def _recon_loss(z, pos_src, pos_dst, neg_src, neg_dst) -> torch.Tensor:
    """PyG GAE.recon_loss: -log sigma(z_u . z_v) on positives plus
    -log(1 - sigma(.)) on uniformly sampled negatives (eps 1e-15)."""
    eps = 1e-15
    pos = torch.sigmoid((gather_rows(z, pos_src) * gather_rows(z, pos_dst)).sum(-1))
    neg = torch.sigmoid((gather_rows(z, neg_src) * gather_rows(z, neg_dst)).sum(-1))
    return -torch.log(pos + eps).mean() - torch.log(1 - neg + eps).mean()


def link_scores(z: np.ndarray, pos: np.ndarray, neg: np.ndarray):
    """(sigmoid of the inner products, labels) of [2, E] positive and
    negative links, on the host as the JAX package scores them."""
    pos, neg = np.asarray(pos), np.asarray(neg)
    s = np.concatenate([(z[pos[0]] * z[pos[1]]).sum(-1), (z[neg[0]] * z[neg[1]]).sum(-1)])
    t = np.concatenate([np.ones(pos.shape[1]), np.zeros(neg.shape[1])])
    return 1 / (1 + np.exp(-s)), t


def features_or_identity(graph: Graph, device) -> torch.Tensor:
    """The graph's features, or the identity where it has none."""
    x = graph.x if graph.x is not None else np.eye(graph.num_nodes, dtype=np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def run_gae(
    graph: Graph,
    edge_index: np.ndarray,  # [2, E] train edges (message passing + recon)
    test_and_val: Tuple[np.ndarray, ...],  # (test_pos, test_neg, val_pos, val_neg) [2, E]
    model: str = "GAE",
    *,
    embedding_dim: int = 128,
    hidden_channels: int = 64,
    lr: float = 1e-4,
    epochs: int = 50,
    seed: int = 1,
    faithful_bug: bool = True,
    device="cuda",
) -> Tuple[float, np.ndarray]:
    """Train the autoencoder on ``device``; returns (the test AUC x100 of
    the highest-valid epoch, the LAST epoch's embeddings [N, D]), as the
    reference does (baselines/vgae.py:160-170)."""
    from s3grl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    N = graph.num_nodes
    x = features_or_identity(graph, dev)
    edges = _gcn_norm_edges(edge_index, N, dev)
    variational = model in ("VGAE", "ARGVA")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    enc = GCNAutoEncoder(x.shape[1], hidden_channels, embedding_dim, variational,
                         generator=gen, device=dev)
    opt = torch.optim.Adam(enc.parameters(), lr=lr)
    pos_src = torch.as_tensor(np.asarray(edge_index[0], np.int64), device=dev)
    pos_dst = torch.as_tensor(np.asarray(edge_index[1], np.int64), device=dev)
    E = pos_src.shape[0]
    add_kl = variational and not faithful_bug

    test_pos, test_neg, val_pos, val_neg = test_and_val
    history = []
    for _ in range(epochs):
        neg_src = torch.randint(0, N, (E,), generator=gen, device=dev)
        neg_dst = torch.randint(0, N, (E,), generator=gen, device=dev)
        z, mu, logstd = enc(edges, x, generator=gen, sample=True)
        loss = _recon_loss(z, pos_src, pos_dst, neg_src, neg_dst)
        if add_kl:
            logstd_c = torch.clamp(logstd, max=10.0)
            kl = -0.5 * torch.mean(
                torch.sum(1 + 2 * logstd_c - mu**2 - torch.exp(logstd_c) ** 2, dim=1)
            )
            loss = loss + kl / N
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        with torch.no_grad():
            zh = enc(edges, x)[0].cpu().numpy()
        r = evaluate_auc(*link_scores(zh, val_pos, val_neg), *link_scores(zh, test_pos, test_neg))
        history.append((r["AUC"][0], r["AUC"][1]))

    best_test = max(history, key=lambda h: h[0])[1]
    return 100 * best_test, zh
