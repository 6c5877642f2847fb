"""Non-subgraph baselines on the GPU: MF, plain GNN link prediction,
node2vec + logistic regression.

Port of ``s3grl_tpu/models/baselines.py`` (reference baselines/mf.py: a
node embedding and an MLP over hadamard products; baselines/gnn_link_pred.py:
a 3-layer GCN/SAGE/GIN encoder, a dot-product decoder and fresh negatives
each epoch; baselines/n2v.py: node2vec embeddings and sklearn's
LogisticRegression over hadamard link features). Each epoch is one
full-batch step over every train positive and as many uniform negative
pairs, drawn from a ``torch.Generator`` on the run's device; the weights
start from a generator on the CPU. Rows are gathered, and edge lists
summed, in a fixed order (``ops/segment.py``, ``ops/spmm.py``), so seeded runs repeat on
the card. The logistic regression is written in torch (sklearn is not a
dependency of the port).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as Fn

from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.data.split import EdgeSplit
from s3grl_tpu_torch.models.gae import _gcn_norm_edges
from s3grl_tpu_torch.models.gnn import _dropout
from s3grl_tpu_torch.ops.segment import gather_rows
from s3grl_tpu_torch.ops.spmm import edge_list, spmm
from s3grl_tpu_torch.train.logger import Logger
from s3grl_tpu_torch.train.metrics import evaluate_auc
from s3grl_tpu_torch.utils.device import resolve_device


def _uniform(shape, bound: float, generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator) * (2 * bound) - bound


def _split_edges(edge_split: EdgeSplit, split: str) -> Tuple[np.ndarray, np.ndarray]:
    """(edges [L, 2], labels [L]) of a split: positives, then negatives."""
    d = edge_split.as_dict()[split]
    pos, neg = np.asarray(d["edge"]), np.asarray(d["edge_neg"])
    return np.concatenate([pos, neg]), np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])


def _uniform_pairs(n_pairs: int, num_nodes: int, generator, device) -> torch.Tensor:
    """[n_pairs, 2] uniform node pairs (mf.py's "trivial random sampling")."""
    return torch.randint(0, num_nodes, (n_pairs, 2), generator=generator, device=device)


def _best_auc(score_fn, edge_split: EdgeSplit, logger: dict) -> None:
    """Score valid and test with ``score_fn(edges [L, 2] numpy) -> [L]``
    and log AUC and AP."""
    (ve, vy), (te, ty) = (_split_edges(edge_split, s) for s in ("valid", "test"))
    for k, v in evaluate_auc(score_fn(ve), vy, score_fn(te), ty).items():
        logger[k].add_result(0, v)


# --------------------------------------------------------------------------
# MF (baselines/mf.py)
# --------------------------------------------------------------------------
class MFModel(nn.Module):
    """A node embedding ``emb`` [N, H] (N(0, 1)) and an MLP over the
    hadamard product of two rows, ``lins[i]`` the JAX package's ``w{i}`` /
    ``b{i}`` (weights U(±1/sqrt(fan_in)), biases 0)."""

    def __init__(self, num_nodes: int, hidden_channels: int, num_layers: int = 3,
                 dropout: float = 0.5, generator=None):
        super().__init__()
        self.dropout = dropout
        self.emb = nn.Parameter(torch.randn((num_nodes, hidden_channels), generator=generator))
        dims = [hidden_channels] * num_layers + [1]
        self.lins = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        with torch.no_grad():
            for lin, fan_in in zip(self.lins, dims[:-1]):
                lin.weight.copy_(_uniform((lin.out_features, fan_in), 1 / math.sqrt(fan_in),
                                          generator))
                lin.bias.zero_()

    def forward(self, edges: torch.Tensor, generator=None) -> torch.Tensor:
        """Link probabilities [L] of ``edges`` [L, 2]."""
        x = gather_rows(self.emb, edges[:, 0]) * gather_rows(self.emb, edges[:, 1])
        for lin in self.lins[:-1]:
            x = _dropout(Fn.relu(lin(x)), self.dropout, self.training, generator)
        return torch.sigmoid(self.lins[-1](x)[:, 0])


def mf_loss(model: MFModel, pos: torch.Tensor, neg: torch.Tensor, generator=None):
    """-mean log(p + 1e-15) over the positives - mean log(1 - p + 1e-15)
    over the negatives (mf.py:40-70)."""
    p = model(pos, generator)
    n = model(neg, generator)
    return -torch.log(p + 1e-15).mean() - torch.log(1 - n + 1e-15).mean()


def train_mf(
    graph: Graph,
    edge_split: EdgeSplit,
    *,
    hidden_channels: int = 256,
    num_layers: int = 3,
    dropout: float = 0.5,
    lr: float = 0.01,
    epochs: int = 200,
    eval_steps: int = 1,
    seed: int = 1,
    device="cuda",
) -> Tuple[float, Dict]:
    """Matrix factorization; returns (best test AUC, {"model": MFModel}).
    Each epoch is one Adam step on every train positive and as many uniform
    negative pairs; epochs 0, eval_steps, ... are scored."""
    dev = resolve_device(device)
    model = MFModel(graph.num_nodes, hidden_channels, num_layers, dropout,
                    generator=torch.Generator().manual_seed(seed)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    pos = torch.as_tensor(np.asarray(edge_split.train_pos, dtype=np.int64), device=dev)

    @torch.no_grad()
    def score(edges: np.ndarray) -> np.ndarray:
        model.eval()
        out = model(torch.as_tensor(edges.astype(np.int64), device=dev)).cpu().numpy()
        model.train()
        return out

    logger = {"AUC": Logger(1), "AP": Logger(1)}
    for epoch in range(epochs):
        loss = mf_loss(model, pos, _uniform_pairs(len(pos), graph.num_nodes, gen, dev), gen)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if epoch % eval_steps == 0:
            _best_auc(score, edge_split, logger)
    return logger["AUC"].print_statistics(), {"model": model}


# --------------------------------------------------------------------------
# Plain GNN link prediction (baselines/gnn_link_pred.py)
# --------------------------------------------------------------------------
class GNNEncoder(nn.Module):
    """Three GCN, SAGE or GIN layers over the whole graph, by edge-list
    SpMM. Parameters carry the JAX package's names and [in, out] layout:
    GCN ``w{i}``, ``b{i}``; SAGE ``wl{i}``, ``bl{i}``, ``wr{i}``; GIN
    ``w{i}a``, ``b{i}a``, ``w{i}b``, ``b{i}b``. Weights are Glorot-uniform,
    drawn in that order, biases 0."""

    def __init__(self, layer: str, in_channels: int, hidden_channels: int,
                 dropout: float = 0.5, generator=None):
        super().__init__()
        if layer not in ("GCN", "SAGE", "GIN"):
            raise ValueError(f"unknown GNN layer {layer!r}")
        self.layer = layer
        self.dropout = dropout
        dims = [in_channels] + [hidden_channels] * 3
        shapes = {}
        for i in range(3):
            a, b = dims[i], dims[i + 1]
            if layer == "GIN":
                shapes.update({f"w{i}a": (a, b), f"b{i}a": (b,), f"w{i}b": (b, b), f"b{i}b": (b,)})
            elif layer == "SAGE":
                shapes.update({f"wl{i}": (a, b), f"bl{i}": (b,), f"wr{i}": (a, b)})
            else:
                shapes.update({f"w{i}": (a, b), f"b{i}": (b,)})
        self.params = nn.ParameterDict()
        for name, shape in shapes.items():
            if len(shape) == 1:
                self.params[name] = nn.Parameter(torch.zeros(shape))
            else:
                lim = math.sqrt(6.0 / (shape[0] + shape[1]))
                self.params[name] = nn.Parameter(_uniform(shape, lim, generator))

    def conv(self, i: int, h, gcn_edges, edges, deg):
        p = self.params
        if self.layer == "GCN":
            return spmm(gcn_edges, h @ p[f"w{i}"]) + p[f"b{i}"]
        agg = spmm(edges, h)
        if self.layer == "SAGE":
            agg = agg / torch.clamp(deg, min=1.0)[:, None]
            return agg @ p[f"wl{i}"] + p[f"bl{i}"] + h @ p[f"wr{i}"]
        y = Fn.relu((h + agg) @ p[f"w{i}a"] + p[f"b{i}a"])  # GIN: nn(x + sum_nbrs x)
        return Fn.relu(y @ p[f"w{i}b"] + p[f"b{i}b"])

    def forward(self, x, gcn_edges, edges, deg, generator=None):
        h = x
        for i in range(3):
            h = self.conv(i, h, gcn_edges, edges, deg)
            if i < 2:
                if self.layer != "GIN":
                    h = Fn.relu(h)
                h = _dropout(h, self.dropout, self.training, generator)
        return h


def gnn_loss(z: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE of the dot-product logits of positives (label 1)
    and negatives (label 0)."""
    logits = torch.cat([(gather_rows(z, pos[:, 0]) * gather_rows(z, pos[:, 1])).sum(-1),
                        (gather_rows(z, neg[:, 0]) * gather_rows(z, neg[:, 1])).sum(-1)])
    labels = torch.cat([torch.ones(len(pos), device=z.device),
                        torch.zeros(len(neg), device=z.device)])
    return Fn.binary_cross_entropy_with_logits(logits, labels)


def gnn_graph_inputs(graph: Graph, device):
    """(x, gcn_edges, edges, deg) of the encoder: the features,
    or the identity where the graph has none; the GCN-normalized edges with
    self loops; the raw edges and the in-degrees for SAGE and GIN."""
    N = graph.num_nodes
    x_np = graph.x if graph.x is not None else np.eye(N, dtype=np.float32)
    x = torch.as_tensor(np.asarray(x_np, dtype=np.float32), device=device)
    ei = np.asarray(graph.edge_index, np.int64)
    src = torch.as_tensor(ei[0], device=device)
    dst = torch.as_tensor(ei[1], device=device)
    deg = torch.as_tensor(np.bincount(ei[1], minlength=N).astype(np.float32), device=device)
    edges = edge_list(src, dst, torch.ones(len(src), device=device), N)
    return x, _gcn_norm_edges(ei, N, device), edges, deg


def train_gnn(
    graph: Graph,
    edge_split: EdgeSplit,
    *,
    layer: str = "GCN",
    hidden_channels: int = 256,
    dropout: float = 0.5,
    lr: float = 0.01,
    epochs: int = 100,
    eval_steps: int = 1,
    seed: int = 1,
    device="cuda",
) -> Tuple[float, Dict]:
    """3-layer encoder and dot-product decoder; returns (best test AUC,
    {"model": GNNEncoder}). Each epoch is one Adam step on every train
    positive and as many fresh uniform negative pairs."""
    dev = resolve_device(device)
    inputs = gnn_graph_inputs(graph, dev)
    model = GNNEncoder(layer, inputs[0].shape[1], hidden_channels, dropout,
                       generator=torch.Generator().manual_seed(seed)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    pos = torch.as_tensor(np.asarray(edge_split.train_pos, dtype=np.int64), device=dev)

    @torch.no_grad()
    def score(edges: np.ndarray) -> np.ndarray:
        model.eval()
        z = model(*inputs)
        model.train()
        e = torch.as_tensor(edges.astype(np.int64), device=dev)
        return torch.sigmoid((z[e[:, 0]] * z[e[:, 1]]).sum(-1)).cpu().numpy()

    logger = {"AUC": Logger(1), "AP": Logger(1)}
    for epoch in range(epochs):
        neg = _uniform_pairs(len(pos), graph.num_nodes, gen, dev)
        loss = gnn_loss(model(*inputs, generator=gen), pos, neg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if epoch % eval_steps == 0:
            _best_auc(score, edge_split, logger)
    return logger["AUC"].print_statistics(), {"model": model}


# --------------------------------------------------------------------------
# node2vec + logistic regression (baselines/n2v.py)
# --------------------------------------------------------------------------
def fit_logistic_regression(
    x: torch.Tensor, y: torch.Tensor, C: float = 1.0, max_iter: int = 500
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w [F], b) minimizing sklearn's LogisticRegression objective with its
    defaults (L2 penalty, C = 1, a fitted intercept that is not penalized,
    the lbfgs solver): sum of the log losses + ||w||² / (2 C). Solved in
    float64 by L-BFGS with a strong-Wolfe line search, the objective divided
    by the number of samples."""
    x = x.to(torch.float64)
    y = y.to(torch.float64)
    n = x.shape[0]
    params = torch.zeros(x.shape[1] + 1, dtype=torch.float64, device=x.device,
                         requires_grad=True)
    opt = torch.optim.LBFGS([params], lr=1.0, max_iter=max_iter, history_size=20,
                            tolerance_grad=1e-12, tolerance_change=1e-15,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = logistic_objective(x, y, params[:-1], params[-1], C) / n
        loss.backward()
        return loss

    opt.step(closure)
    w = params.detach()
    return w[:-1], w[-1]


def logistic_objective(x, y, w, b, C: float = 1.0) -> torch.Tensor:
    """sklearn's L2 logistic regression objective:
    sum log(1 + exp(-(2y - 1)(x·w + b))) + ||w||² / (2 C)."""
    z = x @ w + b
    return Fn.softplus(-(2 * y - 1) * z).sum() + (w @ w) / (2 * C)


def run_n2v(
    graph: Graph,
    edge_split: EdgeSplit,
    *,
    hidden_channels: int = 128,
    epochs: int = 10,
    lr: float = 0.01,
    seed: int = 1,
    device="cuda",
) -> float:
    """node2vec embeddings, then a logistic regression on the hadamard
    products of the train links' embeddings; valid and test are scored by
    its hard class predictions, as the reference does (n2v.py:88-119 uses
    ``clf.predict``). Returns the best test AUC."""
    from s3grl_tpu_torch.models.n2v import node2vec_pretrain

    dev = resolve_device(device)
    emb = torch.as_tensor(
        node2vec_pretrain(graph, embedding_dim=hidden_channels, epochs=epochs, lr=lr,
                          seed=seed, device=dev),
        device=dev,
    )

    def feats(edges: np.ndarray) -> torch.Tensor:
        e = torch.as_tensor(edges.astype(np.int64), device=dev)
        return emb[e[:, 0]] * emb[e[:, 1]]

    train_e, train_y = _split_edges(edge_split, "train")
    w, b = fit_logistic_regression(feats(train_e), torch.as_tensor(train_y, device=dev))

    def predict(edges: np.ndarray) -> np.ndarray:
        return ((feats(edges).to(torch.float64) @ w + b) > 0).to(torch.float64).cpu().numpy()

    logger = {"AUC": Logger(1), "AP": Logger(1)}
    _best_auc(predict, edge_split, logger)
    return logger["AUC"].print_statistics()

