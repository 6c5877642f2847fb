"""WalkPool link predictor on padded dense subgraphs, in torch.

Port of ``s3grl_tpu/models/walkpool.py`` (reference
Software/WalkPooling/src/model.py): two GCN layers, a QK attention encoder
giving each edge a weight per head (:74-91), "plus" (with the candidate
link) and "minus" (without) random-walk transition matrices by an edge
softmax (:93-112), and walk profiles over walk lengths 2..walk_len+1:
node-level return probabilities, link-level transition probabilities and
graph-level trace differences (:114-219), scored by a 5-layer MLP
(:224-251).

Each per-edge softmax is a masked softmax over a [B, S, S] adjacency, and
each walk a chain of batched matrix products (``torch.bmm``), as in the
JAX package. The input adjacency must contain the candidate link at slots
(0, 1). Weights are initialized from an explicit ``torch.Generator``;
dropout masks are drawn from the generator passed to ``forward``.
"""
from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as Fn

from s3grl_tpu_torch.models.gnn import ZEmbedding, _dropout, gcn_norm_adj
from s3grl_tpu_torch.models.mlp import MaskedBatchNorm, _linear

WP_Z_MAX = 100  # reference: z_max default (src/main.py)


class WalkPoolClassifier(nn.Module):
    """5-layer MLP behind a batch norm with no mask (src/model.py:224-251).
    Layers ``lins[0..4]`` are the JAX package's ``Dense_0..4``."""

    def __init__(self, input_size: int, mse: bool = False, generator=None):
        super().__init__()
        L = input_size
        self.mse = mse
        self.norm = MaskedBatchNorm(L)
        dims = [L, L * 20, L * 20, L * 10, L, 1]
        self.lins = nn.ModuleList(
            _linear(a, b, generator) for a, b in zip(dims[:-1], dims[1:])
        )

    def forward(self, x, generator=None):
        x = self.norm(x)
        for lin in self.lins[:-1]:
            x = Fn.relu(lin(x))
        x = self.lins[-1](_dropout(x, 0.5, self.training, generator))
        if self.mse:
            x = torch.sigmoid(x)
        return x[:, 0]


def edge_weights(w, adj, mask):
    """(plus, minus, omega) from the attention logits ``w`` [B, S, S, heads]
    (``w[b, i, j]`` for the edge i -> j).

    plus: a softmax over the incoming edges of each column j (dim i), 0 off
    the edges; a column without edges softmaxes uniformly over -1e30 and is
    then zeroed. minus: ``exp(max(w - colmax, -60))``, colmax over every
    edge including the candidate, kept on the edges other than the
    candidate and normalized per column with ``+1e-16``. omega: the two
    candidate directions' sigmoids summed, per head [B, heads].
    """
    S = adj.shape[1]
    edge = (adj > 0) & mask[:, None, :] & mask[:, :, None]  # [B, S, S]
    cand = torch.zeros((S, S), dtype=torch.bool, device=adj.device)
    cand[0, 1] = cand[1, 0] = True
    edge_minus = edge & ~cand
    omega = torch.sigmoid(w[:, 0, 1, :]) + torch.sigmoid(w[:, 1, 0, :])
    e4 = edge[..., None]
    we = torch.where(e4, w, torch.full_like(w, -1e30))
    wp = torch.where(e4, torch.softmax(we, dim=1), torch.zeros_like(w))
    colmax = we.amax(dim=1, keepdim=True)
    wm = torch.exp(torch.clamp(we - colmax, min=-60.0))
    wm = torch.where(edge_minus[..., None], wm, torch.zeros_like(w))
    wm = wm / (wm.sum(dim=1, keepdim=True) + 1e-16)
    return wp, wm, omega


def walk_profiles(wmat, mask, walk_len: int):
    """(node, link, graph) profiles [B, walk_len] of one head's edge weights
    ``wmat`` [B, S, S]: the transition matrix is P = wmatᵀ and the chain
    starts at P, so the profiles read P², ..., P^(walk_len+1): node level
    ``[0, 0] + [1, 1]``, link level ``[0, 1] + [1, 0]``, graph level the
    trace over valid slots. Each power is read twice, its diagonal and its
    2 x 2 corner, so the backward writes two [B, S, S] gradients a power
    (a read of each entry would write one each)."""
    P = wmat.transpose(1, 2)
    state = P
    m = mask.to(P.dtype)
    node, link, graph = [], [], []
    for _ in range(walk_len):
        state = torch.bmm(P, state)
        diag = torch.diagonal(state, dim1=1, dim2=2)  # [B, S]
        corner = state[:, :2, :2]
        node.append(diag[:, 0] + diag[:, 1])
        link.append(corner[:, 0, 1] + corner[:, 1, 0])
        graph.append((diag * m).sum(dim=1))
    return torch.stack(node, 1), torch.stack(link, 1), torch.stack(graph, 1)


def walk_features(wp, wm, omega, mask, walk_len: int):
    """The classifier's input [B, heads * (5 walk_len + 1)], heads-major
    blocks: graph(plus - minus), omega, node plus, node minus, link plus,
    link minus (JAX walkpool.py:143-149)."""
    heads = wp.shape[-1]
    plus = [walk_profiles(wp[..., h], mask, walk_len) for h in range(heads)]
    minus = [walk_profiles(wm[..., h], mask, walk_len) for h in range(heads)]
    cat = lambda xs: torch.cat(xs, dim=1)  # noqa: E731
    graph = cat([plus[h][2] - minus[h][2] for h in range(heads)])
    return torch.cat([
        graph, omega,
        cat([p[0] for p in plus]), cat([m[0] for m in minus]),
        cat([p[1] for p in plus]), cat([m[1] for m in minus]),
    ], dim=1)


class WalkPoolLinkPred(nn.Module):
    """The JAX package's ``WalkPoolLinkPred``. ``in_features`` is the width
    of the node features (1 for the default ones column, 0 for none); with
    ``drnl`` the label embedding is concatenated after them.

    Layer names follow the flax ones: ``z_embedding`` (ZEmbedding_0),
    ``gcn1``, ``gcn2`` (Dense_0, Dense_1), ``q``, ``k`` (Dense_2, Dense_3),
    ``q_heads``, ``k_heads`` (Dense_4, Dense_5), ``classifier``
    (WalkPoolClassifier_0)."""

    def __init__(self, in_features: int, hidden_channels: int = 32, heads: int = 2,
                 walk_len: int = 7, drnl: bool = False, mse: bool = False, generator=None):
        super().__init__()
        H = hidden_channels
        self.hidden = H
        self.heads = heads
        self.walk_len = walk_len
        self.drnl = drnl
        self.z_embedding = ZEmbedding(H, generator) if drnl else None
        F = in_features + (H if drnl else 0)
        if F == 0:
            raise ValueError("WalkPool needs features (init_attribute/ones) or drnl")
        self.gcn1 = _linear(F, H, generator)
        self.gcn2 = _linear(H, H, generator)
        self.q = _linear(F + 2 * H, H, generator)
        self.k = _linear(F + 2 * H, H, generator)
        self.q_heads = _linear(H, heads * H, generator)
        self.k_heads = _linear(H, heads * H, generator)
        self.classifier = WalkPoolClassifier(heads * (5 * walk_len + 1), mse, generator)

    def forward(self, adj, z, mask, x=None, generator=None):
        """adj [B, S, S] containing the candidate link at slots (0, 1);
        z [B, S] labels (read with ``drnl``); mask [B, S]; x [B, S, F] or
        None. Returns the logits [B]."""
        B, S, _ = adj.shape
        H, heads = self.hidden, self.heads
        if self.drnl:
            z_emb = self.z_embedding(torch.clamp(z.to(torch.int64), 0, WP_Z_MAX - 1))
            x = z_emb if x is None else torch.cat([x, z_emb], dim=-1)

        # two GCN layers, jk-concat (src/model.py:42-51)
        norm_adj = gcn_norm_adj(adj, mask)
        h1 = torch.bmm(norm_adj, self.gcn1(x))
        h = _dropout(Fn.relu(h1), 0.5, self.training, generator)
        h2 = torch.bmm(norm_adj, self.gcn2(h))
        x_out = torch.cat([x, h1, h2], dim=-1)

        # attention edge weights (src/model.py:74-91)
        q = _dropout(Fn.leaky_relu(self.q(x_out), 0.2), 0.5, self.training, generator)
        k = _dropout(Fn.leaky_relu(self.k(x_out), 0.2), 0.5, self.training, generator)
        q = self.q_heads(q).reshape(B, S, heads, H)
        k = self.k_heads(k).reshape(B, S, heads, H)
        w = torch.einsum("bihc,bjhc->bijh", q, k) / math.sqrt(float(H))

        wp, wm, omega = edge_weights(w, adj, mask)
        feats = walk_features(wp, wm, omega, mask, self.walk_len)
        return self.classifier(feats, generator)
