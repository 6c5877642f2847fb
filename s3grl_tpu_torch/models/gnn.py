"""SEAL-style GNN baselines on padded dense subgraph batches, in torch.

Port of ``s3grl_tpu/models/gnn.py`` (reference models.py: DGCNN :139-222,
GCN :12-75, SAGE :78-135, GIN :225-298). Each model embeds the structural
label z (Embedding(max_z=1000), sgrl_link_pred.py:929), optionally
concatenates node features, runs a conv stack, pools, and scores with an
MLP. A graph batch is dense padded tensors straight from the batched
extractor: adj [B, S, S], z [B, S] (or [B, S, 2] for de/de+), mask [B, S]
and x [B, S, F]; every conv is a batched matmul, sort-pooling is a sort
over one channel.

Weights are initialized as in the JAX package, from an explicit
``torch.Generator``; dropout and dropedge masks are drawn from the
generator passed to ``forward``, on the input's device. The JAX package's
``node_emb`` input has no caller and is left out.
"""
from __future__ import annotations

import math
import torch
from torch import nn
import torch.nn.functional as Fn

from s3grl_tpu_torch.models.mlp import MLP, MaskedBatchNorm, _linear
from s3grl_tpu_torch.ops.segment import gather_rows

MAX_Z = 1000  # reference: sgrl_link_pred.py:929


def _dropout(x, p: float, training: bool, generator):
    """Inverted dropout, the mask drawn from ``generator`` (flax's Dropout)."""
    if not training or p <= 0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


class ZEmbedding(nn.Module):
    """Embedding(max_z, hidden) with N(0, 1) init; z is cast to an integer
    (toward zero) and clipped to [0, max_z - 1]; multi-label z ([B, S, 2]
    for de/de+) sums the embeddings (models.py:47-48). The rows are
    gathered by ``ops/segment.gather_rows``, whose backward adds in a fixed
    order (``F.embedding``'s does not on the card)."""

    def __init__(self, hidden: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(MAX_Z, hidden))
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, z):
        emb = gather_rows(self.weight, torch.clamp(z.to(torch.int64), 0, MAX_Z - 1))
        return emb.sum(dim=2) if emb.dim() == 4 else emb


def gcn_norm_adj(adj, mask, edge_weight: bool = False):
    """GCNConv normalization: D^-1/2 (A + I) D^-1/2 over valid nodes."""
    m = mask.to(torch.float32)
    a = adj if edge_weight else (adj > 0).to(torch.float32)
    a = a * m[:, :, None] * m[:, None, :]
    a_hat = a + torch.eye(a.shape[-1], device=a.device)[None] * m[:, :, None]
    deg = a_hat.sum(dim=-1)
    dinv = torch.where(
        deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)), torch.zeros_like(deg)
    )
    return a_hat * dinv[:, :, None] * dinv[:, None, :]


def _binary_masked(adj, mask):
    m = mask.to(torch.float32)
    return (adj > 0).to(torch.float32) * m[:, :, None] * m[:, None, :]


class BatchedGCNConv(nn.Module):
    def __init__(self, in_features: int, features: int, generator=None):
        super().__init__()
        self.lin = _linear(in_features, features, generator)

    def forward(self, h, norm_adj):
        return torch.bmm(norm_adj, self.lin(h))


class BatchedSAGEConv(nn.Module):
    """SAGEConv(mean aggr): lin_l(mean_nbrs) + lin_r(x), lin_r bias-free."""

    def __init__(self, in_features: int, features: int, generator=None):
        super().__init__()
        self.lin_l = _linear(in_features, features, generator)
        self.lin_r = nn.Linear(in_features, features, bias=False)
        bound = 1.0 / math.sqrt(in_features)  # variance_scaling(1/3, fan_in, uniform)
        with torch.no_grad():
            self.lin_r.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, h, adj, mask):
        a = _binary_masked(adj, mask)
        deg = a.sum(dim=-1, keepdim=True)
        mean_nbr = torch.bmm(a, h) / torch.clamp(deg, min=1.0)
        return self.lin_l(mean_nbr) + self.lin_r(h)


class BatchedGINConv(nn.Module):
    """GINConv(train_eps=False): nn(x + sum_nbrs x), with nn =
    Sequential(Lin, ReLU, Lin, ReLU, BN) (models.py:241-248); the batch
    norm takes its statistics over valid nodes."""

    def __init__(self, in_features: int, features: int, generator=None):
        super().__init__()
        self.lin1 = _linear(in_features, features, generator)
        self.lin2 = _linear(features, features, generator)
        self.norm = MaskedBatchNorm(features)

    def forward(self, h, adj, mask):
        agg = h + torch.bmm(_binary_masked(adj, mask), h)
        y = Fn.relu(self.lin2(Fn.relu(self.lin1(agg))))
        return self.norm(y, mask)


def dropedge_mask(adj, p: float, generator=None):
    """dropout_adj(force_undirected): drop each undirected edge with
    probability p (models.py:41-44); the mask is drawn from ``generator``."""
    if p <= 0:
        return adj
    keep = torch.empty_like(adj).bernoulli_(1.0 - p, generator=generator) > 0
    upper = torch.triu(keep, diagonal=1)
    return adj * (upper | upper.transpose(-1, -2))


class _SEALModel(nn.Module):
    """The label embedding and input assembly every baseline shares."""

    def __init__(self, hidden_channels: int, use_feature: bool, num_features: int,
                 generator):
        super().__init__()
        self.use_feature = use_feature
        self.z_embedding = ZEmbedding(hidden_channels, generator)
        self.in_channels = hidden_channels + (num_features if use_feature else 0)

    def _input(self, z, x):
        h = self.z_embedding(z)
        if self.use_feature and x is not None:
            h = torch.cat([h, x], dim=-1)
        return h

    def _score_mlp(self, in_channels: int, dropout: float, channels, generator):
        return MLP(in_channels, channels, dropout=dropout, act="relu",
                   act_first=False, batch_norm=True, generator=generator)


class GCNModel(_SEALModel):
    """Reference GCN (models.py:12-75): GCNConv stack + center pooling."""

    def __init__(self, hidden_channels: int, num_layers: int, *, use_feature: bool = False,
                 num_features: int = 0, dropout: float = 0.5, dropedge: float = 0.0,
                 use_edge_weight: bool = False, generator=None):
        super().__init__(hidden_channels, use_feature, num_features, generator)
        self.dropout = dropout
        self.dropedge = dropedge
        self.use_edge_weight = use_edge_weight
        dims = [self.in_channels] + [hidden_channels] * num_layers
        self.convs = nn.ModuleList(
            BatchedGCNConv(a, b, generator) for a, b in zip(dims[:-1], dims[1:])
        )
        self.mlp = self._score_mlp(hidden_channels, dropout, [hidden_channels, 1], generator)

    def forward(self, adj, z, mask, x=None, generator=None):
        if self.training and self.dropedge > 0:
            adj = dropedge_mask(adj, self.dropedge, generator)
        h = self._input(z, x)
        norm_adj = gcn_norm_adj(adj, mask, self.use_edge_weight)
        for i, conv in enumerate(self.convs):
            h = conv(h, norm_adj)
            if i < len(self.convs) - 1:
                h = _dropout(Fn.relu(h), self.dropout, self.training, generator)
        pooled = h[:, 0] * h[:, 1]  # center pooling (models.py:62-66)
        return self.mlp(pooled, generator=generator)[:, 0]


class SAGEModel(_SEALModel):
    """Reference SAGE (models.py:78-135)."""

    def __init__(self, hidden_channels: int, num_layers: int, *, use_feature: bool = False,
                 num_features: int = 0, dropout: float = 0.5, dropedge: float = 0.0,
                 generator=None):
        super().__init__(hidden_channels, use_feature, num_features, generator)
        self.dropout = dropout
        self.dropedge = dropedge
        dims = [self.in_channels] + [hidden_channels] * num_layers
        self.convs = nn.ModuleList(
            BatchedSAGEConv(a, b, generator) for a, b in zip(dims[:-1], dims[1:])
        )
        self.mlp = self._score_mlp(hidden_channels, dropout, [hidden_channels, 1], generator)

    def forward(self, adj, z, mask, x=None, generator=None):
        if self.training and self.dropedge > 0:
            adj = dropedge_mask(adj, self.dropedge, generator)
        h = self._input(z, x)
        for i, conv in enumerate(self.convs):
            h = conv(h, adj, mask)
            if i < len(self.convs) - 1:
                h = _dropout(Fn.relu(h), self.dropout, self.training, generator)
        pooled = h[:, 0] * h[:, 1]
        return self.mlp(pooled, generator=generator)[:, 0]


class GINModel(_SEALModel):
    """Reference GIN (models.py:225-298): jk concat + masked mean pooling.
    The score MLP's dropout is 0.5 whatever the run's dropout, as in the
    JAX package (gnn.py:204-210), and the convs have none, so the JAX
    model's ``dropout`` field is read nowhere and is left out, as is its
    ``jk`` switch, which no caller turns off."""

    def __init__(self, hidden_channels: int, num_layers: int, *, use_feature: bool = False,
                 num_features: int = 0, generator=None):
        super().__init__(hidden_channels, use_feature, num_features, generator)
        dims = [self.in_channels] + [hidden_channels] * num_layers
        self.convs = nn.ModuleList(
            BatchedGINConv(a, b, generator) for a, b in zip(dims[:-1], dims[1:])
        )
        self.mlp = self._score_mlp(hidden_channels * num_layers, 0.5, [hidden_channels, 1],
                                   generator)

    def forward(self, adj, z, mask, x=None, generator=None):
        h = self._input(z, x)
        hs = []
        for conv in self.convs:
            h = conv(h, adj, mask)
            hs.append(h)
        feats = torch.cat(hs, dim=-1)
        m = mask.to(torch.float32)[:, :, None]
        pooled = (feats * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        return self.mlp(pooled, generator=generator)[:, 0]


def _conv1d(in_ch: int, out_ch: int, kernel: int, stride: int, generator):
    """Conv1d with the JAX package's init: weight U(±1/sqrt(kernel * in)),
    bias 0 (flax's default)."""
    conv = nn.Conv1d(in_ch, out_ch, kernel, stride=stride)
    bound = 1.0 / math.sqrt(kernel * in_ch)
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        conv.bias.zero_()
    return conv


class DGCNN(_SEALModel):
    """Reference DGCNN (models.py:139-222): tanh GCN stack -> sort-pool(k)
    -> two Conv1d stages -> MLP. ``k`` comes from the train subgraph sizes
    (60th percentile, models.py:148-158). The score MLP's dropout is 0.5."""

    def __init__(self, hidden_channels: int, num_layers: int, k: int, *,
                 use_feature: bool = False, num_features: int = 0,
                 dropedge: float = 0.0, generator=None):
        super().__init__(hidden_channels, use_feature, num_features, generator)
        self.k = k
        self.dropedge = dropedge
        dims = [self.in_channels] + [hidden_channels] * num_layers + [1]
        self.convs = nn.ModuleList(
            BatchedGCNConv(a, b, generator) for a, b in zip(dims[:-1], dims[1:])
        )
        D = hidden_channels * num_layers + 1
        # Conv1d(1, 16, kernel=D, stride=D): one tap per node row.
        self.conv1 = _conv1d(1, 16, D, D, generator)
        self.conv2 = _conv1d(16, 32, 5, 1, generator)
        self.mlp = self._score_mlp(32 * (k // 2 - 4), 0.5, [128, 1], generator)

    def forward(self, adj, z, mask, x=None, generator=None):
        if self.training and self.dropedge > 0:
            adj = dropedge_mask(adj, self.dropedge, generator)
        h = self._input(z, x)
        norm_adj = gcn_norm_adj(adj, mask)
        feats = []
        for conv in self.convs:
            h = torch.tanh(conv(h, norm_adj))
            feats.append(h)
        hcat = torch.cat(feats, dim=-1)  # [B, S, hidden * L + 1]
        B, S, D = hcat.shape

        # global_sort_pool: rows by the last channel, descending, first k.
        # jax.lax.top_k puts the lower index first on ties; a stable sort
        # keeps that order (torch.topk gives none).
        last = torch.where(mask, hcat[:, :, -1], torch.full_like(hcat[:, :, -1], -math.inf))
        top_idx = torch.sort(last, dim=1, descending=True, stable=True)[1][:, : min(self.k, S)]
        sel = torch.gather(hcat, 1, top_idx[:, :, None].expand(-1, -1, D))
        sel = sel * torch.gather(mask, 1, top_idx)[:, :, None].to(sel.dtype)
        if self.k > S:  # pad graphs smaller than k
            sel = Fn.pad(sel, (0, 0, 0, self.k - S))

        y = Fn.relu(conv1d_by_matmul(sel.reshape(B, 1, self.k * D), self.conv1))  # [B, k, 16]
        y = Fn.max_pool1d(y.transpose(1, 2), 2, 2)  # [B, 16, k // 2]
        y = Fn.relu(conv1d_by_matmul(y, self.conv2))  # [B, k // 2 - 4, 32]
        # Flatten length-major, as flax's [B, L, C] reshape does.
        return self.mlp(y.reshape(B, -1), generator=generator)[:, 0]


def conv1d_by_matmul(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """``conv(x)`` as matrix products, length-major: [B, C_in, L] ->
    [B, L_out, C_out]. One product per tap (a single one when the stride is
    the kernel width, as in DGCNN's first stage), so forward and backward
    are cuBLAS products and fixed-order adds: cuDNN's weight gradient for
    these shapes adds in an order that varies on the card, and SEAL runs
    did not repeat."""
    w, (kw,), (stride,) = conv.weight, conv.kernel_size, conv.stride
    B, C, L = x.shape
    if stride == kw and C == 1:
        windows = x[:, 0, : (L // kw) * kw].reshape(B, L // kw, kw)
        return Fn.linear(windows, w.reshape(w.shape[0], kw), conv.bias)
    if stride != 1:
        raise ValueError("conv1d_by_matmul takes stride 1 or one channel at stride = kernel")
    L_out = L - kw + 1
    xt = x.transpose(1, 2)  # [B, L, C_in]
    out = conv.bias
    for t in range(kw):
        out = out + Fn.linear(xt[:, t : t + L_out], w[:, :, t])
    return out
