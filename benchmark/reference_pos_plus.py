"""The plain reference of S3GRL's PoS Plus: PoS with the rows of the
targets' common neighbours ("CCN" rows), and SIGNNet's CCN pooling, in
plain PyTorch.

It imports nothing of the program and takes nothing the program made: its
caller hands it the graph, features, links and weights it hands the
program, and it works out everything else again.

PoS Plus (tuned_SIGN.py:192-262, ``get_PoS_Plus_prepped_ds``): for a link
(s, d), the members as :func:`benchmark.reference.members` gives them (s, d,
then the nodes within ``num_hops`` hops by (hop, id), the first
``max_nodes``); the binary adjacency A among the members without the link
itself; the CCN set, the members other than s and d that are neighbours in
A of both s and d (``intersection``) or of either (``union``), in member
order (tuned_SIGN.py:229-238); Â = D^-1/2 A D^-1/2; the rows [s, d] + CCN
of Â^k [1 | X] for k = 0..K, where the column of ones marks s and d only.
Each link keeps exactly 2 + |CCN| rows (tuned_SIGN.py:238).

SIGNNet with CCN pooling (models.py:339-368): one Linear -> ELU ->
BatchNorm -> Dropout layer on every kept row, the BatchNorm's statistics
over the kept rows of the batch; the product of the two target rows; the
mean (or sum) of the link's CCN rows beside it; Linear -> ReLU -> BatchNorm
-> Dropout -> Linear to a logit. Departure: a link with no CCN row pools
zeros, as PyG's scatter mean gives a link inside the batch; the published
code's pooled tensor is shorter than the batch where its last links have
no CCN row, and the port pads instead.

``precision``: ``"float64"`` is the reference; ``"tf32"`` is the control,
the same arithmetic in float32 with every product's operands rounded to
TF32, as a float32 matmul with TF32 allowed computes it.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import Arith, RefGraph, _batch_norm, members


def pos_plus_link(g: RefGraph, s: int, d: int, *, num_hops: int, sign_k: int, max_nodes: int,
                  strategy: str, arith: Arith) -> torch.Tensor:
    """[K+1, 2 + |CCN|, F+1]: the PoS Plus rows of link (s, d)."""
    nodes = members(g, s, d, num_hops, max_nodes)
    S = int(nodes.numel())
    pos = torch.full((g.n,), -1, dtype=torch.long, device=g.device)
    pos[nodes] = torch.arange(S, device=g.device)
    ps, pd = pos[g.src], pos[g.dst]
    inside = (ps >= 0) & (pd >= 0)
    A = torch.zeros((S, S), dtype=arith.dtype, device=g.device)
    A[ps[inside], pd[inside]] = 1.0
    A[0, 1] = 0.0
    A[1, 0] = 0.0
    if strategy == "intersection":
        ccn = (A[0] > 0) & (A[1] > 0)
    elif strategy == "union":
        ccn = (A[0] > 0) | (A[1] > 0)
    else:
        raise ValueError(f"strategy must be intersection or union, got {strategy!r}")
    ccn[:2] = False
    rows = torch.cat([torch.arange(2, device=g.device), torch.nonzero(ccn).squeeze(1)])
    deg = A.sum(dim=1)
    dinv = torch.where(deg > 0, deg.clamp(min=1e-30).rsqrt(), torch.zeros_like(deg))
    A_hat = dinv[:, None] * A * dinv[None, :]
    ind = torch.zeros((S, 1), dtype=arith.dtype, device=g.device)
    ind[:2] = 1.0
    subg_x = torch.cat([ind, g.x[nodes].to(arith.dtype)], dim=1)
    h = torch.zeros((len(rows), S), dtype=arith.dtype, device=g.device)
    h[torch.arange(len(rows), device=g.device), rows] = 1.0
    out = [subg_x[rows]]
    for _ in range(sign_k):
        h = arith.mm(h, A_hat)  # rows of Â^k; Â is symmetric
        out.append(arith.mm(h, subg_x))
    return torch.stack(out)


def pos_plus_rows(g: RefGraph, links: np.ndarray, *, num_hops: int, sign_k: int,
                  max_nodes: int, strategy: str, width: int,
                  precision: str = "float64") -> tuple[torch.Tensor, torch.Tensor]:
    """(rows [L, K+1, R, F+1], row mask [L, R]) on ``g.device``: each
    link's :func:`pos_plus_link` rows, zero-padded to R = the larger of
    ``width`` and the most rows a link keeps, and True on the rows kept."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arith = Arith(precision)
    per = [pos_plus_link(g, int(s), int(d), num_hops=num_hops, sign_k=sign_k,
                         max_nodes=max_nodes, strategy=strategy, arith=arith)
           for s, d in np.asarray(links).reshape(-1, 2)]
    R = max([width] + [p.shape[1] for p in per])
    F1 = int(g.x.shape[1]) + 1
    xs = torch.zeros((len(per), sign_k + 1, R, F1), dtype=arith.dtype, device=g.device)
    mask = torch.zeros((len(per), R), dtype=torch.bool, device=g.device)
    for i, p in enumerate(per):
        xs[i, :, :p.shape[1]] = p
        mask[i, :p.shape[1]] = True
    return xs, mask


def signnet_plus(p: dict, x: torch.Tensor, mask: torch.Tensor, arith: Arith, *, pool: str,
                 train: bool, keep=(None, None), dropout: float = 0.5) -> torch.Tensor:
    """Logits [B] of SIGNNet with CCN pooling (``pool`` ``mean`` or
    ``sum``) and parameters ``p`` (``benchmark.reference.init_params``' names;
    ``w2`` takes the 2 x hidden pooled width) on rows ``x`` [B, R, D] with
    row mask [B, R], rows 0 and 1 the targets. In training the batch
    statistics update the running ones and ``keep`` holds the two dropout
    masks."""
    a = torch.nn.functional.elu(arith.mm(x, p["w1"].t()) + p["b1"])
    h = _batch_norm(p, 1, a, mask, train)
    if train:
        h = h * keep[0].to(h.dtype) / (1.0 - dropout)
    centre = h[:, 0] * h[:, 1]
    ccn = mask[:, 2:].to(h.dtype)[..., None]
    pooled = (h[:, 2:] * ccn).sum(dim=1)
    if pool == "mean":
        pooled = pooled / ccn.sum(dim=1).clamp(min=1.0)
    elif pool != "sum":
        raise ValueError(f"pool must be mean or sum, got {pool!r}")
    a = torch.relu(arith.mm(torch.cat([centre, pooled], dim=1), p["w2"].t()) + p["b2"])
    h = _batch_norm(p, 2, a, None, train)
    if train:
        h = h * keep[1].to(h.dtype) / (1.0 - dropout)
    return (arith.mm(h, p["w3"].t()) + p["b3"])[:, 0]
