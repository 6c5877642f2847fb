"""The plain reference of S3GRL's SoP (Subgraph of Powers) operators, in
plain PyTorch.

It imports nothing of the program and takes nothing the program made: its
caller hands it the observed graph, the features and the links it hands the
program, and it works out everything else again.

SoP (tuned_SIGN.py:49-134, ``get_SoP_prepped_ds``): Â = D^-1/2 A D^-1/2
over the binary adjacency A of the whole observed graph, D its row sums
(an isolated node's row and column stay zero). For a link (u, v) and each
power k = 1..K the two rows

    [Â^k[u,u] ⊕ (Â^k[u,:] with entry [u,v] zeroed) · X]
    [Â^k[v,v] ⊕ (Â^k[v,:] with entry [v,u] zeroed) · X]

and, as op 0, [1 ⊕ X[u]; 1 ⊕ X[v]]. Here the rows of Â^k are taken by
repeated dense products of the endpoints' one-hot rows with the dense Â, a
block of endpoint rows at a time, so that the [rows, N] state and the [N, N]
Â are all that is held; each row is zeroed and multiplied by X as the
published code does it, with no rank-1 shortcut.

Departures from the published description: the features and the graph
are whatever the caller gives (the paper trains node2vec dim-16 embeddings
on USAir's own graph; the benchmark generates its graphs from a seed).

``precision``: ``"float64"`` is the reference; ``"tf32"`` is the control,
the same arithmetic in float32 with every product's operands rounded to
TF32, as a float32 matmul with TF32 allowed computes it.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import Arith, RefGraph

ROW_BLOCK = 1024  # endpoint rows propagated together


def normalized_adjacency(g: RefGraph, dtype) -> torch.Tensor:
    """[N, N] dense Â of the binary adjacency of ``g`` (duplicate edges
    count once), in ``dtype``."""
    A = torch.zeros((g.n, g.n), dtype=dtype, device=g.device)
    A[g.src, g.dst] = 1.0
    deg = A.sum(dim=1)
    dinv = torch.where(deg > 0, deg.clamp(min=1e-30).rsqrt(), torch.zeros_like(deg))
    return dinv[:, None] * A * dinv[None, :]


def sop_rows(g: RefGraph, links: np.ndarray, *, sign_k: int,
             precision: str = "float64") -> torch.Tensor:
    """[L, K+1, 2, F+1] on ``g.device``: the SoP rows of every link."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arith = Arith(precision)
    links = torch.as_tensor(np.asarray(links, dtype=np.int64).reshape(-1, 2), device=g.device)
    L = links.shape[0]
    if L == 0:
        return torch.zeros((0, sign_k + 1, 2, g.x.shape[1] + 1), dtype=arith.dtype,
                           device=g.device)
    A_hat = normalized_adjacency(g, arith.dtype)
    x = g.x.to(arith.dtype)
    ends = links.reshape(-1)  # [2L]: u, v of each link in turn
    other = links[:, [1, 0]].reshape(-1)  # the entry each row zeroes
    ones = torch.ones((2 * L, 1), dtype=arith.dtype, device=g.device)
    ops = [torch.cat([ones, x[ends]], dim=1)]
    rows = [[] for _ in range(sign_k)]
    for start in range(0, 2 * L, ROW_BLOCK):
        e = ends[start:start + ROW_BLOCK]
        o = other[start:start + ROW_BLOCK]
        idx = torch.arange(e.shape[0], device=g.device)
        h = torch.zeros((e.shape[0], g.n), dtype=arith.dtype, device=g.device)
        h[idx, e] = 1.0
        for k in range(sign_k):
            h = arith.mm(h, A_hat)  # rows of Â^(k+1); Â is symmetric
            zeroed = h.clone()
            zeroed[idx, o] = 0.0
            rows[k].append(torch.cat([h[idx, e][:, None], arith.mm(zeroed, x)], dim=1))
    ops += [torch.cat(r) for r in rows]
    return torch.stack(ops, dim=1).reshape(L, 2, sign_k + 1, -1).transpose(1, 2)
