"""Sparse-matrix × dense-matrix products (SpMM) over an edge list.

Port of ``s3grl_tpu/ops/spmm.py``: the edge-list route of the SoP global
chain, gather + ``index_add_``. Plain torch; the block-sparse kernel route
is ``ops/spmm_kernel.py``. On the card ``index_add_`` adds with atomics, so
the last bits of a sum vary from run to run.
"""
from __future__ import annotations

import torch


def spmm(
    edge_src: torch.Tensor,  # [E] integer
    edge_dst: torch.Tensor,  # [E] integer
    edge_weight: torch.Tensor,  # [E] float
    x: torch.Tensor,  # [N, C]
    num_nodes: int,
) -> torch.Tensor:
    """Y[v] = sum over edges (u -> v) of w_e * X[u].

    This computes A^T X for A[u, v] = w_(u->v); for the symmetric normalized
    adjacencies used everywhere in S3GRL, A^T X = A X.
    """
    contrib = x[edge_src] * edge_weight[:, None].to(x.dtype)  # [E, C]
    out = torch.zeros((num_nodes, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, edge_dst, contrib)


def normalized_adjacency_weights(
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    num_nodes: int,
) -> torch.Tensor:
    """Edge weights of D^-1/2 A D^-1/2 for the *binary* adjacency.

    Reference: the SoP global normalization (sgrl_link_pred.py:165-173) builds
    SparseTensor(row, col) — implicit 1s — then scales by deg^-1/2 both sides.
    """
    deg = torch.zeros(num_nodes, dtype=torch.float32, device=edge_dst.device)
    deg.index_add_(0, edge_dst, torch.ones(edge_dst.shape, device=edge_dst.device))
    inv_sqrt = torch.where(
        deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)), torch.zeros_like(deg)
    )
    return inv_sqrt[edge_src] * inv_sqrt[edge_dst]
