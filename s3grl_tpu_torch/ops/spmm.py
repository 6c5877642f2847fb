"""Sparse-matrix × dense-matrix products (SpMM) over an edge list.

Port of ``s3grl_tpu/ops/spmm.py``: the edge-list route of the SoP global
chain, a gather and a sum per destination node. Plain torch; the
block-sparse kernel route is ``ops/spmm_kernel.py``. :func:`edge_list`
sorts the edges by destination (and, for the backward, by source) once;
every :func:`spmm` then adds each row's terms in that fixed order
(``ops/segment.sum_sorted``), with no sort and no host sync, so a product
and its gradient repeat bit for bit on the card (``index_add_``'s atomics
did not).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from s3grl_tpu_torch.ops.segment import segment_lengths, sum_sorted


class _Rows(NamedTuple):
    """One direction of an edge list, sorted stably by the row each term
    adds into."""

    gather: torch.Tensor  # [E] the row of X each term reads
    weight: torch.Tensor  # [E]
    lengths: torch.Tensor  # [N] terms per output row

    @classmethod
    def sorted_by(cls, into, gather, weight, num_nodes: int) -> "_Rows":
        order = torch.argsort(into, stable=True)
        return cls(gather[order], weight[order], segment_lengths(into[order], num_nodes))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return sum_sorted(x[self.gather] * self.weight[:, None].to(x.dtype), self.lengths)


class EdgeList(NamedTuple):
    """Weighted edges (src -> dst) sorted both ways."""

    by_dst: _Rows  # Y = A^T X
    by_src: _Rows  # its backward, A G


def edge_list(edge_src: torch.Tensor, edge_dst: torch.Tensor, edge_weight: torch.Tensor,
              num_nodes: int) -> EdgeList:
    """The edge list of A[u, v] = w_(u->v), sorted once for :func:`spmm`."""
    return EdgeList(_Rows.sorted_by(edge_dst, edge_src, edge_weight, num_nodes),
                    _Rows.sorted_by(edge_src, edge_dst, edge_weight, num_nodes))


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, edges):
        ctx.edges = edges
        return edges.by_dst.apply(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.edges.by_src.apply(grad), None


def spmm(edges: EdgeList, x: torch.Tensor) -> torch.Tensor:
    """Y[v] = sum over edges (u -> v) of w_e * X[u], for X [N, C].

    This computes A^T X for A[u, v] = w_(u->v); for the symmetric normalized
    adjacencies used everywhere in S3GRL, A^T X = A X. The gradient with
    respect to X is A G, summed in the same fixed way.
    """
    return _SpMM.apply(x, edges)


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
