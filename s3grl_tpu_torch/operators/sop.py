"""SoP (Subgraph of Powers) operator precompute on the GPU.

Port of ``s3grl_tpu/operators/sop.py`` (reference semantics:
``OptimizedSignOperations.get_SoP_prepped_ds``, tuned_SIGN.py:49-134): for
each link (src, dst) and power k of the globally sym-normalized adjacency Â,
store

    x_k = [ [Â^k[src,src],  (Â^k[src,:] with entry [src,dst] zeroed) · X ]
            [Â^k[dst,dst],  (Â^k[dst,:] with entry [dst,src] zeroed) · X ] ]

and x = [[1, X[src]], [1, X[dst]]]. No sparse matrix and no SpGEMM:

1. the global chain ``Y_k = Â^k X`` runs once, through the sparse SpMM
   kernel (``ops/spmm_kernel.power_chain``) or the edge-list route
   (``ops/spmm.spmm``), as :func:`~s3grl_tpu_torch.ops.spmm_kernel.should_use_bsr`
   picks from the graph's shape;
2. per batch of links, the endpoint one-hot columns go through the chain
   by the same route, ``R_k = Â R_{k-1}``, giving the scalars Â^k[u,v] and
   Â^k[u,u];
3. the target-entry zeroing is a rank-1 correction:
   (row - a_uv e_v) · X = Y_k[u] - a_uv X[v].

The JAX package pads the last batch to the full batch size to avoid
recompiles; here the last batch runs ragged, with the same output.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from s3grl_tpu_torch.operators.common import OperatorDataset
from s3grl_tpu_torch.ops.spmm import EdgeList, edge_list, normalized_adjacency_weights, spmm
from s3grl_tpu_torch.ops.spmm_kernel import blockify, bsr_spmm, power_chain, should_use_bsr
from s3grl_tpu_torch.sampling.extraction import DeviceGraph


def _sop_power_features(
    edges: EdgeList,
    x_global: torch.Tensor,  # [N, F]
    *,
    sign_k: int,
) -> torch.Tensor:
    """Global diffusion chain Y_k = Â^k X on the edge list, stacked [K, N, F]."""
    ys = []
    y = x_global
    for _ in range(sign_k):
        y = spmm(edges, y)
        ys.append(y)
    return torch.stack(ys, dim=0)


def _sop_batch(
    propagate: Callable[[torch.Tensor], torch.Tensor],
    x_global: torch.Tensor,  # [N, F]
    ys: torch.Tensor,  # [K, N, F] global Â^k X
    links: torch.Tensor,  # [B, 2] int64
    *,
    sign_k: int,
    num_nodes: int,
) -> torch.Tensor:
    """SoP operator features for one link batch: [B, K+1, 2, F+1].

    Only the scalar entries Â^k[u,v] / Â^k[u,u] need per-batch propagation;
    the feature product reuses the global chain:
    (Â^k[u,:] with [u,v] zeroed) · X  =  Y_k[u] - Â^k[u,v] · X[v].
    ``propagate(Y)`` is Â Y for Y [N, C]; the state is the 2B one-hot
    endpoint columns, R_k = Â^k [e_u ...] (Â is symmetric).
    """
    B = links.shape[0]
    F = x_global.shape[1]
    dev = x_global.device
    src, dst = links[:, 0], links[:, 1]

    ends = torch.stack([src, dst], dim=1).reshape(-1)  # [2B]
    other = torch.stack([dst, src], dim=1).reshape(-1)  # counterpart per row
    cols = torch.arange(2 * B, device=dev)
    R = torch.zeros((num_nodes, 2 * B), dtype=torch.float32, device=dev)
    R[ends, cols] = 1.0

    # x (op 0): [1 | X[endpoint]]  (tuned_SIGN.py:119-124)
    x0 = torch.cat([torch.ones((B, 2, 1), device=dev), x_global[links]], dim=-1)
    x_other = x_global[other]  # [2B, F]

    ops = [x0]
    for k in range(sign_k):
        R = propagate(R)  # [N, 2B]
        a_uv = R[other, cols]  # Â^k[u, v] (the zeroed entry)
        a_uu = R[ends, cols]  # Â^k[u, u] (h-diagonal prepend)
        g = ys[k][ends] - a_uv[:, None] * x_other  # [2B, F]
        gh = torch.cat([a_uu[:, None], g], dim=-1)  # [2B, F+1]
        ops.append(gh.reshape(B, 2, F + 1))

    return torch.stack(ops, dim=1)  # [B, K+1, 2, F+1]


def sop_batch_size(num_nodes: int, num_edges: int) -> int:
    """Links per batch of :func:`precompute_sop`. Two memory costs scale
    with the batch: the [N, 2B] propagation state and the [E, 2B]
    edge-message temporary inside each edge-list SpMM. Budget about 192 MB
    of state and 384 MB per edge-message temporary."""
    return max(16, min(4096, 24_000_000 // max(num_nodes, 1),
                       48_000_000 // max(num_edges, 1)))


def precompute_sop(
    dg: DeviceGraph,
    links: np.ndarray,  # [L, 2]
    y: np.ndarray,
    *,
    sign_k: int,
    batch_size: int = 0,
    device="cuda",
) -> OperatorDataset:
    """SoP precompute over all links, batch by batch. ``dg`` must lie on
    ``device``.

    :func:`should_use_bsr` picks the route of the global ``Â^k X`` chain
    from the graph's shape, on every device, so the CPU takes the card's
    route. The per-batch endpoint-row propagation takes the same route:
    ``bsr_spmm`` over the chain's CSR form, or the edge list. Both add each
    row's terms in a fixed order, so the operators repeat bit for bit on
    the card. The JAX package's ``x_override`` (no caller) is left out.
    """
    from s3grl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dg.device != dev:
        raise ValueError(
            f"DeviceGraph lies on {dg.device}, precompute_sop asked for {dev}"
        )
    if dg.x is None:
        raise ValueError("SoP requires node features")
    x_global = dg.x
    N = dg.num_nodes
    F = int(x_global.shape[1])
    L = links.shape[0]
    links = np.asarray(links, dtype=np.int64)

    # Normalized weights on the host (E-sized, cheap): blockify reads them
    # there, and the card gets one copy.
    src_h, dst_h, _ = dg.host_edges()
    norm_w_h = normalized_adjacency_weights(
        torch.as_tensor(src_h, dtype=torch.int64),
        torch.as_tensor(dst_h, dtype=torch.int64), N,
    ).numpy()
    norm_w = torch.as_tensor(norm_w_h, device=dev)

    if should_use_bsr(src_h, dst_h, N, F):
        adj = blockify(src_h, dst_h, norm_w_h, N, device=dev)
        ys = power_chain(adj, x_global, sign_k)

        def propagate(y):
            return bsr_spmm(adj, y)
    else:
        edges = edge_list(dg.edge_src, dg.edge_dst, norm_w, N)
        ys = _sop_power_features(edges, x_global, sign_k=sign_k)

        def propagate(y):
            return spmm(edges, y)

    if batch_size <= 0:
        batch_size = sop_batch_size(N, int(dg.edge_src.shape[0]))

    xs = torch.empty((L, sign_k + 1, 2, F + 1), dtype=torch.float32, device=dev)
    for start in range(0, L, batch_size):
        lb = torch.as_tensor(links[start : start + batch_size], device=dev)
        xs[start : start + len(lb)] = _sop_batch(
            propagate, x_global, ys, lb, sign_k=sign_k, num_nodes=N,
        )

    return OperatorDataset(
        xs=xs,
        row_mask=torch.ones((L, 2), dtype=torch.bool, device=dev),
        y=np.asarray(y, dtype=np.float32),
    )
