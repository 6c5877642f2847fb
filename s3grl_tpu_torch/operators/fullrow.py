"""Non-optimized ("full-row") SIGN operator precompute in torch.

Port of ``s3grl_tpu/operators/fullrow.py`` (reference: the
``optimize_sign=False`` branch of ``extract_enclosing_subgraphs``,
utils.py:497-553). Per link the whole enclosing subgraph is kept:

- **PoS**: the structural label z is the FIRST feature column
  (utils.py:308-312) and ``x{k} = (D^-1/2 A D^-1/2)^k [z | x]`` for
  k = 1..K over ALL subgraph rows (tuned_SIGN.py:13-23). node_label is
  live here: drnl / de / de+ / hop / zo / degree all reach the features.
- **SoP**: with ``num_hops=-1`` the subgraph of Â^k around (s, d) is the
  2x2 diagonal after target-link removal, so
  ``x{k} = diag(Â^k[s,s], Â^k[d,d]) @ [z_k | x_{s,d}]``
  (utils.py:532-550, tuned_SIGN.py:25-44). Other num_hops give per-power
  subgraphs of different sizes that the reference model cannot consume
  (models.py:374), and are rejected.

One batch of links is extracted, labeled and propagated at once. The JAX
package propagates by gathering neighbor rows ``[B, S, D, Z+F]`` and
summing them with the normalized weights, which XLA fuses; eager torch
would materialize that gather (13 GB for 128 links at S = 256, D = 96,
F = 1,025). Here the same weights are scattered once into the dense
normalized sub-adjacency ``[B, S, S]`` and each power is one batched
product with it: the same sum in another order. Â^k itself is never
formed. The dataset is assembled on the run's device, where the
optimized flows keep theirs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from s3grl_tpu_torch.operators.common import OperatorDataset
from s3grl_tpu_torch.operators.pos import measure_subgraph_sizes
from s3grl_tpu_torch.ops.spmm import EdgeList, edge_list, normalized_adjacency_weights, spmm
from s3grl_tpu_torch.sampling.extraction import (
    DeviceGraph,
    SubgraphBatch,
    dense_adjacency,
    extract_subgraphs,
    pick_bucket,
)
from s3grl_tpu_torch.sampling.labeling import label_nodes

# f32 elements of the [B, S, S] labeling and [B, S, (K+1)(Z+F)] operator
# tensors per batch, as in the JAX package (fullrow.py:211-217).
ELEM_BUDGET = 192_000_000


def _label_columns(
    sub: SubgraphBatch, node_label: str, max_label_dist: int
) -> torch.Tensor:
    """z as feature column(s) [B, S, Z] (Z = 2 for de/de+, else 1)."""
    m = sub.node_mask.to(torch.float32)
    if node_label == "zo":
        return ((sub.dist == 0).to(torch.float32) * m)[:, :, None]
    if node_label == "hop":
        return (sub.dist.to(torch.float32) * m)[:, :, None]
    z = label_nodes(
        dense_adjacency(sub), sub.dist, sub.node_mask,
        node_label=node_label, max_iters=max_label_dist,
    )
    return z[:, :, None] if z.dim() == 2 else z


def _extract_and_operate_fullrow(
    dg: DeviceGraph,
    links: torch.Tensor,  # [B, 2]
    *,
    num_hops: int,
    max_nodes: int,
    ratio_per_hop: float,
    max_nodes_per_hop,
    sign_k: int,
    node_label: str,
    max_label_dist: int,
):
    """Extraction + labeling + full-row PoS power chain for one batch.

    Returns (xs [B, K+1, S, Z+F], row_mask [B, S]).
    """
    sub = extract_subgraphs(
        dg, links, num_hops=num_hops, max_nodes=max_nodes,
        ratio_per_hop=ratio_per_hop, max_nodes_per_hop=max_nodes_per_hop,
    )
    B, S = sub.nodes.shape
    D = sub.nbr_local.shape[2]
    m = sub.node_mask.to(torch.float32)

    z = _label_columns(sub, node_label, max_label_dist)  # [B, S, Z]
    x_sub = dg.x[sub.nodes.long()] * m[:, :, None]  # [B, S, F]
    subg_x = torch.cat([z, x_sub], dim=-1)  # label first (utils.py:308-312)

    # Sym-normalized weights on the local neighbor structure, as in the
    # optimized path (tuned_SIGN.py:155-161):
    # w'[i, d] = dinv[i] * w[i, d] * dinv[j(i, d)].
    nbr_local = sub.nbr_local.long()
    deg = sub.nbr_w.sum(dim=-1)
    dinv = torch.where(
        deg > 0, 1.0 / torch.sqrt(torch.clamp(deg, min=1e-30)), torch.zeros_like(deg)
    )
    dinv_j = torch.gather(dinv, 1, nbr_local.reshape(B, S * D)).reshape(B, S, D)
    a_norm = dense_adjacency(sub._replace(nbr_w=sub.nbr_w * dinv[:, :, None] * dinv_j))

    ops = [subg_x]
    for _ in range(sign_k):
        ops.append(torch.bmm(a_norm, ops[-1]))
    xs = torch.stack(ops, dim=1) * m[:, None, :, None]  # [B, K+1, S, Z+F]
    return xs, sub.node_mask


def precompute_pos_fullrow(
    dg: DeviceGraph,
    links: np.ndarray,  # [L, 2]
    y: np.ndarray,
    *,
    num_hops: int,
    sign_k: int,
    node_label: str = "drnl",
    max_label_dist: int = 32,
    ratio_per_hop: float = 1.0,
    max_nodes_per_hop: Optional[int] = None,
    buckets=(32, 64, 128, 256, 512, 1024),
    batch_size: int = 256,
    max_subgraph_nodes: int = 1024,
    device="cuda",
) -> OperatorDataset:
    """The non-optimized PoS flow (utils.py:497-531). ``dg`` must lie on
    ``device``.

    Links are bucketed by subgraph size as in the optimized flow; every
    bucket's rows are padded to the LARGEST bucket used, so one
    ``[L, K+1, S, Z+F]`` dataset comes out. The JAX package's ``seed``
    feeds only per-hop sampling, which the port does not have yet.
    """
    from s3grl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dg.device != dev:
        raise ValueError(
            f"DeviceGraph lies on {dg.device}, precompute_pos_fullrow asked for {dev}"
        )
    if dg.x is None:
        raise ValueError("SIGN flows require node features")
    L = links.shape[0]
    links = np.asarray(links, dtype=np.int32)
    buckets = [
        b
        for b in sorted(set(list(buckets) + [max_subgraph_nodes]))
        if b <= max_subgraph_nodes
    ]
    sizes = measure_subgraph_sizes(
        dg, links, num_hops=num_hops, ratio_per_hop=ratio_per_hop,
        max_nodes_per_hop=max_nodes_per_hop, batch_size=max(batch_size, 512),
    )
    order = np.argsort(sizes, kind="stable")
    bucket_of = np.array([pick_bucket(int(s), buckets) for s in sizes[order]])
    s_max = int(bucket_of.max()) if len(bucket_of) else int(buckets[0])

    Fz = int(dg.x.shape[1]) + (2 if node_label in ("de", "de+") else 1)
    xs_all = torch.zeros((L, sign_k + 1, s_max, Fz), dtype=torch.float32, device=dev)
    mask_all = torch.zeros((L, s_max), dtype=torch.bool, device=dev)

    for bucket in np.unique(bucket_of):
        bucket = int(bucket)
        idx_all = order[bucket_of == bucket]
        per_link = bucket * max(bucket, Fz * (sign_k + 1))
        bsz_cap = max(4, min(batch_size, ELEM_BUDGET // max(per_link, 1)))
        bsz_cap = 1 << (bsz_cap.bit_length() - 1)
        for start in range(0, len(idx_all), bsz_cap):
            idx = idx_all[start : start + bsz_cap]
            xs, row_mask = _extract_and_operate_fullrow(
                dg, torch.as_tensor(links[idx], device=dev),
                num_hops=num_hops, max_nodes=bucket,
                ratio_per_hop=ratio_per_hop, max_nodes_per_hop=max_nodes_per_hop,
                sign_k=sign_k, node_label=node_label, max_label_dist=max_label_dist,
            )
            idx_t = torch.as_tensor(idx, device=dev)
            xs_all[idx_t, :, :bucket] = xs
            mask_all[idx_t, :bucket] = row_mask

    return OperatorDataset(xs=xs_all, row_mask=mask_all, y=np.asarray(y, dtype=np.float32))


def _sop_fullrow_batch(
    edges: EdgeList,
    x_global: torch.Tensor,  # [N, F]
    links: torch.Tensor,  # [B, 2] int64
    *,
    sign_k: int,
    num_nodes: int,
    node_label: str,
) -> torch.Tensor:
    """Non-optimized SoP features for one batch: [B, K+1, 2, Z+F].

    The diagonal entries Â^k[u, u] come from the endpoint one-hot rows
    carried through the edge-list SpMM (as in the optimized SoP), never
    from a global Â^k.
    """
    B = links.shape[0]
    dev = x_global.device
    ends = links.reshape(-1)  # [2B]: src, dst per link
    R = torch.nn.functional.one_hot(ends, num_nodes).float()  # [2B, N]
    rows2b = torch.arange(2 * B, device=dev)

    # z on the 2-node edgeless graph (off-diagonal removed): distance 0 to
    # itself, the counterpart unreachable.
    if node_label in ("zo", "drnl"):  # drnl fixes z = 1 on both targets
        z = torch.ones((B, 2, 1), device=dev)
    elif node_label in ("hop", "degree"):  # degree is filled per power below
        z = torch.zeros((B, 2, 1), device=dev)
    elif node_label == "de":  # unreachable -> max_dist 3 (utils.py:250-251)
        z = torch.tensor([[0.0, 3.0], [3.0, 0.0]], device=dev).expand(B, 2, 2)
    elif node_label == "de+":  # unreachable -> 100 (utils.py:274-277)
        z = torch.tensor([[0.0, 100.0], [100.0, 0.0]], device=dev).expand(B, 2, 2)
    else:
        raise NotImplementedError(f"node_label {node_label}")

    x_ends = x_global[links]  # [B, 2, F]

    def zx(diag_k):
        """[z | x], with the per-power degree label when asked: the column
        sum of the 2x2 diagonal subgraph is its diagonal, capped at 100
        (utils.py:303-305)."""
        zc = torch.clamp(diag_k, max=100.0)[:, :, None] if node_label == "degree" else z
        return torch.cat([zc, x_ends], dim=-1)

    # x (op 0) takes its labels from the power-1 subgraph (SoP_data_creation
    # keeps sop_data_list[0] as the base datapoint, tuned_SIGN.py:26).
    Rk = spmm(edges, R.T).T
    diag = Rk[rows2b, ends].reshape(B, 2)
    ops = [zx(diag)]
    for k in range(sign_k):
        if k > 0:
            Rk = spmm(edges, Rk.T).T
            diag = Rk[rows2b, ends].reshape(B, 2)  # Â^k[u, u]
        ops.append(diag[:, :, None] * zx(diag))
    return torch.stack(ops, dim=1)


def precompute_sop_fullrow(
    dg: DeviceGraph,
    links: np.ndarray,
    y: np.ndarray,
    *,
    sign_k: int,
    num_hops: int = -1,
    node_label: str = "zo",
    batch_size: int = 0,
    device="cuda",
) -> OperatorDataset:
    """The non-optimized SoP flow (utils.py:532-550). ``dg`` must lie on
    ``device``. The last batch runs ragged (the JAX package pads it)."""
    from s3grl_tpu_torch.utils.device import resolve_device

    if num_hops != -1:
        raise NotImplementedError(
            "non-optimized SoP requires num_hops=-1: with num_hops >= 1 the "
            "per-power subgraphs have different node counts and the SIGNNet "
            "feature concat (models.py:374) cannot consume them"
        )
    dev = resolve_device(device)
    if dg.device != dev:
        raise ValueError(
            f"DeviceGraph lies on {dg.device}, precompute_sop_fullrow asked for {dev}"
        )
    if dg.x is None:
        raise ValueError("SIGN flows require node features")
    N = dg.num_nodes
    L = links.shape[0]
    links = np.asarray(links, dtype=np.int64)
    edges = edge_list(dg.edge_src, dg.edge_dst,
                      normalized_adjacency_weights(dg.edge_src, dg.edge_dst, N), N)
    if batch_size <= 0:
        batch_size = max(16, min(4096, 24_000_000 // max(N, 1)))

    chunks = []
    for start in range(0, L, batch_size):
        lb = torch.as_tensor(links[start : start + batch_size], device=dev)
        chunks.append(_sop_fullrow_batch(
            edges, dg.x, lb,
            sign_k=sign_k, num_nodes=N, node_label=node_label,
        ))
    return OperatorDataset(
        xs=torch.cat(chunks, dim=0),
        row_mask=torch.ones((L, 2), dtype=torch.bool, device=dev),
        y=np.asarray(y, dtype=np.float32),
    )
