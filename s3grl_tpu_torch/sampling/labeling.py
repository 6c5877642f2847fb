"""Batched structural node labeling in torch.

Port of ``s3grl_tpu/sampling/labeling.py``: every label of a padded
subgraph batch comes at once from masked frontier BFS, a batched
vector-matrix product per step, instead of the reference's per-link
``scipy.sparse.csgraph.shortest_path`` calls (utils.py:177-316).

Labels (dispatch of ``construct_pyg_graph``, utils.py:281-316):
- ``zo``     1 on src/dst, 0 elsewhere (utils.py:297-298)
- ``hop``    min hop distance to {src, dst} (utils.py:295-296)
- ``drnl``   z = 1 + min(ds, dd) + (d//2)*(d//2 + d%2 - 1), each BFS with
             the other target removed; unreachable -> 0 (utils.py:211-238)
- ``de``     distances to [src, dst] on the intact subgraph, capped at 3;
             unreachable -> 3 too (utils.py:241-252: scipy's inf meets the
             ``dist > max_dist`` cap first, so the isnan -> 4 branch is
             dead; the JAX package keeps what executes, and so does this)
- ``de+``    drnl's masked distances, capped at 100; unreachable -> 100
             for the same dead-isnan reason (utils.py:255-278)
- ``degree`` column-sum degree capped at 100 (utils.py:303-305)

The BFS runs at most ``max_iters`` steps, as the JAX package's
``fori_loop`` does, and stops early once no node is newly reached;
distances beyond the cap count as unreachable. Every quantity is a small
integer in float32, so the labels are exact on every device.
"""
from __future__ import annotations

from typing import Optional

import torch

_INF = 1e9


def masked_bfs_dist(
    adj: torch.Tensor,  # [B, S, S] dense sub-adjacency (any positive weights)
    start: torch.Tensor,  # [B] local start index per subgraph
    node_mask: torch.Tensor,  # [B, S] bool
    forbidden: Optional[torch.Tensor],  # [B] local node to delete, or None
    max_iters: int,
) -> torch.Tensor:
    """Unweighted BFS distance [B, S] (f32, ``_INF`` where unreached) from
    ``start`` with ``forbidden`` removed from the graph (the reference's
    adj_wo_src/adj_wo_dst trick, utils.py:215-227, as a mask)."""
    B, S, _ = adj.shape
    b = torch.arange(B, device=adj.device)
    m = node_mask.to(torch.float32)
    A = (adj > 0).to(torch.float32) * m[:, :, None] * m[:, None, :]
    if forbidden is not None:
        A[b, forbidden.long(), :] = 0.0
        A[b, :, forbidden.long()] = 0.0

    start = start.long()
    dist = torch.full((B, S), _INF, dtype=torch.float32, device=adj.device)
    dist[b, start] = 0.0
    frontier = torch.zeros((B, 1, S), dtype=torch.float32, device=adj.device)
    frontier[b, 0, start] = 1.0
    for t in range(1, max_iters + 1):
        reached = torch.bmm(frontier, A)[:, 0] > 0
        newly = reached & (dist >= _INF)
        if not bool(newly.any()):
            # An empty frontier stays empty: the JAX package's remaining
            # steps change nothing. Each step reads all of A, so stopping
            # here (one host read a step) saves most of the BFS.
            break
        dist = torch.where(newly, torch.full_like(dist, float(t)), dist)
        frontier = newly.to(torch.float32)[:, None, :]
    return dist


def _drnl_from_dists(ds: torch.Tensor, dd: torch.Tensor) -> torch.Tensor:
    """DRNL formula (utils.py:229-236). Unreachable (INF) -> 0."""
    d = ds + dd
    d2 = torch.floor(d / 2.0)
    dm2 = d - 2.0 * d2
    z = 1.0 + torch.minimum(ds, dd) + d2 * (d2 + dm2 - 1.0)
    return torch.where((ds >= _INF) | (dd >= _INF), torch.zeros_like(z), z)


def label_nodes(
    adj: torch.Tensor,  # [B, S, S]
    dist: torch.Tensor,  # [B, S] hop distance from extraction
    node_mask: torch.Tensor,  # [B, S] bool
    node_label: str = "drnl",
    max_iters: int = 32,
) -> torch.Tensor:
    """Labels as f32: [B, S], or [B, S, 2] for de/de+."""
    B, S, _ = adj.shape
    m = node_mask.to(torch.float32)
    b = torch.arange(B, device=adj.device)
    src = torch.zeros(B, dtype=torch.long, device=adj.device)  # local slot 0
    dst = src + 1  # local slot 1

    if node_label == "zo":
        return (dist == 0).to(torch.float32) * m
    if node_label == "hop":
        return dist.to(torch.float32) * m
    if node_label == "degree":
        deg = adj.sum(dim=1)  # column sum (utils.py:304 adj.sum(axis=0))
        return torch.clamp(deg, max=100.0) * m

    if node_label in ("drnl", "de+"):
        ds = masked_bfs_dist(adj, src, node_mask, forbidden=dst, max_iters=max_iters)
        dd = masked_bfs_dist(adj, dst, node_mask, forbidden=src, max_iters=max_iters)
        # Targets are at distance 0 from themselves and, per the
        # reference's np.insert, 0 at the deleted counterpart's position.
        ds[b, dst] = 0.0
        dd[b, src] = 0.0
        if node_label == "drnl":
            z = _drnl_from_dists(ds, dd)
            z[b, src] = 1.0
            z[b, dst] = 1.0
            return z * m
        # de+: unreachable -> 100 (the dead isnan branch, utils.py:274-277).
        ds = torch.clamp(ds, max=100.0)
        dd = torch.clamp(dd, max=100.0)
        return torch.stack([ds, dd], dim=-1) * m[:, :, None]

    if node_label == "de":
        ds = masked_bfs_dist(adj, src, node_mask, forbidden=None, max_iters=max_iters)
        dd = masked_bfs_dist(adj, dst, node_mask, forbidden=None, max_iters=max_iters)
        max_dist = 3.0  # unreachable -> max_dist (dead isnan, utils.py:250-251)
        ds = torch.clamp(ds, max=max_dist)
        dd = torch.clamp(dd, max=max_dist)
        return torch.stack([ds, dd], dim=-1) * m[:, :, None]

    raise NotImplementedError(f"node_label {node_label}")
