"""What the data needs: bytes and floating-point operations counted from the
graph and the links, and the card's published peaks.

Frozen here so that the yardstick does not move with the program: it
counts no padded width, no weight array and no route. For a link (s, d)
with its members (at most ``max_nodes``, as the configuration states) the
PoS operators need each member's entries in the subgraph's adjacency, each
member's feature row, and the output rows; their operations are, for each
power k = 1..K, the propagation of the two target rows over the entries and
their product with [1 | X].
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import UNREACHED, RefGraph

# NVIDIA's data sheet, H100 SXM, dense, at the full 700 W: HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores (the configurations turn TF32 off).
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flop_per_s": 67e12}}
ROWS = 2  # the two target rows a PoS link keeps (no CCN rows in these configurations)


def link_work(g: RefGraph, links: np.ndarray, *, num_hops: int, max_nodes: int,
              batch: int = 64) -> dict:
    """Per link, as numpy int64 arrays: ``members`` (the subgraph's nodes,
    capped), ``entries`` (directed adjacency entries among the members, the
    link itself removed) and ``member_degree`` (the members' degrees in the
    whole graph: the entries a member's full neighbor list holds)."""
    links = np.asarray(links, dtype=np.int64)
    deg = torch.bincount(g.src, minlength=g.n).to(torch.float64)
    edge_keys = torch.sort(g.src * g.n + g.dst).values
    node_ids = torch.arange(g.n, device=g.device)
    out = {"members": [], "entries": [], "member_degree": []}
    for start in range(0, len(links), batch):
        lb = torch.as_tensor(links[start:start + batch], device=g.device)
        B = lb.shape[0]
        rows = torch.arange(B, device=g.device)
        dist = torch.full((B, g.n), UNREACHED, dtype=torch.long, device=g.device)
        dist[rows, lb[:, 0]] = 0
        dist[rows, lb[:, 1]] = 0
        for hop in range(1, num_hops + 1):
            front = dist == hop - 1
            hit = torch.zeros((B, g.n), dtype=torch.int32, device=g.device)
            hit.index_add_(1, g.dst, front[:, g.src].to(torch.int32))
            dist = torch.where((hit > 0) & (dist == UNREACHED), hop, dist)
        key = torch.where(dist < UNREACHED, dist * g.n + node_ids, UNREACHED)
        key[rows, lb[:, 0]] = -2
        key[rows, lb[:, 1]] = -1
        k = min(max_nodes, g.n)
        low = torch.topk(key, k, dim=1, largest=False)
        member = torch.zeros((B, g.n), dtype=torch.bool, device=g.device)
        member.scatter_(1, low.indices, low.values < UNREACHED)
        inside = (member[:, g.src] & member[:, g.dst]).sum(dim=1)
        lk = lb[:, 0] * g.n + lb[:, 1]
        pos = torch.searchsorted(edge_keys, lk).clamp(max=len(edge_keys) - 1)
        linked = (edge_keys[pos] == lk).long()
        out["members"].append(member.sum(dim=1).cpu())
        out["entries"].append((inside - 2 * linked).cpu())
        out["member_degree"].append((member.to(torch.float64) @ deg).round().long().cpu())
    return {k: torch.cat(v).numpy().astype(np.int64) for k, v in out.items()}


def pos_work(w: dict, *, features: int, sign_k: int) -> tuple[float, float]:
    """(bytes, FLOP) the PoS operators of the links of ``w`` need: 4-byte
    adjacency entries and feature values read once, the (K+1) x 2 output
    rows of F+1 values written once; per power, 2 FLOP per entry and target
    row, and 2 per member, column and target row."""
    m, e = w["members"].astype(np.float64), w["entries"].astype(np.float64)
    n_bytes = 4.0 * e.sum() + 4.0 * features * m.sum() + \
        4.0 * (sign_k + 1) * ROWS * (features + 1) * len(m)
    flops = sign_k * (2.0 * ROWS * e.sum() + 2.0 * ROWS * (features + 1) * m.sum())
    return float(n_bytes), float(flops)


def local_table_work(w: dict) -> tuple[float, float]:
    """(bytes, 0) that building the links' subgraph-local adjacency needs:
    each member's id and its whole neighbor list read, the entries among the
    members written."""
    n_bytes = 4.0 * w["members"].sum() + 4.0 * w["member_degree"].sum() + 4.0 * w["entries"].sum()
    return float(n_bytes), 0.0


def signnet_flops(*, rows: int, d_in: int, hidden: int, train: bool) -> float:
    """Matrix-product FLOP of SIGNNet over ``rows`` links of two rows each:
    forward, and with ``train`` the weight gradients of all three layers and
    the input gradients of the last two."""
    fwd = 2.0 * rows * ROWS * d_in * hidden + 2.0 * rows * hidden * hidden + 2.0 * rows * hidden
    if not train:
        return fwd
    return 2.0 * fwd + 2.0 * rows * hidden * hidden + 2.0 * rows * hidden


def bound_s(n_bytes: float, flops: float, peaks: dict) -> float:
    """The least seconds the card can take: bytes over the memory rate or
    operations over the float32 rate, whichever is longer."""
    return max(n_bytes / peaks["hbm_bytes_per_s"], flops / peaks["fp32_flop_per_s"])
