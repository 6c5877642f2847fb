"""What PoS Plus on ScaLed's walk subgraphs needs: the walk members that
the plain reference (``benchmark/reference_scaled.py``) works out, counted
as ``benchmark/workmodel.link_work`` counts a BFS's, and each link's CCN
rows inside its walk subgraph, for ``workmodel_pos_plus.pos_plus_work``.

Frozen here so that the yardstick does not move with the program: it
counts each link's live members, never the subgraph slots the program's
batches share.
"""
from __future__ import annotations

import numpy as np

from benchmark import reference_scaled
from benchmark.reference import RefGraph


def walk_work(g: RefGraph, links: np.ndarray, seeds: np.ndarray, *, rw_m: int, rw_M: int,
              strategy: str, max_ccn: int, batch: int = 512) -> tuple[dict, np.ndarray]:
    """(per link ``members``, ``entries`` (directed adjacency entries among
    the members, the link itself removed) and ``member_degree`` (the
    members' degrees in the whole graph), as int64 arrays; the CCN rows
    each link keeps, min(|CCN|, ``max_ccn``)) of the links whose walks are
    seeded ``seeds``."""
    if strategy not in ("intersection", "union"):
        raise ValueError(f"strategy must be intersection or union, got {strategy!r}")
    links = np.asarray(links, dtype=np.int64).reshape(-1, 2)
    src, dst = g.src.cpu().numpy(), g.dst.cpu().numpy()
    deg = np.bincount(src, minlength=g.n).astype(np.int64)
    adj = np.zeros((g.n, g.n), dtype=bool)
    adj[src, dst] = True
    out = {"members": [], "entries": [], "member_degree": []}
    ccn = []
    for start in range(0, len(links), batch):
        lb = links[start:start + batch]
        visited = reference_scaled.walks(g, lb, seeds[start:start + batch], rw_m=rw_m,
                                         rw_M=rw_M).reshape(len(lb), -1)
        rows = np.arange(len(lb))
        member = np.zeros((len(lb), g.n), dtype=bool)
        member[rows[:, None], visited] = True
        s, d = lb[:, 0], lb[:, 1]
        linked = adj[s, d] & (s != d)
        out["members"].append(member.sum(axis=1))
        out["entries"].append((member[:, src] & member[:, dst]).sum(axis=1) - 2 * linked)
        out["member_degree"].append(member.astype(np.int64) @ deg)
        both = adj[s] & adj[d] if strategy == "intersection" else adj[s] | adj[d]
        both &= member
        both[rows, s] = False
        both[rows, d] = False
        ccn.append(np.minimum(both.sum(axis=1), max(max_ccn, 0)))
    w = {k: np.concatenate(v).astype(np.int64) for k, v in out.items()}
    return w, np.concatenate(ccn).astype(np.int64)
