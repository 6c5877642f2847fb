"""What PoS Plus's operators need: ``benchmark/workmodel.pos_work``'s count
with each link's own rows, 2 + |CCN|, in place of the two target rows.

Frozen here so that the yardstick does not move with the program: it counts
the rows a link keeps (tuned_SIGN.py:238), never the padded width R the
program's batches share. A link's CCN nodes lie in its first hop, which the
members hold by node id right after s and d: the first ``max_nodes`` - 2
of (N(s) ∪ N(d)) without s and d. Of those, the CCN set is the nodes in
both neighbour sets (``intersection``) or all of them (``union``).
"""
from __future__ import annotations

import numpy as np

from benchmark.reference import RefGraph


def ccn_sizes(g: RefGraph, links: np.ndarray, *, strategy: str, max_nodes: int) -> np.ndarray:
    """[L] int64: |CCN| of each link, counted on the host."""
    if strategy not in ("intersection", "union"):
        raise ValueError(f"strategy must be intersection or union, got {strategy!r}")
    src, dst = g.src.cpu().numpy(), g.dst.cpu().numpy()
    order = np.argsort(src, kind="stable")
    ptr = np.searchsorted(src[order], np.arange(g.n + 1))
    nbrs = dst[order]
    out = []
    for s, d in np.asarray(links, dtype=np.int64).reshape(-1, 2):
        ns = set(nbrs[ptr[s]:ptr[s + 1]].tolist()) - {s, d}
        nd = set(nbrs[ptr[d]:ptr[d + 1]].tolist()) - {s, d}
        kept = set(sorted(ns | nd)[:max(max_nodes - 2, 0)])
        out.append(len(kept & ns & nd) if strategy == "intersection" else len(kept))
    return np.asarray(out, dtype=np.int64)


def pos_plus_work(w: dict, ccn: np.ndarray, *, features: int,
                  sign_k: int) -> tuple[float, float]:
    """(bytes, FLOP) the PoS Plus operators of the links of ``w``
    (``workmodel.link_work``'s members and entries) with ``ccn`` CCN rows
    each need: 4-byte adjacency entries and feature values read once, the
    (K+1) x (2 + |CCN|) output rows of F+1 values written once; per power, 2
    FLOP per entry and kept row, and 2 per member, column and kept row."""
    m, e = w["members"].astype(np.float64), w["entries"].astype(np.float64)
    rows = 2.0 + np.asarray(ccn, dtype=np.float64)
    n_bytes = 4.0 * e.sum() + 4.0 * features * m.sum() + \
        4.0 * (sign_k + 1) * (features + 1) * rows.sum()
    flops = sign_k * (2.0 * (rows * e).sum() + 2.0 * (features + 1) * (rows * m).sum())
    return float(n_bytes), float(flops)
