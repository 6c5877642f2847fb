"""The benchmark's graphs, its splits and its features, made from seeds.

Frozen copies: nothing here may change with the program. A configuration
names its generator (``graph.generator``) and that generator's keyword
arguments; :data:`GENERATORS` finds it by that name. Everything is numpy on
the host and imports nothing of the program.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def to_undirected(edge_index: np.ndarray) -> np.ndarray:
    """Both orientations of every pair, each once, in the order of first
    appearance (PyG ``to_undirected`` semantics)."""
    both = np.concatenate([edge_index, edge_index[::-1]], axis=1)
    key = both[0].astype(np.int64) * (int(both.max()) + 1) + both[1]
    _, idx = np.unique(key, return_index=True)
    return both[:, np.sort(idx)].astype(np.int32)


def usair_like_edges(seed: int, n: int = 332, p_triad: float = 0.9, alpha: float = 1.5):
    """A graph of USAir's shape: preferential attachment (weight
    degree**alpha) with triad formation (Holme-Kim), each new node adding 6
    or 7 edges. Returns a symmetrized [2, 2E] int32 edge index."""
    rng = np.random.default_rng(seed)
    m0 = 7
    adj = [set() for _ in range(n)]
    deg = np.zeros(n)
    for i in range(m0):
        for j in range(i):
            adj[i].add(j)
            adj[j].add(i)
    deg[:m0] = m0 - 1
    for v in range(m0, n):
        m = 6 + int(rng.random() < 0.5)
        last = None
        k = 0
        while k < m:
            u = None
            if last is not None and rng.random() < p_triad:
                cand = sorted(adj[last] - adj[v] - {v})
                if cand:
                    u = cand[int(rng.integers(len(cand)))]
            if u is None:
                p = deg[:v] ** alpha
                u = int(rng.choice(v, p=p / p.sum()))
            if u in adj[v]:
                continue
            adj[v].add(u)
            adj[u].add(v)
            deg[u] += 1
            deg[v] += 1
            last = u
            k += 1
    src = np.array([u for u in range(n) for w in sorted(adj[u])], dtype=np.int32)
    dst = np.array([w for u in range(n) for w in sorted(adj[u])], dtype=np.int32)
    return np.stack([src, dst])


def chung_lu_edges(seed: int, n: int, n_undirected: int, exponent: float):
    """A power-law graph: endpoints drawn with probability proportional to
    ``(rank + 1) ** -exponent`` (Chung-Lu), self loops and repeated pairs
    dropped, the first ``n_undirected`` distinct pairs kept. Returns a
    symmetrized [2, 2 * n_undirected] int32 edge index."""
    rng = np.random.default_rng(seed)
    p = (np.arange(n) + 1.0) ** -exponent
    p /= p.sum()
    k = int(1.3 * n_undirected)
    u, v = rng.choice(n, k, p=p), rng.choice(n, k, p=p)
    keep = u != v
    lo, hi = np.minimum(u[keep], v[keep]), np.maximum(u[keep], v[keep])
    _, first = np.unique(lo.astype(np.int64) * n + hi, return_index=True)
    first = np.sort(first)
    if len(first) < n_undirected:
        raise ValueError(f"only {len(first)} distinct pairs drawn, {n_undirected} asked for")
    first = first[:n_undirected]
    return to_undirected(np.stack([lo[first], hi[first]]).astype(np.int32))


GENERATORS = {"usair_like": usair_like_edges, "chung_lu": chung_lu_edges}


def make_graph(spec: dict) -> tuple[int, np.ndarray]:
    """(number of nodes, symmetrized edge index) of a configuration's
    ``graph`` entry: ``{"generator": name, "seed": s, **keywords}``."""
    kw = {k: v for k, v in spec.items() if k not in ("generator", "seed")}
    ei = GENERATORS[spec["generator"]](spec["seed"], **kw)
    n = int(kw.get("n", int(ei.max()) + 1))
    return n, ei


def _keys(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    return a.astype(np.int64) * n + b.astype(np.int64)


def sample_non_edges(rng, n: int, taken: np.ndarray, count: int, *,
                     unordered: bool) -> np.ndarray:
    """``count`` distinct node pairs (i != j) whose key ``i * n + j`` is not
    in the sorted array ``taken``, drawn uniformly by rejection; with
    ``unordered`` the pairs are (min, max) and distinct as sets. Returns
    [count, 2] int64."""
    out = np.empty((0, 2), np.int64)
    seen = np.empty(0, np.int64)
    while len(out) < count:
        draw = max(2 * (count - len(out)), 64)
        a, b = rng.integers(0, n, draw), rng.integers(0, n, draw)
        if unordered:
            a, b = np.minimum(a, b), np.maximum(a, b)
        ok = a != b
        a, b = a[ok], b[ok]
        key = _keys(a, b, n)
        hit = np.searchsorted(taken, key)
        hit = np.minimum(hit, max(len(taken) - 1, 0))
        fresh = taken[hit] != key if len(taken) else np.ones(len(key), bool)
        a, b, key = a[fresh], b[fresh], key[fresh]
        _, first = np.unique(key, return_index=True)
        first = np.sort(first)
        a, b, key = a[first], b[first], key[first]
        new = ~np.isin(key, seen)
        out = np.concatenate([out, np.stack([a[new], b[new]], 1)])
        seen = np.concatenate([seen, key[new]])
    return out[:count]


@dataclass
class Split:
    """A graph split as S3GRL's ``do_edge_split`` makes it: validation and
    test positives are pairs of the whole graph (i < j) held out of the
    observed graph; the train positives are the rest, in both orientations;
    negatives are non-edges (validation and test: of the whole graph, as
    unordered pairs; train: of the observed graph, ordered)."""

    num_nodes: int
    observed: np.ndarray  # [2, E] symmetrized train edges: the graph the program sees
    train_pos: np.ndarray  # [P, 2] both orientations
    train_neg: np.ndarray
    valid_pos: np.ndarray
    valid_neg: np.ndarray
    test_pos: np.ndarray
    test_neg: np.ndarray

    def links(self, part: str) -> tuple[np.ndarray, np.ndarray]:
        """(links [L, 2] int32, labels [L] float32) of ``train``, ``valid``
        or ``test``: positives, then negatives."""
        pos, neg = getattr(self, f"{part}_pos"), getattr(self, f"{part}_neg")
        links = np.concatenate([pos, neg]).astype(np.int32)
        y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))]).astype(np.float32)
        return links, y


def split_edges(n: int, edge_index: np.ndarray, rng, val_ratio: float,
                test_ratio: float) -> Split:
    """:class:`Split` of the symmetrized ``edge_index``, drawn from ``rng``."""
    row, col = edge_index
    up = row < col
    row, col = row[up], col[up]
    n_v, n_t = int(np.floor(val_ratio * len(row))), int(np.floor(test_ratio * len(row)))
    perm = rng.permutation(len(row))
    row, col = row[perm], col[perm]
    valid_pos = np.stack([row[:n_v], col[:n_v]], 1).astype(np.int64)
    test_pos = np.stack([row[n_v:n_v + n_t], col[n_v:n_v + n_t]], 1).astype(np.int64)
    observed = to_undirected(np.stack([row[n_v + n_t:], col[n_v + n_t:]]).astype(np.int32))
    all_keys = np.sort(_keys(edge_index[0], edge_index[1], n))
    vt_neg = sample_non_edges(rng, n, all_keys, n_v + n_t, unordered=True)
    obs_keys = np.sort(_keys(observed[0], observed[1], n))
    train_neg = sample_non_edges(rng, n, obs_keys, observed.shape[1], unordered=False)
    return Split(num_nodes=n, observed=observed, train_pos=observed.T.astype(np.int64),
                 train_neg=train_neg, valid_pos=valid_pos, valid_neg=vt_neg[:n_v],
                 test_pos=test_pos, test_neg=vt_neg[n_v:])


def one_hot_degree(n: int, edge_index: np.ndarray, max_degree: int) -> np.ndarray:
    """[n, max_degree + 1] float32: the one-hot of each node's degree in
    ``edge_index``, capped at ``max_degree`` (PyG ``OneHotDegree``; rows of
    a one-hot sum to 1, so ``NormalizeFeatures`` leaves them as they are)."""
    deg = np.minimum(np.bincount(edge_index[0], minlength=n), max_degree)
    x = np.zeros((n, max_degree + 1), np.float32)
    x[np.arange(n), deg] = 1.0
    return x
