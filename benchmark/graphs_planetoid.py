"""A citation graph of Planetoid Cora's size and its bag-of-words features,
made from seeds.

Frozen copies, as ``benchmark/graphs.py`` is: nothing here may change with
the program. Everything is numpy on the host and imports nothing of the
program.

- :func:`holme_kim_edges`: preferential attachment with triad formation
  (Holme and Kim, Phys. Rev. E 65, 026107), each new node adding 1 or 2
  edges, so that the graph has exactly the asked number of undirected
  edges. Cora has 2,708 nodes, 5,278 undirected edges, maximum degree 168
  and average clustering 0.24.
- :func:`bag_of_words`: rows of Poisson(mean) distinct words (at least 1),
  drawn with Zipf-like column frequencies, each row normalised to sum 1,
  as Planetoid's binary word vectors read after PyG's
  ``NormalizeFeatures``. Cora's rows hold 18.17 of 1,433 words on average.
"""
from __future__ import annotations

import numpy as np


def holme_kim_edges(seed: int, n: int, n_undirected: int, alpha: float,
                    p_triad: float) -> np.ndarray:
    """A symmetrized [2, 2 * n_undirected] int32 edge index: a triangle on
    nodes 0-2, then each node v in turn attaches to 1 or 2 earlier nodes
    (the nodes that add 1, drawn from the seed, make the total exact). Its
    first target is drawn with weight degree**alpha; each further one is,
    with chance ``p_triad``, a neighbor of the node just attached (a
    triad), else drawn as the first."""
    m0 = 3
    extra = n_undirected - m0 - (n - m0)  # nodes that add a second edge
    if not 0 <= extra <= n - m0:
        raise ValueError(f"{n_undirected} edges cannot be made from {n} nodes by 1 or 2 each")
    rng = np.random.default_rng(seed)
    adds = np.ones(n, np.int64)
    adds[m0 + rng.choice(n - m0, extra, replace=False)] = 2
    adj = [set() for _ in range(n)]
    deg = np.zeros(n)
    for i in range(m0):
        for j in range(i):
            adj[i].add(j)
            adj[j].add(i)
    deg[:m0] = m0 - 1
    for v in range(m0, n):
        last = None
        k = 0
        while k < adds[v]:
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


def bag_of_words(seed: int, n: int, columns: int, mean_words: float,
                 zipf_exponent: float) -> np.ndarray:
    """[n, columns] float32: row i holds max(1, Poisson(mean_words))
    distinct columns, drawn without replacement with weight (rank + 1) **
    -zipf_exponent (Gumbel top-k), each at 1 / (its row's count)."""
    rng = np.random.default_rng(seed)
    counts = np.clip(rng.poisson(mean_words, n), 1, columns)
    logp = -zipf_exponent * np.log(np.arange(columns) + 1.0)
    keys = logp[None, :] + rng.gumbel(size=(n, columns))
    order = np.argsort(-keys, axis=1)
    x = np.zeros((n, columns), np.float32)
    take = np.arange(columns)[None, :] < counts[:, None]
    rows = np.nonzero(take)[0]
    x[rows, order[take]] = (1.0 / counts[rows]).astype(np.float32)
    return x


GENERATORS = {"holme_kim": holme_kim_edges}
FEATURES = {"bag_of_words": bag_of_words}
