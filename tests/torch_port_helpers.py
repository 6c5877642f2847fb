"""Shared inputs for the torch-port parity tests (``test_torch_*.py``).

Graphs are made with numpy from a seed and handed to both packages as
arrays, so the JAX package and the port see identical inputs.
"""
import numpy as np
import torch

from s3grl_tpu_torch.data.graph import to_undirected


def one_torch_thread():
    """One intra-op thread while a test module of small torch ops runs, so
    that parallel test workers do not oversubscribe the cores; the count is
    restored after it. A module makes it its own with
    ``pytest.fixture(autouse=True, scope="module")(one_torch_thread)``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_edges(rng, n=150, e=500):
    """The random graph of tests/test_pos_pallas.py::_graph, as a
    symmetrized [2, E] int32 edge index (no self loops)."""
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    keep = src != dst
    return to_undirected(np.stack([src[keep], dst[keep]]))


def usair_like_edges(seed: int, n: int = 332, p_triad: float = 0.9,
                     alpha: float = 1.5):
    """A graph of USAir's shape: preferential attachment with triad
    formation (Holme–Kim), the attachment superlinear in the degree
    (weight degree**alpha) for USAir's hubs. Each new node adds 6 or 7
    edges (about 2,100 undirected edges at n = 332); the first goes by
    degree, each further one closes a triangle with probability
    ``p_triad``. At seed 1: 2,131 edges, max degree 108, clustering 0.139
    (a uniform random graph of that density has 0.039).

    Returns a symmetrized [2, 2E] int32 edge index. ``chip_smoke.py`` and
    ``scripts/jax_synthetic_auc.py`` take their graph from here.
    """
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


def cora_like_edges(seed: int, n: int = 2708, n_undirected: int = 5278):
    """A uniform random graph of Planetoid Cora's size: ``n_undirected``
    distinct node pairs without self loops, drawn from a numpy seed.
    Returns a symmetrized [2, 10,556] int32 edge index."""
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < n_undirected:
        u, v = (int(a) for a in rng.integers(0, n, 2))
        if u != v:
            pairs.add((min(u, v), max(u, v)))
    und = np.array(sorted(pairs), dtype=np.int32).T
    return to_undirected(und)


def blogcatalog_like_edges(seed: int, n: int = 10_312, n_undirected: int = 333_983,
                           exponent: float = 0.55):
    """A power-law graph of BlogCatalog's size (10,312 nodes, 333,983
    undirected edges): endpoints drawn with probability proportional to
    ``(rank + 1) ** -exponent`` (Chung-Lu), duplicate pairs and self loops
    dropped, the first ``n_undirected`` distinct pairs kept. At seed 1 its
    hub has degree 3,377, its mean degree is 64.8 and no node is isolated.
    Returns a symmetrized [2, 667,966] int32 edge index."""
    rng = np.random.default_rng(seed)
    p = (np.arange(n) + 1.0) ** -exponent
    p /= p.sum()
    k = int(1.3 * n_undirected)
    u, v = rng.choice(n, k, p=p), rng.choice(n, k, p=p)
    keep = u != v
    lo, hi = np.minimum(u[keep], v[keep]), np.maximum(u[keep], v[keep])
    _, first = np.unique(lo.astype(np.int64) * n + hi, return_index=True)
    first = np.sort(first)
    assert len(first) >= n_undirected, "draw more pairs"
    first = first[:n_undirected]
    return to_undirected(np.stack([lo[first], hi[first]]).astype(np.int32))


def kernel_inputs(seed, B, S, D, F, R, mode, symmetric=False):
    """(sel, nbr, w, x, row_ids) as numpy. mode "local": neighbor entries
    are slots, row_ids None; "global": entries are global ids and row_ids
    hold a random set of ids with -1 on some empty slots."""
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, S, (B, R)).astype(np.int32)
    x = rng.normal(size=(B, S, F)).astype(np.float32)
    slots = rng.integers(0, S, (B, S, D)).astype(np.int32)
    w = (rng.random((B, S, D)) < 0.3).astype(np.float32)
    if symmetric:
        # A symmetric table: entry d of row s names slot t iff row t names s.
        w[:] = 0.0
        for b in range(B):
            fill = np.zeros(S, dtype=np.int64)
            for s in range(S):
                for t in rng.choice(S, size=3, replace=False):
                    if t == s or fill[s] >= D or fill[t] >= D:
                        continue
                    slots[b, s, fill[s]], w[b, s, fill[s]] = t, 1.0
                    slots[b, t, fill[t]], w[b, t, fill[t]] = s, 1.0
                    fill[s] += 1
                    fill[t] += 1
    if mode == "local":
        return sel, slots, w, x, None
    ids = np.stack([rng.permutation(10 * S)[:S] for _ in range(B)]).astype(np.int32)
    empty = rng.random((B, S)) < 0.2
    row_ids = np.where(empty, -1, ids).astype(np.int32)
    x[empty] = 0.0
    nbr = np.take_along_axis(ids, slots.reshape(B, -1), axis=1).reshape(B, S, D)
    stray = rng.random((B, S, D)) < 0.1  # ids of no slot in this subgraph
    nbr = np.where(stray, 10 * S + rng.integers(0, 50, (B, S, D)), nbr).astype(np.int32)
    return sel, nbr, w, x, row_ids
