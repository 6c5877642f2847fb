"""The plain reference of S3GRL's PoS Plus on ScaLed's random-walk
subgraphs, in plain PyTorch and numpy.

It imports nothing of the program and takes nothing the program made: its
caller hands it the graph, features, links, the call's seed and each link's
place in its call, and it works out the walks and everything after them
again.

ScaLed (utils.py:86-150, ``k_hop_subgraph``'s walk branch): for a link
(s, d), M uniform walks of length m from s and M from d; the members are
every node the walks visit, ordered s, d, then the rest by node id. The
walks run on the graph as handed, the link itself present. The walks'
law, written out from the stated rule:

- link i of a call with seed ``seed`` has the link seed
  int32(seed · 1,000,003 + i);
- its uniform for step t (1..m) and walk w (1..2M) is the top 24 bits of
  MurmurHash3's fmix32 chain over (link seed, t, w) over 2^24
  (:func:`uniforms`);
- walk w starts at s where w is odd and at d where w is even;
- a step goes to neighbour min(floor(fl32(u · deg)), deg - 1) of the
  current node, its neighbours counted in ascending id order, fl32 a
  float32 product; a node with no neighbour stays where it is.

From the members on, PoS Plus (tuned_SIGN.py:192-262): the binary
adjacency A among the members without the link itself; the CCN set, the
members other than s and d that neighbour both s and d in A
(``intersection``) or either (``union``), in member order, the first
``max_ccn`` (none where ``max_ccn`` is 0: PoS without CCN rows);
Â = D^-1/2 A D^-1/2; the rows [s, d] + CCN of Â^k [1 | X] for k = 0..K,
the column of ones marking s and d only.

Departures from the published code: the walks' generator is a counter
hash of (link seed, step, walk), not torch_cluster's random_walk, so the
walks are others, by the same law; the members are never capped, since at
most 2·M·(m+1) nodes can be visited; the CCN rows stop at ``max_ccn``,
the configuration's ``max_ccn_nodes`` (the published code keeps them all).

``precision``: ``"float64"`` is the reference; ``"tf32"`` is the control,
the same arithmetic in float32 with every product's operands rounded to
TF32, as a float32 matmul with TF32 allowed computes it.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import Arith, RefGraph

MASK32 = np.uint64(0xFFFFFFFF)
STEP_MUL = np.uint64(0x9E3779B9)  # the step counter's multiplier
WALK_MUL = np.uint64(0x7FEB352D)  # the walk counter's multiplier


def link_seeds(seed: int, index) -> np.ndarray:
    """int32(seed · 1,000,003 + i) of each place ``index`` in a call."""
    return (np.int64(seed) * 1_000_003 + np.asarray(index, dtype=np.int64)).astype(np.int32)


def fmix32(h: np.ndarray) -> np.ndarray:
    """MurmurHash3's 32-bit finalizer on uint64 values below 2^32."""
    h = h ^ (h >> np.uint64(16))
    h = (h * np.uint64(0x85EBCA6B)) & MASK32
    h = h ^ (h >> np.uint64(13))
    h = (h * np.uint64(0xC2B2AE35)) & MASK32
    return h ^ (h >> np.uint64(16))


def uniforms(seeds: np.ndarray, steps: int, walks: int) -> np.ndarray:
    """[L, steps, walks] float32: for link seed ``seeds[l]``, step t and walk
    w (both from 1), the top 24 bits of
    fmix32(fmix32(fmix32(seed) ^ t·STEP_MUL) ^ w·WALK_MUL) over 2^24, each
    product taken mod 2^32."""
    h = fmix32(np.asarray(seeds, dtype=np.int64).astype(np.uint64) & MASK32)[:, None, None]
    t = np.arange(1, steps + 1, dtype=np.uint64)[None, :, None]
    w = np.arange(1, walks + 1, dtype=np.uint64)[None, None, :]
    h = fmix32(h ^ ((t * STEP_MUL) & MASK32))
    h = fmix32(h ^ ((w * WALK_MUL) & MASK32))
    return ((h >> np.uint64(8)).astype(np.float64) / float(1 << 24)).astype(np.float32)


def sorted_neighbours(g: RefGraph) -> tuple[np.ndarray, np.ndarray]:
    """(row pointers [N+1], neighbours) of ``g``, each row in ascending id."""
    src, dst = g.src.cpu().numpy(), g.dst.cpu().numpy()
    order = np.lexsort((dst, src))
    ptr = np.searchsorted(src[order], np.arange(g.n + 1))
    return ptr.astype(np.int64), dst[order].astype(np.int64)


def walks(g: RefGraph, links: np.ndarray, seeds: np.ndarray, *, rw_m: int,
          rw_M: int) -> np.ndarray:
    """[L, 2M, m + 1] int64: every link's walks, column 0 the start."""
    links = np.asarray(links, dtype=np.int64).reshape(-1, 2)
    ptr, nbrs = sorted_neighbours(g)
    deg = ptr[1:] - ptr[:-1]
    u = uniforms(seeds, rw_m, 2 * rw_M)  # [L, m, 2M]
    cur = np.where(np.arange(2 * rw_M)[None, :] % 2 == 0, links[:, :1], links[:, 1:])
    path = [cur]
    for t in range(rw_m):
        d = deg[cur]
        step = np.minimum((u[:, t] * np.maximum(d, 1).astype(np.float32)).astype(np.int64),
                          np.maximum(d, 1) - 1)
        nxt = nbrs[np.minimum(ptr[cur] + step, len(nbrs) - 1)] if len(nbrs) else cur
        cur = np.where(d > 0, nxt, cur)
        path.append(cur)
    return np.stack(path, axis=2)


def members(g: RefGraph, links: np.ndarray, seeds: np.ndarray, *, rw_m: int,
            rw_M: int) -> list:
    """Each link's members, [S] int64: s, d, then the other visited nodes
    by id."""
    out = []
    for (s, d), visited in zip(np.asarray(links, dtype=np.int64).reshape(-1, 2),
                               walks(g, links, seeds, rw_m=rw_m, rw_M=rw_M)):
        rest = np.unique(visited)
        out.append(np.concatenate([[s, d], rest[(rest != s) & (rest != d)]]))
    return out


def link_rows(g: RefGraph, nodes: np.ndarray, *, sign_k: int, strategy: str, max_ccn: int,
              arith: Arith) -> torch.Tensor:
    """[K+1, 2 + |CCN|, F+1]: the PoS Plus rows of the link whose members
    are ``nodes`` (s and d first)."""
    nodes = torch.as_tensor(nodes, dtype=torch.long, device=g.device)
    S = int(nodes.numel())
    pos = torch.full((g.n,), -1, dtype=torch.long, device=g.device)
    pos[nodes] = torch.arange(S, device=g.device)
    ps, pd = pos[g.src], pos[g.dst]
    inside = (ps >= 0) & (pd >= 0)
    A = torch.zeros((S, S), dtype=arith.dtype, device=g.device)
    A[ps[inside], pd[inside]] = 1.0
    A[0, 1] = 0.0
    A[1, 0] = 0.0
    rows = torch.arange(2, device=g.device)
    if max_ccn > 0:
        if strategy == "intersection":
            ccn = (A[0] > 0) & (A[1] > 0)
        elif strategy == "union":
            ccn = (A[0] > 0) | (A[1] > 0)
        else:
            raise ValueError(f"strategy must be intersection or union, got {strategy!r}")
        ccn[:2] = False
        rows = torch.cat([rows, torch.nonzero(ccn).squeeze(1)[:max_ccn]])
    deg = A.sum(dim=1)
    dinv = torch.where(deg > 0, deg.clamp(min=1e-30).rsqrt(), torch.zeros_like(deg))
    A_hat = dinv[:, None] * A * dinv[None, :]
    ind = torch.zeros((S, 1), dtype=arith.dtype, device=g.device)
    ind[:2] = 1.0
    subg_x = torch.cat([ind, g.x[nodes].to(arith.dtype)], dim=1)
    h = torch.zeros((len(rows), S), dtype=arith.dtype, device=g.device)
    h[torch.arange(len(rows), device=g.device), rows] = 1.0
    out = [subg_x[rows]]
    for _ in range(sign_k):
        h = arith.mm(h, A_hat)  # rows of Â^k; Â is symmetric
        out.append(arith.mm(h, subg_x))
    return torch.stack(out)


def scaled_rows(g: RefGraph, links: np.ndarray, index: np.ndarray, *, seed: int, rw_m: int,
                rw_M: int, sign_k: int, strategy: str, max_ccn: int, width: int,
                precision: str = "float64") -> tuple[torch.Tensor, torch.Tensor]:
    """(rows [L, K+1, R, F+1], row mask [L, R]) on ``g.device`` of the
    links ``links``, each at place ``index`` of a call seeded ``seed``:
    :func:`link_rows` of its walk members, zero-padded to R = the larger of
    ``width`` and the most rows a link keeps, True on the rows kept."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arith = Arith(precision)
    nodes = members(g, links, link_seeds(seed, index), rw_m=rw_m, rw_M=rw_M)
    per = [link_rows(g, m, sign_k=sign_k, strategy=strategy, max_ccn=max_ccn, arith=arith)
           for m in nodes]
    R = max([width] + [p.shape[1] for p in per])
    F1 = int(g.x.shape[1]) + 1
    xs = torch.zeros((len(per), sign_k + 1, R, F1), dtype=arith.dtype, device=g.device)
    mask = torch.zeros((len(per), R), dtype=torch.bool, device=g.device)
    for i, p in enumerate(per):
        xs[i, :, :p.shape[1]] = p
        mask[i, :p.shape[1]] = True
    return xs, mask
