"""node2vec pretraining in torch.

Port of ``s3grl_tpu/models/n2v.py`` (reference: n2v_prep.py:10-48, PyG
Node2Vec with walk_length 20, context_size 10, walks_per_node 10, one
negative walk per walk, p = q = 1, Adam at lr 0.01): uniform random walks
over the padded neighbor table, skip-gram windows scored against negative
walks of uniform nodes, and the learned embedding as the node features.

The walks are split into a deterministic core, :func:`walk_steps`, that
steps them from given uniforms ``u [L, W]``, and the sampler
:func:`random_walks` that draws those uniforms. Both packages share the
rule ``idx = min(floor(u * d), d - 1)``, with an isolated node staying in
place, so the same uniforms give the same walks. The draws themselves come
from a ``torch.Generator`` on the run's device, not from ``jax.random``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.ops.segment import gather_rows
from s3grl_tpu_torch.sampling.extraction import DeviceGraph


def walk_steps(
    nbr: torch.Tensor,  # [N, D] padded neighbor table
    deg: torch.Tensor,  # [N] degrees clamped to D
    starts: torch.Tensor,  # [W] start nodes
    u: torch.Tensor,  # [L, W] float32 uniforms in [0, 1), one row per step
) -> torch.Tensor:
    """Walks [W, L+1] (int64) from ``starts``, step t choosing neighbor
    ``min(floor(u[t] * d), d - 1)`` of the current node of degree d; a node
    without neighbors repeats (torch_cluster.random_walk for p = q = 1)."""
    cur = starts.long()
    path = [cur]
    for t in range(u.shape[0]):
        d_cur = deg[cur]
        d = torch.clamp(d_cur, min=1)
        idx = torch.minimum((u[t] * d).to(torch.int64), d.long() - 1)
        nxt = nbr[cur, idx].long()
        cur = torch.where(d_cur > 0, nxt, cur)
        path.append(cur)
    return torch.stack(path, dim=1)


def random_walks(
    nbr: torch.Tensor,
    deg: torch.Tensor,
    starts: torch.Tensor,
    walk_length: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """Uniform random walks [W, walk_length + 1], their uniforms drawn from
    ``generator`` (on the walks' device)."""
    u = torch.rand(
        (walk_length, starts.shape[0]), generator=generator, device=starts.device
    )
    return walk_steps(nbr, deg, starts, u)


def negative_walks(
    starts: torch.Tensor, num_nodes: int, walk_length: int, num_negative: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """[W * num_negative, walk_length + 1] uniform node ids, column 0 the
    starts (PyG Node2Vec.neg_sample; JAX n2v.py:82-90)."""
    rw = torch.randint(
        0, num_nodes, (starts.shape[0] * num_negative, walk_length + 1),
        generator=generator, device=starts.device,
    )
    rw[:, 0] = starts.long().repeat(num_negative)
    return rw


def skipgram_loss(
    emb: torch.Tensor, pos_rw: torch.Tensor, neg_rw: torch.Tensor, context_size: int
) -> torch.Tensor:
    """Mean -log sigma(start . context) over the positive windows plus mean
    -log sigma(-(start . context)) over the negative ones. The negative term
    is ``log_sigmoid(-x)``, not the reference's ``log(1 - sigma(x) + eps)``,
    which turns to log(0) once sigma saturates (JAX n2v.py:107-113).

    The rows are gathered by ``ops/segment.gather_rows``, whose backward
    adds in a fixed order: ``F.embedding``'s backward does not on the card
    (``scripts/repeat_probe.py``), and node2vec features did not repeat."""

    def dots(rw):
        w = rw.unfold(1, context_size, 1).reshape(-1, context_size)
        start = gather_rows(emb, w[:, :1])  # [M, 1, H]
        rest = gather_rows(emb, w[:, 1:])  # [M, C-1, H]
        return (start * rest).sum(-1).reshape(-1)

    pos_loss = -F.logsigmoid(dots(pos_rw)).mean()
    neg_loss = -F.logsigmoid(-dots(neg_rw)).mean()
    return pos_loss + neg_loss


def epoch_schedule(rng: np.random.Generator, all_starts: np.ndarray, batch_size: int):
    """One epoch's start nodes [steps, batch_size]: a permutation, padded
    to whole batches by ``rng.choice`` (JAX n2v.py:127-136, the same draws)."""
    steps = -(-len(all_starts) // batch_size)
    perm = rng.permutation(len(all_starts))
    pad = steps * batch_size - len(all_starts)
    if pad:
        perm = np.concatenate([perm, rng.choice(len(all_starts), pad)])
    return all_starts[perm].reshape(steps, batch_size)


def node2vec_pretrain(
    g: Graph,
    embedding_dim: int = 16,
    *,
    walk_length: int = 20,
    context_size: int = 10,
    walks_per_node: int = 10,
    num_negative_samples: int = 1,
    lr: float = 0.01,
    epochs: int = 50,
    batch_size: int = 512,
    seed: int = 1,
    device="cuda",
) -> np.ndarray:
    """Train node2vec embeddings on ``device``; returns [N, embedding_dim]
    float32. The embedding starts N(0, 1) (torch Embedding) from a generator
    seeded with ``seed``; the epoch schedule comes from
    ``np.random.default_rng(seed)``, as in the JAX package."""
    from s3grl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    dg = DeviceGraph.from_graph(g, device=dev)
    N = g.num_nodes
    deg = torch.as_tensor(
        np.minimum(g.degrees, dg.nbr.shape[1]), dtype=torch.int32, device=dev
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    emb = torch.randn((N, embedding_dim), generator=gen, device=dev).requires_grad_()
    opt = torch.optim.Adam([emb], lr=lr)

    all_starts = np.repeat(np.arange(N, dtype=np.int64), walks_per_node)
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        sched = torch.as_tensor(epoch_schedule(rng, all_starts, batch_size), device=dev)
        for starts in sched:
            pos_rw = random_walks(dg.nbr, deg, starts, walk_length, gen)
            neg_rw = negative_walks(starts, N, walk_length, num_negative_samples, gen)
            loss = skipgram_loss(emb, pos_rw, neg_rw, context_size)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return emb.detach().cpu().numpy().astype(np.float32)
