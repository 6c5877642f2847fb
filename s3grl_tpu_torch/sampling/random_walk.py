"""ScaLed random-walk subgraph extraction.

Port of ``s3grl_tpu/sampling/random_walk.py`` (reference: the rw branch of
``k_hop_subgraph``, utils.py:86-150): the node set of a link is the union
of the nodes that M uniform random walks of length m visit from src and
from dst; nodes are id-ordered with src and dst first (``torch.unique``
sorts, utils.py:132-135), dists are 0 on the targets and 1 elsewhere
(utils.py:145-146), and the target link is removed.

Each link's walks depend on its seed alone, never on the batch it lands in:
the JAX package gives each link ``PRNGKey(link_seed)``. Here every uniform
is a counter-based hash of ``(link_seed, step, walk)`` computed with int64
tensor ops (:func:`hash_uniforms`), so one batched call serves every link
and the CPU and the card draw the same bits. The walks differ from the JAX
package's (another generator); their law is the same.
"""
from __future__ import annotations

import torch

from s3grl_tpu_torch.models.n2v import walk_steps
from s3grl_tpu_torch.sampling.extraction import (
    DeviceGraph,
    SubgraphBatch,
    assemble_local_structure,
    select_padded_nodes,
)

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # Weyl increment of the step counter
_WALK_MUL = 0x7FEB352D  # odd multiplier of the walk counter


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64 ``h`` in [0, 2^32) and a 32-bit
    constant, in two 16-bit halves of ``c`` so that no product reaches 2^63."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer, a bijection of [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_uniforms(link_seeds: torch.Tensor, steps: int, walks: int) -> torch.Tensor:
    """Uniforms [B, steps, walks] float32 in [0, 1): entry (b, t, w) is the
    top 24 bits of a hash of ``(link_seeds[b], t, w)`` over 2^24. Every
    intermediate stays below 2^49, so the CPU and the card agree bit for bit."""
    dev = link_seeds.device
    h = _fmix32(link_seeds.to(torch.int64) & _MASK32)[:, None, None]
    t = torch.arange(1, steps + 1, dtype=torch.int64, device=dev)[None, :, None]
    w = torch.arange(1, walks + 1, dtype=torch.int64, device=dev)[None, None, :]
    h = _fmix32(h ^ _mul32(t, _GOLDEN))
    h = _fmix32(h ^ _mul32(w, _WALK_MUL))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def rw_membership(
    dg: DeviceGraph, links: torch.Tensor, link_seeds: torch.Tensor, *, rw_m: int, rw_M: int
) -> torch.Tensor:
    """[B, N] bool: the nodes that ``rw_M`` walks of length ``rw_m`` from
    each endpoint visit (starts ``tile(link, M)``: src, dst, src, ...)."""
    B = links.shape[0]
    starts = links.long().repeat(1, rw_M).reshape(-1)  # [B * 2M]
    u = hash_uniforms(link_seeds, rw_m, 2 * rw_M)  # [B, m, 2M]
    u = u.permute(1, 0, 2).reshape(rw_m, B * 2 * rw_M)
    deg = dg.nbr_mask.sum(dim=1)
    rw = walk_steps(dg.nbr, deg, starts, u)  # [B * 2M, m + 1]
    member = torch.zeros((B, dg.num_nodes), dtype=torch.bool, device=links.device)
    return member.scatter_(1, rw.reshape(B, -1), True)


def rw_local_structure(
    dg: DeviceGraph,
    links: torch.Tensor,  # [B, 2]
    member: torch.Tensor,  # [B, N] bool
    *,
    max_nodes: int,
) -> SubgraphBatch:
    """The padded subgraphs of a membership mask: member ids in id order
    after src and dst, dist 0 on the targets and 1 elsewhere.

    The JAX package keys non-members ``N + 1`` each and lets ``top_k`` break
    the ties by the lower id; keying them ``N + 1 + id`` gives the same
    order with unique keys, so ``torch.topk`` needs no tie rule."""
    B, N = member.shape
    ids = torch.arange(N, dtype=torch.int64, device=member.device)[None, :]
    sel_key = torch.where(member, ids, N + 1 + ids)
    nodes, node_mask = select_padded_nodes(sel_key, links, max_nodes, valid_below=N + 1)
    dist = torch.ones((B, max_nodes), dtype=torch.int32, device=member.device)
    dist[:, :2] = 0
    dist = dist * node_mask
    return assemble_local_structure(
        dg, nodes, node_mask, dist, member.sum(dim=1).to(torch.int32)
    )


def extract_rw_subgraphs(
    dg: DeviceGraph,
    links: torch.Tensor,  # [B, 2]
    link_seeds: torch.Tensor,  # [B]
    *,
    rw_m: int,
    rw_M: int,
    max_nodes: int,
) -> SubgraphBatch:
    """Batched ScaLed extraction: walks, membership, then the padded local
    structure."""
    member = rw_membership(dg, links, link_seeds, rw_m=rw_m, rw_M=rw_M)
    return rw_local_structure(dg, links, member, max_nodes=max_nodes)
