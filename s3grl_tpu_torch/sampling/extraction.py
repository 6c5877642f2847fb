"""Batched enclosing-subgraph extraction in torch.

Port of ``s3grl_tpu/sampling/extraction.py``: a whole batch of links is
expanded at once by frontier propagation over the edge list, then padded
node sets (and, for the gather path, local neighbor tables) are built with
fixed shapes.

Semantics preserved from the reference (utils.py:47-85):
- fringe expansion from {src, dst} for ``num_hops`` hops;
- node ordering [src, dst, hop-1 nodes, hop-2 nodes, ...], ties by node id;
- target-link removal A[0,1] = A[1,0] = 0;
- subgraphs larger than the pad ``max_nodes`` keep the closest-hop nodes;
- optional per-hop down-sampling ``ratio_per_hop`` / cap
  ``max_nodes_per_hop`` (utils.py:66-70), as the JAX package does it: each
  link keeps the newly reached nodes of lowest priority, the priorities
  being ``jax.random``'s uniforms for (link seed, hop, node), which
  ``sampling/prng.py`` reproduces bit for bit. Per-link seeds make the
  sampled set independent of how links are batched.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from s3grl_tpu_torch import native
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.sampling.prng import uniforms

_UNREACHED = 0x3FFFFFFF


@dataclass(frozen=True)
class DeviceGraph:
    """Global graph on the device: edge list + padded neighbor table."""

    num_nodes: int
    edge_src: torch.Tensor  # [E] int64
    edge_dst: torch.Tensor  # [E] int64
    edge_weight: torch.Tensor  # [E] float32
    nbr: torch.Tensor  # [N, D] int32 padded neighbor ids (self-padded)
    nbr_w: torch.Tensor  # [N, D] float32 (0 on padding)
    nbr_mask: torch.Tensor  # [N, D] bool
    x: Optional[torch.Tensor]  # [N, F] float32 node features or None
    # Host copy of (src, dst, weight) for host consumers (CCN sizing).
    host: tuple = field(repr=False, compare=False, default=())

    @classmethod
    def from_graph(
        cls, g: Graph, max_degree: Optional[int] = None, *, device="cuda"
    ) -> "DeviceGraph":
        from s3grl_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        if max_degree is None:
            # Round the table width up to 32, as the JAX package does, so
            # every [B, S, D] shape matches it.
            max_degree = ((g.max_degree + 31) // 32) * 32
        nbr, nbr_w, deg = g.padded_adjacency(max_degree)
        D = nbr.shape[1]
        mask = np.arange(D)[None, :] < deg[:, None]
        w = (
            g.edge_weight.astype(np.float32)
            if g.edge_weight is not None
            else np.ones(g.num_edges, dtype=np.float32)
        )
        src = np.asarray(g.edge_index[0], dtype=np.int32)
        dst = np.asarray(g.edge_index[1], dtype=np.int32)
        return cls(
            num_nodes=g.num_nodes,
            edge_src=torch.as_tensor(src, dtype=torch.int64, device=dev),
            edge_dst=torch.as_tensor(dst, dtype=torch.int64, device=dev),
            edge_weight=torch.as_tensor(w, device=dev),
            nbr=torch.as_tensor(nbr, dtype=torch.int32, device=dev),
            nbr_w=torch.as_tensor(nbr_w, device=dev),
            nbr_mask=torch.as_tensor(mask, device=dev),
            x=None
            if g.x is None
            else torch.as_tensor(g.x, dtype=torch.float32, device=dev),
            host=(src, dst, w),
        )

    @property
    def device(self) -> torch.device:
        return self.nbr.device

    def degrees(self) -> torch.Tensor:
        """[N] int32 on the device: the live prefix of each row of ``nbr``
        (the node's degree, at most the table's width), counted once per
        graph."""
        deg = self.__dict__.get("_degrees")
        if deg is None:
            deg = self.nbr_mask.sum(dim=1, dtype=torch.int32)
            object.__setattr__(self, "_degrees", deg)
        return deg

    def x_with_indicator(self) -> torch.Tensor:
        """[N, F+1] float32 on the device: a zero column, then ``x``, made
        once per graph. The PoS kernel reads a subgraph's features from it by
        node id and writes the indicator into column 0 itself, so the rows
        keep the [indicator | x] layout with no per-batch copy.

        It is a second copy of ``x`` beside it, made only on a graph whose
        PoS operators take the global route: ``x`` stays the contiguous
        [N, F] array that the SoP chain's CSR kernel takes
        (``_build.check_arg`` refuses a strided view such as this copy's
        ``[:, 1:]``), and the local route reads it too (42 MB for
        BlogCatalog's 1,025 columns)."""
        x1 = self.__dict__.get("_x_with_indicator")
        if x1 is None:
            x1 = torch.nn.functional.pad(self.x.float(), (1, 0)).contiguous()
            object.__setattr__(self, "_x_with_indicator", x1)
        return x1

    def repeats_a_neighbor(self) -> bool:
        """Whether a row's live prefix of ``nbr`` names one neighbor twice
        (a repeated edge), found once per graph: without repeats no row of a
        subgraph-local table holds more entries than the subgraph has
        slots."""
        found = self.__dict__.get("_repeats")
        if found is None:
            N = self.num_nodes
            ids = torch.sort(torch.where(self.nbr_mask, self.nbr, N), dim=1).values
            found = bool(((ids[:, 1:] == ids[:, :-1]) & (ids[:, 1:] < N)).any())
            object.__setattr__(self, "_repeats", found)
        return found

    def host_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """(row_ptr [N+1], col_idx [E]) of the edge list by the native host
        core, built once per graph."""
        csr = self.__dict__.get("_host_csr")
        if csr is None:
            src, dst, _ = self.host_edges()
            csr = native.build_csr(src, dst, None, self.num_nodes)[:2]
            object.__setattr__(self, "_host_csr", csr)
        return csr

    def host_edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, weight) as host numpy arrays."""
        if self.host:
            return self.host
        return (
            self.edge_src.cpu().numpy().astype(np.int32),
            self.edge_dst.cpu().numpy().astype(np.int32),
            self.edge_weight.cpu().numpy(),
        )


class SubgraphBatch(NamedTuple):
    """Fixed-shape extraction result for a batch of B links.

    nodes:     [B, S] int32 global node ids (slot 0 = src, slot 1 = dst)
    node_mask: [B, S] bool   validity of each slot
    dist:      [B, S] int32  hop distance from {src, dst} (0 for src/dst)
    nbr_local: [B, S, D] int32 local slot index of each neighbor (0 on pad)
    nbr_w:     [B, S, D] f32   edge weight (0 on pad; target link removed)
    sub_size:  [B] int32     true (untruncated) subgraph size
    """

    nodes: torch.Tensor
    node_mask: torch.Tensor
    dist: torch.Tensor
    nbr_local: torch.Tensor
    nbr_w: torch.Tensor
    sub_size: torch.Tensor


def dense_adjacency(sub: SubgraphBatch) -> torch.Tensor:
    """Dense [B, S, S] f32 sub-adjacency from the local neighbor structure:
    ``adj[b, s, nbr_local[b, s, d]] += nbr_w[b, s, d]``, one scatter-add.

    Padding entries have weight 0 and local index 0, so they add nothing.
    The JAX package adds the D entries in order; with 0/1 weights every
    order gives the same bits.
    """
    B, S, _ = sub.nbr_local.shape
    adj = torch.zeros((B, S, S), dtype=sub.nbr_w.dtype, device=sub.nbr_w.device)
    return adj.scatter_add_(2, sub.nbr_local.long(), sub.nbr_w)


def samples(ratio_per_hop: float, max_nodes_per_hop: Optional[int]) -> bool:
    """Whether these flags ask for per-hop sampling."""
    return ratio_per_hop < 1.0 or max_nodes_per_hop is not None


def link_seeds_of(seed: int, num_links: int) -> np.ndarray:
    """The JAX package's per-link seeds: ``seed * 1_000_003 + i`` as int32."""
    return (np.int64(seed) * 1_000_003 + np.arange(num_links)).astype(np.int32)


def _sample_newly(
    newly: torch.Tensor,  # [B, N] bool
    link_seeds: torch.Tensor,  # [B]
    hop: int,
    ratio_per_hop: float,
    max_nodes_per_hop: Optional[int],
) -> torch.Tensor:
    """Keep, of each link's newly reached nodes, the ``keep_n`` of lowest
    priority (JAX extraction.py:182-217): the priority is 2.0 off the new
    nodes, a stable sort breaks ties by node id, and
    ``keep_n = int32(f32(ratio_per_hop) * f32(count))``, at most
    ``max_nodes_per_hop``. The uniforms are drawn only at the new nodes."""
    B, N = newly.shape
    b_ix, n_ix = newly.nonzero(as_tuple=True)
    pri = torch.full((B, N), 2.0, dtype=torch.float32, device=newly.device)
    pri[b_ix, n_ix] = uniforms(link_seeds[b_ix], hop, n_ix[:, None])[:, 0]
    order = torch.sort(pri, dim=1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(N, device=newly.device).expand(B, N))
    keep_n = newly.sum(dim=1, keepdim=True)
    if ratio_per_hop < 1.0:
        ratio = torch.tensor(ratio_per_hop, dtype=torch.float32, device=newly.device)
        keep_n = (ratio * keep_n.to(torch.float32)).to(torch.int32)
    if max_nodes_per_hop is not None:
        keep_n = torch.clamp(keep_n, max=max_nodes_per_hop)
    return newly & (rank < keep_n)


def _bfs_distances(
    dg: DeviceGraph,
    links: torch.Tensor,  # [B, 2] integer
    num_hops: int,
    ratio_per_hop: float = 1.0,
    max_nodes_per_hop: Optional[int] = None,
    link_seeds: Optional[torch.Tensor] = None,  # [B] per-link RNG seeds
) -> torch.Tensor:
    """Hop distances [B, N] (int32) from the union fringe of {src, dst}.

    One frontier scatter-add over the edge list per hop. The sum is only
    tested ``> 0`` and adds 0s and 1s, so the order of the float atomics
    on the GPU cannot change the result. Per-hop sampling needs
    ``link_seeds`` and raises without them.
    """
    sample = samples(ratio_per_hop, max_nodes_per_hop)
    if sample and link_seeds is None:
        raise ValueError("per-hop sampling needs link_seeds (one seed per link)")
    B = links.shape[0]
    N = dg.num_nodes
    links = links.long()
    dist = torch.full((B, N), _UNREACHED, dtype=torch.int32, device=links.device)
    b_idx = torch.arange(B, device=links.device)
    dist[b_idx, links[:, 0]] = 0
    dist[b_idx, links[:, 1]] = 0
    for hop in range(1, num_hops + 1):
        frontier = (dist == hop - 1).to(torch.float32)  # [B, N]
        contrib = frontier[:, dg.edge_src]  # [B, E]
        reached = torch.zeros((B, N), dtype=torch.float32, device=links.device)
        reached.index_add_(1, dg.edge_dst, contrib)
        newly = (reached > 0) & (dist == _UNREACHED)
        if sample:
            newly = _sample_newly(
                newly, link_seeds.to(links.device), hop, ratio_per_hop, max_nodes_per_hop
            )
        dist = torch.where(newly, torch.full_like(dist, hop), dist)
    return dist


def select_padded_nodes(
    sel_key: torch.Tensor, links: torch.Tensor, S: int, valid_below: int
):
    """Select up to S nodes per row by smallest key; src/dst forced first.

    sel_key: [B, N] integer ordering keys (entries >= valid_below are
    invalid). Keys are unique per row, so ``torch.topk`` gives the order of
    ``jax.lax.top_k``. Returns (nodes [B, S] int32, node_mask [B, S] bool).
    """
    B, N = sel_key.shape
    b_idx = torch.arange(B, device=sel_key.device)
    links = links.long()
    sel_key = sel_key.clone()
    sel_key[b_idx, links[:, 0]] = -2
    sel_key[b_idx, links[:, 1]] = -1
    k_sel = min(S, N)
    neg_key, nodes = torch.topk(-sel_key, k_sel, dim=1, largest=True, sorted=True)
    if k_sel < S:  # pad bucket wider than the whole graph
        nodes = torch.nn.functional.pad(nodes, (0, S - k_sel))
        neg_key = torch.nn.functional.pad(
            neg_key, (0, S - k_sel), value=-(valid_below + N)
        )
    nodes = nodes.to(torch.int32)
    node_mask = (-neg_key) < valid_below
    # self-link degenerate case (src == dst): slot 0 is always valid
    node_mask[:, 0] = True
    return nodes, node_mask


def extract_node_sets(
    dg: DeviceGraph,
    links: torch.Tensor,  # [B, 2]
    *,
    num_hops: int,
    max_nodes: int,
    ratio_per_hop: float = 1.0,
    max_nodes_per_hop: Optional[int] = None,
    link_seeds: Optional[torch.Tensor] = None,
):
    """BFS + top-k selection only: (nodes, node_mask, sel_dist, sub_size)."""
    B = links.shape[0]
    N = dg.num_nodes
    dist = _bfs_distances(
        dg, links, num_hops, ratio_per_hop, max_nodes_per_hop, link_seeds
    )
    visited = dist != _UNREACHED
    sub_size = visited.sum(dim=1).to(torch.int32)
    dist_clip = torch.clamp(dist, max=num_hops + 1)
    sel_key = dist_clip * N + torch.arange(
        N, dtype=torch.int32, device=dist.device
    )[None, :]
    valid_below = (num_hops + 1) * N
    nodes, node_mask = select_padded_nodes(sel_key, links, max_nodes, valid_below)
    b_idx = torch.arange(B, device=dist.device)
    sel_dist = torch.where(
        node_mask, dist[b_idx[:, None], nodes.long()], torch.zeros_like(nodes)
    )
    return nodes, node_mask, sel_dist.to(torch.int32), sub_size


def assemble_local_structure(
    dg: DeviceGraph,
    nodes: torch.Tensor,
    node_mask: torch.Tensor,
    sel_dist: torch.Tensor,
    sub_size: torch.Tensor,
    *,
    remove_target_link: bool = True,
    binary_adj: bool = True,
) -> SubgraphBatch:
    """Build the local padded neighbor structure for selected node sets,
    through a per-link position map (global id -> local slot + 1)."""
    B, S = nodes.shape
    N = dg.num_nodes
    dev = nodes.device
    nodes_l = nodes.long()
    # pos_map[b, global_id] = local slot + 1, 0 = absent; invalid slots park
    # on the sentinel column N, which no neighbor id reads.
    pos_map = torch.zeros((B, N + 1), dtype=torch.int32, device=dev)
    safe_nodes = torch.where(node_mask, nodes_l, torch.full_like(nodes_l, N))
    slots = torch.arange(1, S + 1, dtype=torch.int32, device=dev).expand(B, S)
    pos_map.scatter_(1, safe_nodes, slots)

    gnbr = dg.nbr[nodes_l]  # [B, S, D]
    gmask = dg.nbr_mask[nodes_l]
    gnbr_w = gmask.to(torch.float32) if binary_adj else dg.nbr_w[nodes_l]
    D = gnbr.shape[2]
    lj1 = torch.gather(pos_map, 1, gnbr.reshape(B, S * D).long()).reshape(B, S, D)
    hit = (lj1 > 0) & gmask & node_mask[:, :, None]
    local_j = torch.where(hit, lj1 - 1, torch.zeros_like(lj1))
    w = torch.where(hit, gnbr_w, torch.zeros_like(gnbr_w))

    if remove_target_link:
        # zero the (0 -> 1) and (1 -> 0) entries (utils.py:78-80)
        row_i = torch.arange(S, device=dev)[None, :, None]
        kill = ((row_i == 0) & (local_j == 1)) | ((row_i == 1) & (local_j == 0))
        w = torch.where(kill, torch.zeros_like(w), w)

    return SubgraphBatch(
        nodes=nodes,
        node_mask=node_mask,
        dist=sel_dist.to(torch.int32),
        nbr_local=local_j,
        nbr_w=w,
        sub_size=sub_size,
    )


def extract_subgraphs(
    dg: DeviceGraph,
    links: torch.Tensor,  # [B, 2]
    *,
    num_hops: int,
    max_nodes: int,
    ratio_per_hop: float = 1.0,
    max_nodes_per_hop: Optional[int] = None,
    remove_target_link: bool = True,
    binary_adj: bool = True,
    link_seeds: Optional[torch.Tensor] = None,
) -> SubgraphBatch:
    """Extract padded enclosing subgraphs for a batch of links."""
    nodes, node_mask, sel_dist, sub_size = extract_node_sets(
        dg,
        links,
        num_hops=num_hops,
        max_nodes=max_nodes,
        ratio_per_hop=ratio_per_hop,
        max_nodes_per_hop=max_nodes_per_hop,
        link_seeds=link_seeds,
    )
    return assemble_local_structure(
        dg,
        nodes,
        node_mask,
        sel_dist,
        sub_size,
        remove_target_link=remove_target_link,
        binary_adj=binary_adj,
    )


def sym_normalize(adj: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """D^-1/2 A D^-1/2 with 0-degree guarded (reference: tuned_SIGN.py:155-161)."""
    deg = adj.sum(dim=-1)
    inv_sqrt = torch.where(
        deg > eps, torch.rsqrt(torch.clamp(deg, min=1e-30)), torch.zeros_like(deg)
    )
    return adj * inv_sqrt[..., :, None] * inv_sqrt[..., None, :]


def pick_bucket(size: int, buckets) -> int:
    """Smallest bucket >= size (caps at the largest bucket)."""
    for b in sorted(buckets):
        if size <= b:
            return int(b)
    return int(sorted(buckets)[-1])
