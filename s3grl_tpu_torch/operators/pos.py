"""PoS (Powers of Subgraph) operator precompute on the GPU.

Port of ``s3grl_tpu/operators/pos.py`` (reference semantics:
``OptimizedSignOperations.get_PoS_prepped_ds`` / ``get_PoS_Plus_prepped_ds``,
tuned_SIGN.py:137-262). A batch of links is processed at once:

1. node sets: the device BFS (:func:`extract_node_sets`, with per-hop
   sampling where asked), the native host BFS on large graphs (below), or
   with ``rw_m``/``rw_M`` ScaLed's random-walk subgraphs
   (``sampling/random_walk.py``);
2. selected rows (the two targets + optional CCN rows, union or
   intersection, tuned_SIGN.py:229-238);
3. the selected rows of Â^k [1|X] for k = 0..K, through the hand-written
   kernel ``ops/pos_kernel.pos_power_rows``: on BFS node sets it resolves
   subgraph membership straight from the global neighbor table, or, on the
   local-table route (below), runs in its local-slot mode (``row_ids=None``)
   on a table the card builds; on ScaLed's local tables it runs in that
   mode too, as the JAX package's ``use_pallas`` route does
   (pos.py:254-262).

The large-graph route (JAX pos.py:654-755, 1023-1060): where no ScaLed and
no sampling is asked and ``L·E`` reaches :data:`HOST_EXTRACT_MIN_LE` (1e8;
``S3GRL_TPU_HOST_EXTRACT`` = ``auto``, ``0`` or ``1`` overrides), the
threaded C++ BFS of ``native/graphcore.cpp`` builds the node sets on the
host, in the device BFS's order ((hop, node id), src and dst first), so the
dataset is the same bits. Where ``L·max_subgraph_nodes`` <= 6.4e7 one pass
over the whole split runs first, its size column the bucketing oracle;
above that ``native.bfs_sizes`` sizes the split and each batch takes its
own pass. Below the threshold everything runs on the device.

The local-table route (JAX ``pos_operators_local``, pos.py:440-512, and its
per-bucket branch under ``S3GRL_TPU_LOCAL_TAB=1``, pos.py:1023-1046): on
BFS node sets, host or device, and without sampling, a bucket may take its
subgraphs' local neighbor tables, built on the card by the hand-written
kernel ``ops/local_table.local_table`` from the node sets and the global
table in one launch, at most ``min(S, D_tab)`` wide
(:func:`local_table_width`) instead of the global table's width.
:func:`local_table_route` decides per bucket: ``S3GRL_TPU_LOCAL_TAB`` =
``1`` in every bucket, ``0`` in none, ``auto`` (the default) where the
bucket's S is at most :data:`LOCAL_TAB_MAX_S_OVER_D` of the global table's
width. The datasets are the global route's, bit for bit: the table keeps
the global table's order of each row's entries, so the kernel adds the
same terms in the same order.

:func:`pos_operators` keeps the JAX package's gather path on a local
neighbor table: the plain oracle the tests hold the kernel routes against.

Left out of the port, because they exist for the TPU and its remote
compiler and change no output: the sticky CCN and table-width caches
(``_EFF_CCN_STICKY``, ``_sticky_dpad``'s; padding columns carry weight 0),
the scan route, the ``vmem_ok`` gate (every bucket goes through the kernel
here), the staircase slot permutation (it changes only the TPU kernel's
densify cost) and padding batches to a fixed size. Left out too: the
JAX package's host build of local tables as a route (on the card it cost
more than the kernel saved; ``native.khop_local_tab`` is bound as the
tests' oracle) and its pipelined whole-split pass (one pass bucketed once
was faster on the card). The JAX package's CCN percentile pad
(``S3GRL_TPU_CCN_PAD_PCT``) is the constant :data:`CCN_PAD_PCT`, 100 (the
exact maximum): no workload sets it lower. The sharded path's hooks
are :func:`pos_plan`'s ``size_oracle`` and ``batch_multiple`` and the
per-batch body :func:`_extract_and_operate`; the JAX ``extract_fn`` and
``out_shardings`` have no counterpart, since each rank runs its share of a
batch in a process of its own (``parallel/dist.py``).
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from s3grl_tpu_torch import native
from s3grl_tpu_torch.operators.common import OperatorDataset
from s3grl_tpu_torch.ops.local_table import local_table, table_width
from s3grl_tpu_torch.ops.pos_kernel import pos_power_rows
from s3grl_tpu_torch.profiling import count, span
from s3grl_tpu_torch.sampling.extraction import (
    _UNREACHED,
    DeviceGraph,
    SubgraphBatch,
    _bfs_distances,
    extract_node_sets,
    link_seeds_of,
    pick_bucket,
    samples,
)
from s3grl_tpu_torch.sampling.random_walk import extract_rw_subgraphs

# Dataset footprint limit before the bf16 and host tiers when
# ``S3GRL_TPU_DEVICE_DS_BYTES`` is unset, as in the JAX package (pos.py:818):
# the tiers change the dataset's dtype or CCN width, so the port reads the
# same variable with the same default to produce the same datasets.
DEVICE_DS_BYTES = 3.5e9
# f32 elements per transient [B, S, *] tensor, bounding the batch per bucket.
ELEM_BUDGET = 256_000_000
# The host-extract route's threshold on L·E, the JAX package's setting
# (pos.py:674-676).
HOST_EXTRACT_MIN_LE = 1e8
# The whole-split host BFS pass runs while its [L, max_subgraph_nodes] int32
# table holds at most this many entries (~256 MB), as in the JAX package.
KHOP_TABLE_ENTRIES = 6.4e7
# ``S3GRL_TPU_LOCAL_TAB=auto`` takes the local-table route in a bucket whose
# S is at most this share of the global table's width (local_table_route):
# chip_smoke.py's threshold sweep found the local route faster a link at
# every point it took, up to 3,072 / 3,392 = 0.906 on the hub graph (1.0 on
# the arxiv-shaped graph, 0.667 on the Cora-shaped one); 0.906 rounded up.
LOCAL_TAB_MAX_S_OVER_D = 0.91


def _ccn_select(nbr0, nbr1, node_mask, strategy: str, max_ccn: int, R: int):
    """(sel_idx [B, R] int32, row_mask [B, R] bool) from the targets'
    neighbor-membership masks [B, S]: the max_ccn lowest CCN slots (closest
    hops first). ``key`` has many ties at S + 1; a stable sort keeps the
    lower slot first, as ``jax.lax.top_k`` does."""
    B, S = node_mask.shape
    dev = node_mask.device
    sel_idx = torch.zeros((B, R), dtype=torch.int32, device=dev)
    sel_idx[:, 1] = 1
    row_mask = torch.zeros((B, R), dtype=torch.bool, device=dev)
    row_mask[:, :2] = True
    if max_ccn <= 0:
        return sel_idx, row_mask
    if strategy == "union":
        ccn = nbr0 | nbr1
    elif strategy == "intersection":
        ccn = nbr0 & nbr1
    else:
        raise NotImplementedError(f"check strat {strategy}")
    ccn = ccn & node_mask
    ccn[:, :2] = False
    slot = torch.arange(S, dtype=torch.int32, device=dev)
    key = torch.where(ccn, slot[None, :], torch.full_like(slot, S + 1)[None, :])
    k_eff = min(max_ccn, S)
    keys, idx = torch.sort(key, dim=1, stable=True)
    keys, idx = keys[:, :k_eff], idx[:, :k_eff]
    ccn_valid = keys <= S
    sel_idx[:, 2 : 2 + k_eff] = torch.where(ccn_valid, idx.to(torch.int32), 0)
    row_mask[:, 2 : 2 + k_eff] = ccn_valid
    return sel_idx, row_mask


def _slot_neighbors(loc_row: torch.Tensor, w_row: Optional[torch.Tensor], S: int) -> torch.Tensor:
    """[B, S] bool: the slots that a row of a local table [B, D] names with
    a nonzero weight (``w_row`` None: every slot >= 0)."""
    B = loc_row.shape[0]
    named = loc_row >= 0 if w_row is None else w_row > 0
    idx = torch.where(named, loc_row.long(), torch.full_like(loc_row, S, dtype=torch.long))
    hit = torch.zeros((B, S + 1), dtype=torch.bool, device=loc_row.device)
    return hit.scatter_(1, idx, True)[:, :S]


def _slot_kernel_inputs(x_global, nodes, node_mask, nbr_local, nbr_w, *, max_ccn, strategy):
    """``pos_power_rows``' inputs in its local-slot mode for node sets
    [B, S] and their local table [B, S, D]: (sel_idx [B, R] i32, nbr_local,
    nbr_w, subg_x [B, S, F+1] f32, row_mask [B, R] bool), R = 2 + max_ccn.
    ``nbr_w`` None weighs 1 every slot >= 0. CCN membership compares the
    targets' rows with the slots. Invalid CCN slots point at row 0; the row
    mask zeroes them afterwards."""
    B, S = nodes.shape
    dev = nodes.device
    x_sub = x_global[nodes.long()] * node_mask[:, :, None].to(torch.float32)
    ind = torch.zeros((B, S, 1), dtype=torch.float32, device=dev)
    ind[:, :2] = 1.0  # the indicator column on the targets (tuned_SIGN.py:177)
    subg_x = torch.cat([ind, x_sub], dim=-1)  # [B, S, F+1]
    nbr0 = nbr1 = None
    if max_ccn > 0:
        w0, w1 = (None, None) if nbr_w is None else (nbr_w[:, 0], nbr_w[:, 1])
        nbr0 = _slot_neighbors(nbr_local[:, 0], w0, S)
        nbr1 = _slot_neighbors(nbr_local[:, 1], w1, S)
    sel_idx, row_mask = _ccn_select(nbr0, nbr1, node_mask, strategy, max_ccn, 2 + max_ccn)
    return sel_idx, nbr_local, nbr_w, subg_x, row_mask


def local_kernel_inputs(
    sub: SubgraphBatch,
    x_global: torch.Tensor,  # [N, F]
    *,
    max_ccn: int = 0,
    strategy: str = "",
):
    """``pos_power_rows``' inputs in its local-slot mode for one extracted
    batch: (sel_idx [B, R] i32, nbr [B, S, D] i32 local slots, w [B, S, D]
    f32, subg_x [B, S, F+1] f32, row_mask [B, R] bool), R = 2 + max_ccn."""
    return _slot_kernel_inputs(
        x_global, sub.nodes, sub.node_mask, sub.nbr_local.to(torch.int32).contiguous(),
        sub.nbr_w.contiguous(), max_ccn=max_ccn, strategy=strategy,
    )


def local_table_width(dg: DeviceGraph, S: int) -> int:
    """The width of a bucket's local tables, one no row can pass:
    ``min(S, D_tab)`` rounded up to 32 (a row names each member at most once
    and has at most ``D_tab`` live entries), or ``D_tab`` rounded up where
    the global table repeats a neighbor."""
    D = int(dg.nbr.shape[1])
    return table_width(D if dg.repeats_a_neighbor() else min(S, D))


def local_table_kernel_inputs(
    dg: DeviceGraph,
    links: torch.Tensor,  # [B, 2]
    nodes: torch.Tensor,  # [B, S] global ids (slot 0 = src, 1 = dst)
    node_mask: torch.Tensor,  # [B, S]
    *,
    max_ccn: int = 0,
    strategy: str = "",
):
    """The kernel's inputs on the local-table route, beside
    :func:`global_kernel_inputs`: the batch's local table built on the card
    (``ops/local_table.local_table``, at :func:`local_table_width`), then
    :func:`local_kernel_inputs`' (sel_idx, nbr, w, subg_x, row_mask) on it,
    with ``w`` None: the table carries no weights (1 where its slot is
    >= 0)."""
    loc = local_table(dg.nbr, dg.degrees(), nodes.to(torch.int32).contiguous(),
                      node_mask.contiguous(), links, local_table_width(dg, int(nodes.shape[1])))
    return _slot_kernel_inputs(dg.x, nodes, node_mask, loc, None, max_ccn=max_ccn,
                               strategy=strategy)


def pos_operators_local(
    dg: DeviceGraph,
    nodes: torch.Tensor,  # [B, S] global ids (slot 0 = src, 1 = dst)
    node_mask: torch.Tensor,  # [B, S]
    loc_nbr: torch.Tensor,  # [B, S, D] integer local slots, -1 pad, link removed
    *,
    sign_k: int,
    max_ccn: int = 0,
    strategy: str = "",
) -> tuple[torch.Tensor, torch.Tensor]:
    """PoS(+) operators from a subgraph-LOCAL neighbor table (JAX
    ``pos_operators_local``): the semantics of :func:`pos_operators_global`
    (the target link already removed from the table), with the kernel in
    its local-slot mode at the table's width. Weights ``(loc >= 0) &
    node_mask``, as the JAX package derives them: the rows of empty slots
    are cleared to -1, and the kernel takes ``w=None`` (weight 1 where the
    slot is >= 0), so no weight array is built. Returns (xs [B, K+1, R, F+1]
    f32, row_mask [B, R])."""
    loc = torch.where(node_mask[:, :, None], loc_nbr, -1).to(torch.int32).contiguous()
    sel_idx, loc, _, subg_x, row_mask = _slot_kernel_inputs(
        dg.x, nodes, node_mask, loc, None, max_ccn=max_ccn, strategy=strategy
    )
    xs = pos_power_rows(sel_idx, loc, None, subg_x, sign_k=sign_k)
    return xs * row_mask[:, None, :, None], row_mask


def pos_operators(
    sub: SubgraphBatch,
    x_global: torch.Tensor,  # [N, F]
    *,
    sign_k: int,
    max_ccn: int = 0,
    strategy: str = "",
    use_kernel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """PoS(+) operator features for one extracted batch (JAX
    ``pos_operators``): by the gather path on the local neighbor table, or
    with ``use_kernel`` through ``pos_power_rows`` in its local-slot mode
    (the JAX ``use_pallas`` route).

    Returns (xs [B, K+1, R, F+1], row_mask [B, R]) with R = 2 + max_ccn.
    """
    sel_idx, nbr_local, nbr_w, subg_x, row_mask = local_kernel_inputs(
        sub, x_global, max_ccn=max_ccn, strategy=strategy
    )
    if use_kernel:
        xs = pos_power_rows(sel_idx, nbr_local, nbr_w, subg_x, sign_k=sign_k)
        return xs * row_mask[:, None, :, None], row_mask

    # Sym-normalized edge weights (tuned_SIGN.py:155-161):
    # w'[i, d] = dinv[i] * w[i, d] * dinv[j(i, d)].
    B, S, D = nbr_local.shape
    R = sel_idx.shape[1]
    dev = subg_x.device
    nbr_local = nbr_local.long()
    deg = nbr_w.sum(dim=-1)
    dinv = torch.where(
        deg > 0, 1.0 / torch.sqrt(torch.clamp(deg, min=1e-30)), torch.zeros_like(deg)
    )
    dinv_j = torch.gather(dinv, 1, nbr_local.reshape(B, S * D)).reshape(B, S, D)
    w_norm = nbr_w * dinv[:, :, None] * dinv_j

    b_idx = torch.arange(B, device=dev)
    x0 = subg_x[b_idx[:, None], sel_idx.long()] * row_mask[:, :, None]
    # h[b, s, r] = (Â^k e_sel_r)[s], advanced by gather + contraction.
    h = (
        (torch.arange(S, device=dev)[None, :, None] == sel_idx[:, None, :])
        & row_mask[:, None, :]
    ).to(torch.float32)  # [B, S, R]
    ops = [x0]
    flat_j = nbr_local.reshape(B, S * D, 1).expand(B, S * D, R)
    for _ in range(sign_k):
        g = torch.gather(h, 1, flat_j).reshape(B, S, D, R)
        h = torch.einsum("bsd,bsdr->bsr", w_norm, g)
        ops.append(torch.einsum("bsr,bsf->brf", h, subg_x))
    return torch.stack(ops, dim=1), row_mask


def pos_operators_global(
    dg: DeviceGraph,
    links: torch.Tensor,  # [B, 2]
    nodes: torch.Tensor,  # [B, S] global node ids (slot 0 = src, 1 = dst)
    node_mask: torch.Tensor,  # [B, S]
    *,
    sign_k: int,
    max_ccn: int = 0,
    strategy: str = "",
) -> tuple[torch.Tensor, torch.Tensor]:
    """PoS(+) operators straight from node sets + the GLOBAL neighbor table.

    No local-structure assembly: the kernel resolves subgraph membership
    from ``row_ids`` (global ids, -1 on empty slots). Semantics match
    :func:`pos_operators` (binary sub-adjacency, target-link removal, CCN
    selection). Returns (xs [B, K+1, R, F+1] f32, row_mask [B, R]).
    """
    with span("pos.inputs"):
        sel_idx, gnbr, w, subg_x, row_ids, row_mask = global_kernel_inputs(
            dg, links, nodes, node_mask, max_ccn=max_ccn, strategy=strategy
        )
    with span("pos.kernel"):
        xs = pos_power_rows(sel_idx, gnbr, w, subg_x, sign_k=sign_k, row_ids=row_ids)
    return xs * row_mask[:, None, :, None], row_mask


def global_kernel_inputs(
    dg: DeviceGraph,
    links: torch.Tensor,  # [B, 2]
    nodes: torch.Tensor,  # [B, S]
    node_mask: torch.Tensor,  # [B, S]
    *,
    max_ccn: int = 0,
    strategy: str = "",
):
    """The kernel's inputs for :func:`pos_operators_global`: (sel_idx
    [B, R] i32, nbr [B, S, D] i32 global ids, w [B, S, D] f32, subg_x
    [B, S, F+1] f32, row_ids [B, S] i32, row_mask [B, R] bool)."""
    B, S = nodes.shape
    dev = nodes.device
    links = links.long()
    nodes_l = nodes.long()
    # Target rows (slot 0 = src, slot 1 = dst), link-removed (utils.py:78-80).
    gnbr0 = dg.nbr[nodes_l[:, 0]]  # [B, D]
    gnbr1 = dg.nbr[nodes_l[:, 1]]
    w0 = dg.nbr_mask[nodes_l[:, 0]] & (gnbr0 != links[:, 1:2])
    w1 = dg.nbr_mask[nodes_l[:, 1]] & (gnbr1 != links[:, 0:1])

    R = 2 + max_ccn
    nbr0 = nbr1 = None
    if max_ccn > 0:
        nbr0 = ((gnbr0[:, :, None] == nodes[:, None, :]) & w0[:, :, None]).any(1)
        nbr1 = ((gnbr1[:, :, None] == nodes[:, None, :]) & w1[:, :, None]).any(1)
    sel_idx, row_mask = _ccn_select(nbr0, nbr1, node_mask, strategy, max_ccn, R)

    gnbr = dg.nbr[nodes_l]  # [B, S, D] global neighbor ids
    # Binary adjacency (tuned_SIGN.py:155 implicit 1s); contributions FROM
    # invalid slots zeroed; membership of the neighbor resolved in-kernel.
    w = (dg.nbr_mask[nodes_l] & node_mask[:, :, None]).to(torch.float32)
    # Target-link removal on the src (slot 0) and dst (slot 1) rows.
    w[:, 0][gnbr[:, 0] == links[:, 1:2]] = 0.0
    w[:, 1][gnbr[:, 1] == links[:, 0:1]] = 0.0

    ind = torch.zeros((B, S, 1), dtype=torch.float32, device=dev)
    ind[:, :2] = 1.0
    x_sub = dg.x[nodes_l] * node_mask[:, :, None].to(torch.float32)
    subg_x = torch.cat([ind, x_sub], dim=-1)

    row_ids = torch.where(node_mask, nodes, torch.full_like(nodes, -1))
    return (
        sel_idx, gnbr.contiguous(), w, subg_x,
        row_ids.to(torch.int32).contiguous(), row_mask,
    )


def batch_cap(bucket: int, F: int, D_tab: int, eff_ccn: int, batch_size: int) -> int:
    """Links per batch in one size bucket, the JAX package's rule
    (pos.py:888-896): bound the largest per-link transient by
    ELEM_BUDGET, round down to a power of two. ``F`` counts the feature
    columns without the indicator."""
    per_link = max(
        bucket * (F + 1), bucket * bucket, bucket * D_tab * max(2, 2 + eff_ccn)
    )
    cap = max(8, min(batch_size, ELEM_BUDGET // per_link))
    return 1 << (cap.bit_length() - 1)


# PoS+'s CCN width as a percentile of the links' CCN counts (JAX
# ``S3GRL_TPU_CCN_PAD_PCT``): 100 keeps the exact maximum, the reference's
# semantics; below 100 one hub pair no longer sizes every link's rows, but
# the links past the percentile lose rows, so it changes answers.
CCN_PAD_PCT = 100


def measure_ccn_width(
    dg: DeviceGraph, links: np.ndarray, strategy: str, cap: int
) -> int:
    """Tight upper bound on CCN row count over ``links`` from the GLOBAL
    graph (a subgraph CCN set is a subset of the global 1-hop sets).

    The reference keeps exactly |CCN| rows per link (tuned_SIGN.py:238); the
    fixed-shape analog sizes R to the measured max, capped at ``cap``, or,
    with :data:`CCN_PAD_PCT` below 100, to that percentile of the counts
    (JAX pos.py:543-573). A width below the measured max warns "CCN width
    capped", in the JAX package's words.
    """
    import scipy.sparse as ssp

    src_e, dst_e, _ = dg.host_edges()
    N = dg.num_nodes
    A = ssp.csr_matrix(
        (np.ones(len(src_e), dtype=np.float32), (src_e, dst_e)), shape=(N, N)
    )
    A.data[:] = 1.0
    s, d = links[:, 0], links[:, 1]
    cn = np.asarray(A[s].multiply(A[d]).sum(axis=1)).ravel()
    if strategy == "intersection":
        counts = cn
    else:  # union: |N(s)| + |N(d)| - CN, minus the (removed) target edge
        deg = np.asarray(A.sum(axis=1)).ravel()
        has_edge = np.asarray(A[s, d]).ravel()
        counts = deg[s] + deg[d] - cn - 2 * has_edge
    measured = int(counts.max()) if len(counts) else 0
    pct = float(CCN_PAD_PCT)
    if len(counts) and pct < 100:
        width = int(np.ceil(np.percentile(counts, pct)))
    else:
        width = measured
    width = max(1, min(cap, width))
    if width < measured:
        n_trunc = int((counts > width).sum())
        warnings.warn(
            f"CCN width capped at {width} (cap {cap}, pad pct {pct}) < measured max "
            f"{measured}: {n_trunc}/{len(counts)} links lose their "
            f"furthest-slot CCN rows relative to the reference's exact "
            f"selection (tuned_SIGN.py:238). Raise max_ccn_nodes to keep them.",
            stacklevel=2,
        )
    return width


def padded_ccn_width(dg: DeviceGraph, links: np.ndarray, strategy: str, max_ccn: int) -> int:
    """PoS+'s CCN row count for ``links``: the measured width (cap
    ``max_ccn``, 16 where it is not positive), rounded up to a power of two
    (capped) as the JAX package rounds it; the dataset's shape follows it."""
    if max_ccn <= 0:
        max_ccn = 16
    eff_ccn = measure_ccn_width(dg, links, strategy, max_ccn)
    if eff_ccn and max_ccn >= 8:
        r = 8
        while r < eff_ccn:
            r *= 2
        eff_ccn = min(max_ccn, r)
    return eff_ccn


def scaled_batch_plan(
    dg: DeviceGraph,
    num_links: int,
    *,
    rw_m: int,
    rw_M: int,
    seed: int,
    eff_ccn: int,
    buckets,
    max_subgraph_nodes: int,
    batch_size: int,
) -> tuple[int, int, np.ndarray]:
    """ScaLed's batching (JAX pos.py:104-109, 661): (bucket, links per
    batch, link seeds [num_links] int32). A subgraph holds at most the
    ``min(2·M·(m+1), N, max_subgraph_nodes)`` nodes its 2M walks can visit,
    so every link takes that one bucket and no BFS sizing pass runs; link i's
    walks are seeded by ``seed * 1_000_003 + i``."""
    bound = min(2 * rw_M * (rw_m + 1), dg.num_nodes, max_subgraph_nodes)
    bucket = pick_bucket(bound, _size_buckets(buckets, max_subgraph_nodes))
    per_batch = batch_cap(bucket, int(dg.x.shape[1]), int(dg.nbr.shape[1]), eff_ccn, batch_size)
    return bucket, per_batch, link_seeds_of(seed, num_links)


def _size_buckets(buckets, max_subgraph_nodes: int) -> list[int]:
    """The size buckets in use: ``buckets`` and the cap, none above it."""
    return [b for b in sorted(set(buckets) | {max_subgraph_nodes}) if b <= max_subgraph_nodes]


def measure_subgraph_sizes(
    dg: DeviceGraph,
    links: np.ndarray,
    link_seeds: Optional[np.ndarray] = None,
    *,
    num_hops: int,
    ratio_per_hop: float = 1.0,
    max_nodes_per_hop: Optional[int] = None,
    batch_size: int = 512,
) -> np.ndarray:
    """Sizing pass: BFS only, returns per-link subgraph node counts [L],
    by the device BFS, ``batch_size`` links at a time, sampled with
    ``link_seeds`` (default ``arange(L)``) as extraction samples. (The
    host-extract route of :func:`precompute_pos` sizes on the host.)"""
    L = links.shape[0]
    if link_seeds is None:
        link_seeds = np.arange(L, dtype=np.int32)
    out = np.empty(L, dtype=np.int32)
    with span("pos.device_bfs"):
        for start in range(0, L, batch_size):
            lb = torch.as_tensor(links[start : start + batch_size], device=dg.device)
            ls = torch.as_tensor(link_seeds[start : start + batch_size], device=dg.device)
            dist = _bfs_distances(dg, lb, num_hops, ratio_per_hop, max_nodes_per_hop, ls)
            out[start : start + len(lb)] = (dist != _UNREACHED).sum(dim=1).cpu().numpy()
    return out


def host_extract_route(dg: DeviceGraph, num_links: int, *, scaled: bool,
                       ratio_per_hop: float, max_nodes_per_hop: Optional[int]) -> bool:
    """Whether :func:`precompute_pos` builds node sets with the native host
    BFS (JAX pos.py:654-697): no ScaLed, no sampling, and
    ``S3GRL_TPU_HOST_EXTRACT`` = ``1``, or ``auto`` (the default) with
    ``L·E`` at least :data:`HOST_EXTRACT_MIN_LE`."""
    mode = os.environ.get("S3GRL_TPU_HOST_EXTRACT", "auto")
    return (
        not scaled
        and not samples(ratio_per_hop, max_nodes_per_hop)
        and mode != "0"
        and (mode == "1" or num_links * int(dg.edge_src.shape[0]) >= HOST_EXTRACT_MIN_LE)
    )


def local_table_route(bucket: int, table_width: int, *, sampled: bool = False) -> bool:
    """Whether a PoS bucket of BFS node sets takes the local-table route:
    never with per-hop sampling; else by ``S3GRL_TPU_LOCAL_TAB``: ``1``
    always, ``0`` never, ``auto`` (the default) where ``bucket`` is at most
    :data:`LOCAL_TAB_MAX_S_OVER_D` of the global table's width."""
    mode = os.environ.get("S3GRL_TPU_LOCAL_TAB", "auto")
    if sampled or mode == "0":
        return False
    return mode == "1" or bucket <= LOCAL_TAB_MAX_S_OVER_D * table_width


def _extract_and_operate(
    dg: DeviceGraph,
    links: torch.Tensor,  # [B, 2]
    link_seeds: torch.Tensor,  # [B]
    *,
    num_hops: int,
    max_nodes: int,
    ratio_per_hop: float,
    max_nodes_per_hop: Optional[int],
    sign_k: int,
    max_ccn: int,
    strategy: str,
    rw_m: int = 0,
    rw_M: int = 0,
    host_nodes: Optional[np.ndarray] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One link batch (JAX ``_extract_and_operate``): its node sets, by
    ScaLed's walks (``rw_m``/``rw_M``), the host BFS's table ``host_nodes``
    [B, S] (-1 on empty slots) or the device BFS, then their PoS(+)
    operators through ``pos_power_rows``, on the global table or, where
    :func:`local_table_route` takes it, on the local tables the card builds.
    Returns (xs [B, K+1, R, F+1], row_mask [B, R])."""
    dev = links.device
    if rw_m and rw_M:
        sub = extract_rw_subgraphs(dg, links, link_seeds, rw_m=rw_m, rw_M=rw_M,
                                   max_nodes=max_nodes)
        return pos_operators(sub, dg.x, sign_k=sign_k, max_ccn=max_ccn, strategy=strategy,
                             use_kernel=True)
    if host_nodes is not None:
        nodes = torch.as_tensor(np.where(host_nodes >= 0, host_nodes, 0), device=dev)
        node_mask = torch.as_tensor(host_nodes >= 0, device=dev)
    else:
        with span("pos.device_bfs"):
            nodes, node_mask, _, _ = extract_node_sets(
                dg, links, num_hops=num_hops, max_nodes=max_nodes, ratio_per_hop=ratio_per_hop,
                max_nodes_per_hop=max_nodes_per_hop, link_seeds=link_seeds,
            )
    if local_table_route(max_nodes, int(dg.nbr.shape[1]),
                         sampled=samples(ratio_per_hop, max_nodes_per_hop)):
        with span("pos.inputs"):
            sel_idx, loc, _, subg_x, row_mask = local_table_kernel_inputs(
                dg, links, nodes, node_mask, max_ccn=max_ccn, strategy=strategy
            )
        with span("pos.kernel"):
            xs = pos_power_rows(sel_idx, loc, None, subg_x, sign_k=sign_k)
        return xs * row_mask[:, None, :, None], row_mask
    return pos_operators_global(dg, links, nodes, node_mask, sign_k=sign_k, max_ccn=max_ccn,
                                strategy=strategy)


@dataclass
class PosPlan:
    """What :func:`precompute_pos` decides before its first batch: the CCN
    width, the dataset's storage tier, the batches (bucket, link indices
    into the split) and the node-set route. The same inputs give the same
    plan in every process, so the ranks of ``parallel/dist.py`` share it."""

    eff_ccn: int
    store_dtype: torch.dtype
    store_dev: torch.device
    batches: list  # [(bucket, int64 link indices)], in run order
    link_seeds: np.ndarray  # [L] int32
    host: bool  # node sets from the native host BFS
    nodes_all: Optional[np.ndarray]  # the whole split's host BFS table, or None
    extract_kw: dict  # the keywords of _extract_and_operate but max_nodes
    sizes: Optional[np.ndarray] = None  # [L] the sizes bucketed by; None for walks

    def route(self, dg: DeviceGraph, bucket: int) -> tuple[str, str]:
        """How a batch in ``bucket`` runs: its node sets (``host``,
        ``device`` or ``walks``) and the table the kernel reads (``global``,
        or ``local``: the local-table route's, or ScaLed's own)."""
        kw = self.extract_kw
        if kw["rw_m"] and kw["rw_M"]:
            return "walks", "local"
        local = local_table_route(int(bucket), int(dg.nbr.shape[1]),
                                  sampled=samples(kw["ratio_per_hop"], kw["max_nodes_per_hop"]))
        return "host" if self.host else "device", "local" if local else "global"

    def operate(self, dg: DeviceGraph, links: np.ndarray, bucket: int, idx: np.ndarray):
        """(xs, row_mask) of the links ``links[idx]`` in ``bucket``."""
        dev = dg.device
        host_nodes = None
        if self.host:
            if self.nodes_all is not None:
                host_nodes = self.nodes_all[idx, :bucket]
            else:
                with span("pos.host_bfs"):
                    host_nodes, _ = native.khop_nodes(*dg.host_csr(), links[idx],
                                                      self.extract_kw["num_hops"], int(bucket))
        return _extract_and_operate(
            dg, torch.as_tensor(links[idx], device=dev),
            torch.as_tensor(self.link_seeds[idx], device=dev),
            max_nodes=int(bucket), host_nodes=host_nodes, **self.extract_kw,
        )


def _storage_tier(L: int, sign_k: int, F: int, eff_ccn: int, dev: torch.device):
    """(CCN width, dtype, device) of the dataset (JAX pos.py:818-849): f32
    on the device, else bf16 on the device (storage only; compute stays
    f32), with the CCN pad halved down the power-of-two ladder first if even
    bf16 does not fit; f32 on the host at the full width if the halved bf16
    tier exceeds 2x budget. The budget is ``S3GRL_TPU_DEVICE_DS_BYTES``,
    read at each call, else :data:`DEVICE_DS_BYTES`."""
    budget = float(os.environ.get("S3GRL_TPU_DEVICE_DS_BYTES", DEVICE_DS_BYTES))

    def _est(r_ccn: int, bytes_per: int) -> int:
        return L * (sign_k + 1) * (2 + r_ccn) * (F + 1) * bytes_per

    eff_dev = eff_ccn
    while eff_dev > 2 and _est(eff_dev, 2) > budget:
        eff_dev //= 2
    if _est(eff_dev, 2) > 2 * budget:
        return eff_ccn, torch.float32, torch.device("cpu")
    if eff_dev < eff_ccn:
        warnings.warn(
            f"PoS+ CCN pad halved {eff_ccn} -> {eff_dev} to fit the device "
            f"dataset budget ({_est(eff_ccn, 2) / 1e9:.1f} GB bf16 at "
            f"R={2 + eff_ccn} > {budget / 1e9:.1f} GB for L={L}, "
            f"F={F}); densest links lose their furthest CCN rows.",
            stacklevel=3,
        )
    dtype = torch.float32 if _est(eff_dev, 4) <= budget else torch.bfloat16
    return eff_dev, dtype, dev


def subgraph_sizes(
    dg: DeviceGraph,
    links: np.ndarray,
    *,
    num_hops: int,
    ratio_per_hop: float = 1.0,
    max_nodes_per_hop: Optional[int] = None,
    batch_size: int = 256,
    max_subgraph_nodes: int = 1024,
    seed: int = 0,
    buckets=(32, 64, 128, 256, 512, 1024),
    rw_m: int = 0,
    rw_M: int = 0,
) -> np.ndarray:
    """The sizes :func:`precompute_pos` buckets ``links`` by, with the same
    keywords: ScaLed's one bucket, the host BFS's sizes on the host route,
    else the device BFS's (:func:`measure_subgraph_sizes`). The value of
    ``size_oracle`` that changes nothing."""
    sizes, _ = _sizes_and_table(
        dg, np.asarray(links, dtype=np.int32), num_hops=num_hops,
        ratio_per_hop=ratio_per_hop, max_nodes_per_hop=max_nodes_per_hop,
        batch_size=batch_size, max_subgraph_nodes=max_subgraph_nodes, seed=seed,
        buckets=_size_buckets(buckets, max_subgraph_nodes), rw_m=rw_m, rw_M=rw_M,
        table=False,
    )
    return sizes


def _sizes_and_table(dg, links, *, num_hops, ratio_per_hop, max_nodes_per_hop, batch_size,
                     max_subgraph_nodes, seed, buckets, rw_m, rw_M, table: bool):
    """(sizes [L], the host BFS's whole-split node table or None)."""
    L = links.shape[0]
    host = host_extract_route(dg, L, scaled=bool(rw_m and rw_M), ratio_per_hop=ratio_per_hop,
                              max_nodes_per_hop=max_nodes_per_hop)
    if rw_m and rw_M:
        bucket, _, _ = scaled_batch_plan(dg, L, rw_m=rw_m, rw_M=rw_M, seed=seed, eff_ccn=0,
                                         buckets=buckets, max_subgraph_nodes=max_subgraph_nodes,
                                         batch_size=batch_size)
        return np.full(L, bucket, dtype=np.int32), None
    if host and table and L * max_subgraph_nodes <= KHOP_TABLE_ENTRIES:
        # One host BFS pass over the whole split: its node prefix does not
        # depend on the cap, so slicing its table to a bucket's width equals
        # a call at that width. Its sizes are exact below the cap and at
        # least the cap where the BFS stopped early, so clamped they are the
        # bucketing oracle.
        with span("pos.host_bfs"):
            nodes_all, sizes = native.khop_nodes(*dg.host_csr(), links, num_hops,
                                                 max_subgraph_nodes)
        return np.minimum(sizes, max_subgraph_nodes), nodes_all
    if host:
        with span("pos.host_bfs"):
            return native.bfs_sizes(*dg.host_csr(), links, num_hops), None
    return measure_subgraph_sizes(
        dg, links, link_seeds_of(seed, L), num_hops=num_hops, ratio_per_hop=ratio_per_hop,
        max_nodes_per_hop=max_nodes_per_hop, batch_size=max(batch_size, 512),
    ), None


def pos_plan(
    dg: DeviceGraph,
    links: np.ndarray,  # [L, 2] int32
    *,
    num_hops: int,
    sign_k: int,
    k_heuristic: int = 0,
    k_node_set_strategy: str = "",
    max_ccn: int = 0,
    ratio_per_hop: float = 1.0,
    max_nodes_per_hop: Optional[int] = None,
    buckets=(32, 64, 128, 256, 512, 1024),
    batch_size: int = 256,
    max_subgraph_nodes: int = 1024,
    seed: int = 0,
    rw_m: int = 0,
    rw_M: int = 0,
    size_oracle: Optional[np.ndarray] = None,
    batch_multiple: int = 1,
) -> PosPlan:
    """:func:`precompute_pos`'s plan. ``size_oracle`` [L] gives the sizes
    to bucket by, and no sizing pass runs (the host route then runs the BFS
    batch by batch). With ``batch_multiple`` > 1 each bucket's batch cap is
    rounded up to a multiple of it (JAX pos.py:897-903), so that a mesh's
    ranks split every full batch evenly."""
    L = links.shape[0]
    eff_ccn = (
        padded_ccn_width(dg, links, k_node_set_strategy, max_ccn) if k_heuristic > 0 else 0
    )
    D_tab = int(dg.nbr.shape[1])
    F = int(dg.x.shape[1])
    eff_ccn, store_dtype, store_dev = _storage_tier(L, sign_k, F, eff_ccn, dg.device)

    buckets = _size_buckets(buckets, max_subgraph_nodes)
    host = host_extract_route(dg, L, scaled=bool(rw_m and rw_M), ratio_per_hop=ratio_per_hop,
                              max_nodes_per_hop=max_nodes_per_hop)
    nodes_all = None
    if size_oracle is not None:
        sizes = np.asarray(size_oracle)
        if sizes.shape != (L,):
            raise ValueError(f"size_oracle has shape {sizes.shape}, expected ({L},)")
    else:
        sizes, nodes_all = _sizes_and_table(
            dg, links, num_hops=num_hops, ratio_per_hop=ratio_per_hop,
            max_nodes_per_hop=max_nodes_per_hop, batch_size=batch_size,
            max_subgraph_nodes=max_subgraph_nodes, seed=seed, buckets=buckets,
            rw_m=rw_m, rw_M=rw_M, table=True,
        )
    order = np.argsort(sizes, kind="stable")
    bucket_of = np.array([pick_bucket(int(s), buckets) for s in sizes[order]])
    scaled = bool(rw_m and rw_M)
    sampled = samples(ratio_per_hop, max_nodes_per_hop)
    batches = []
    for bucket in np.unique(bucket_of):
        idx_all = order[bucket_of == bucket]
        # A local bucket's batch is sized by its tables' width, about
        # min(bucket, D_tab) (JAX pos.py:775-797).
        local = not scaled and local_table_route(int(bucket), D_tab, sampled=sampled)
        width = local_table_width(dg, int(bucket)) if local else D_tab
        cap = batch_cap(int(bucket), F, width, eff_ccn, batch_size)
        cap = -(-cap // batch_multiple) * batch_multiple
        batches += [(int(bucket), idx_all[start : start + cap])
                    for start in range(0, len(idx_all), cap)]
    return PosPlan(
        eff_ccn=eff_ccn, store_dtype=store_dtype, store_dev=store_dev, batches=batches,
        link_seeds=link_seeds_of(seed, L), host=host, nodes_all=nodes_all,
        extract_kw=dict(num_hops=num_hops, ratio_per_hop=ratio_per_hop,
                        max_nodes_per_hop=max_nodes_per_hop, sign_k=sign_k, max_ccn=eff_ccn,
                        strategy=k_node_set_strategy, rw_m=rw_m, rw_M=rw_M),
        sizes=None if scaled else sizes,
    )


def precompute_pos(
    dg: DeviceGraph,
    links: np.ndarray,  # [L, 2]
    y: np.ndarray,  # [L]
    *,
    num_hops: int,
    sign_k: int,
    k_heuristic: int = 0,
    k_node_set_strategy: str = "",
    max_ccn: int = 0,
    ratio_per_hop: float = 1.0,
    max_nodes_per_hop: Optional[int] = None,
    buckets=(32, 64, 128, 256, 512, 1024),
    batch_size: int = 256,
    max_subgraph_nodes: int = 1024,
    seed: int = 0,
    rw_m: int = 0,
    rw_M: int = 0,
    size_oracle: Optional[np.ndarray] = None,
    batch_multiple: int = 1,
    device="cuda",
) -> OperatorDataset:
    """Host driver: bucket links by subgraph size, run each batch on the
    device. ``dg`` must lie on ``device``.

    ``rw_m`` and ``rw_M`` both > 0 select ScaLed's random-walk subgraphs
    (``num_hops`` is then unused), batched by :func:`scaled_batch_plan`.
    Per-hop sampling draws from link i's seed ``seed * 1_000_003 + i``; on
    large graphs the node sets come from the native host BFS
    (:func:`host_extract_route`; the module docstring has the route).
    ``size_oracle`` and ``batch_multiple`` are :func:`pos_plan`'s;
    ``parallel/dist.precompute_pos_sharded`` runs the same plan, each rank
    its share of every batch.

    Spans (``profiling.span``): ``pos.precompute`` around the call,
    ``pos.plan`` around the plan and ``pos.batch/<nodes>/<table>/<S>``
    around each batch with its store (``PosPlan.route`` names the route).
    Counters (``profiling.count``), each batch: ``pos.batches``,
    ``pos.links``, the links by node sets (``pos.links.host_bfs``,
    ``pos.links.device_bfs``, ``pos.links.walks``) and by table
    (``pos.links.global_table``, ``pos.links.local_table``), and the
    kernel's subgraph slots, ``pos.slots_used`` (min(size, bucket) summed
    over the batch's links, from the plan's host-side sizes) against
    ``pos.slots`` (the bucket a link); ScaLed's walk batches, whose sizes
    the host does not know, count no slots.
    """
    from s3grl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dg.device != dev:
        raise ValueError(
            f"DeviceGraph lies on {dg.device}, precompute_pos asked for {dev}"
        )
    if dg.x is None:
        raise ValueError("PoS requires node features (reference parity)")
    with span("pos.precompute"):
        L = links.shape[0]
        links = np.asarray(links, dtype=np.int32)
        with span("pos.plan"):
            plan = pos_plan(
                dg, links, num_hops=num_hops, sign_k=sign_k, k_heuristic=k_heuristic,
                k_node_set_strategy=k_node_set_strategy, max_ccn=max_ccn,
                ratio_per_hop=ratio_per_hop, max_nodes_per_hop=max_nodes_per_hop,
                buckets=buckets, batch_size=batch_size, max_subgraph_nodes=max_subgraph_nodes,
                seed=seed, rw_m=rw_m, rw_M=rw_M, size_oracle=size_oracle,
                batch_multiple=batch_multiple,
            )
        F = int(dg.x.shape[1])
        xs_all = torch.zeros((L, sign_k + 1, 2 + plan.eff_ccn, F + 1), dtype=plan.store_dtype,
                             device=plan.store_dev)
        mask_all = torch.zeros((L, 2 + plan.eff_ccn), dtype=torch.bool, device=plan.store_dev)
        for bucket, idx in plan.batches:
            nodes, table = plan.route(dg, bucket)
            with span(f"pos.batch/{nodes}/{table}/{bucket}"):
                xs, row_mask = plan.operate(dg, links, bucket, idx)
                with span("pos.store"):
                    idx_t = torch.as_tensor(idx, device=plan.store_dev)
                    xs_all[idx_t] = xs.to(device=plan.store_dev, dtype=plan.store_dtype)
                    mask_all[idx_t] = row_mask.to(plan.store_dev)
            _count_batch(plan, nodes, table, bucket, idx)

    return OperatorDataset(
        xs=xs_all, row_mask=mask_all, y=np.asarray(y, dtype=np.float32)
    )


_NODE_COUNTERS = {"host": "pos.links.host_bfs", "device": "pos.links.device_bfs",
                  "walks": "pos.links.walks"}


def _count_batch(plan: PosPlan, nodes: str, table: str, bucket: int, idx: np.ndarray) -> None:
    """:func:`precompute_pos`' counters of one batch, from host numbers only."""
    n = len(idx)
    count("pos.batches")
    count("pos.links", n)
    count(_NODE_COUNTERS[nodes], n)
    count(f"pos.links.{table}_table", n)
    if plan.sizes is not None:
        count("pos.slots_used", int(np.minimum(plan.sizes[idx], bucket).sum()))
        count("pos.slots", int(bucket) * n)
