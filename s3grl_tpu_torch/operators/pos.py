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
   kernel ``ops/pos_kernel.pos_power_rows``: on BFS node sets it reads the
   graph's own neighbor table and features by node id and resolves
   subgraph membership from them, or, on the
   local-table route (below), runs in its local-slot mode (``row_ids=None``)
   on a table the card builds; on ScaLed's local tables it runs in that
   mode too, as the JAX package's ``use_pallas`` route does
   (pos.py:254-262).

The large-graph route (JAX pos.py:654-755, 1023-1060): where no ScaLed and
no sampling is asked and ``L·E`` reaches :data:`HOST_EXTRACT_MIN_LE` (1e8;
``S3GRL_TPU_HOST_EXTRACT`` = ``auto``, ``0`` or ``1`` overrides), the
threaded C++ BFS of ``native/graphcore.cpp`` builds the node sets on the
host, in the device BFS's order ((hop, node id), src and dst first), so the
dataset is the same bits. Where ``W = min(max_subgraph_nodes,
KHOP_TABLE_ENTRIES // L)`` reaches the smallest bucket, one pass over the
whole split at width W runs first: its sizes are the bucketing oracle
(exact below W; ``native.bfs_sizes`` sizes the links whose rows stopped at
a W below the cap), and a batch slices its node sets from its table where
the bucket is at most W or each of the batch's rows ended below W. Other
batches take a pass of their own, as every batch does, after
``native.bfs_sizes`` has sized the split, where W is below the smallest
bucket. Below the threshold everything runs on the device.

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
# ``S3GRL_TPU_DEVICE_DS_BYTES`` is unset and the dataset stays off a CUDA
# card, as in the JAX package (pos.py:818): the tiers change the dataset's
# dtype or CCN width, so the port reads the same variable with the same
# default to produce the same datasets.
DEVICE_DS_BYTES = 3.5e9
# With the variable unset, a dataset bound for a CUDA card may take this
# share of the card's memory instead (3.5e9 was sized for a TPU's). A
# quarter leaves the rest to what lives beside it: ``fit_signnet`` holds the
# train, valid and test datasets on the card at once (train is 85 % of the
# links), and ``precompute_pos`` the dataset beside each batch's transients
# (``ELEM_BUDGET`` float32 elements, 1 GB, each) and the graph. On an 80 GB
# card: 20 GB, so Cora's PoS+ train split (7.4 GB at R = 18) stays float32
# at its full CCN width.
CARD_DS_SHARE = 0.25
# f32 elements per transient [B, S, *] tensor, bounding the batch per bucket.
ELEM_BUDGET = 256_000_000
# The host-extract route's threshold on L·E, the JAX package's setting
# (pos.py:674-676).
HOST_EXTRACT_MIN_LE = 1e8
# The most int32 entries (~256 MB) of the host route's whole-split BFS
# table, as in the JAX package: the table is [L, W] with W =
# min(max_subgraph_nodes, KHOP_TABLE_ENTRIES // L), and the pass runs where
# W reaches the smallest bucket (module docstring). 0 leaves every batch to
# its own pass.
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
    targets' rows with the slots (span ``pos.ccn``). Invalid CCN slots point
    at row 0; the row mask zeroes them afterwards."""
    B, S = nodes.shape
    dev = nodes.device
    x_sub = x_global[nodes.long()] * node_mask[:, :, None].to(torch.float32)
    ind = torch.zeros((B, S, 1), dtype=torch.float32, device=dev)
    ind[:, :2] = 1.0  # the indicator column on the targets (tuned_SIGN.py:177)
    subg_x = torch.cat([ind, x_sub], dim=-1)  # [B, S, F+1]
    if max_ccn <= 0:
        sel_idx, row_mask = _ccn_select(None, None, node_mask, strategy, max_ccn, 2 + max_ccn)
        return sel_idx, nbr_local, nbr_w, subg_x, row_mask
    with span("pos.ccn"):
        w0, w1 = (None, None) if nbr_w is None else (nbr_w[:, 0], nbr_w[:, 1])
        nbr0 = _slot_neighbors(nbr_local[:, 0], w0, S)
        nbr1 = _slot_neighbors(nbr_local[:, 1], w1, S)
        sel_idx, row_mask = _ccn_select(nbr0, nbr1, node_mask, strategy, max_ccn, 2 + max_ccn)
    return sel_idx, nbr_local, nbr_w, subg_x, row_mask


def _count_inputs(by_id: bool, *built: Optional[torch.Tensor]) -> None:
    """One batch's ``pos.inputs`` counters, from shapes alone: whether its
    kernel read the graph by id (``pos.inputs.by_id``), and the bytes of the
    kernel inputs its route built for it on the card (``pos.inputs.bytes``).
    The kernel's own scratch is not an input and is not counted: its
    selector's list of resolved entries is sized by the table's padded
    width ([B, S, D] int2 where the selector is split, 755 MB at
    BlogCatalog's B = 8, S = 4,096, D = 2,880)."""
    count("pos.inputs.by_id", by_id)
    count("pos.inputs.bytes", sum(t.numel() * t.element_size() for t in built if t is not None))


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
    with span("pos.inputs"):
        sel_idx, nbr_local, nbr_w, subg_x, row_mask = local_kernel_inputs(
            sub, x_global, max_ccn=max_ccn, strategy=strategy
        )
        if use_kernel:
            _count_inputs(False, sel_idx, nbr_local, nbr_w, subg_x)
    if use_kernel:
        with span("pos.kernel"):
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

    No local-structure assembly and no per-batch copy of the graph: the
    kernel reads ``dg.nbr`` (up to each row's degree), ``dg.degrees()`` and
    ``dg.x_with_indicator()`` by node id and resolves subgraph membership
    from ``row_ids`` (global ids, -1 on empty slots); it drops the target
    link itself. Semantics match :func:`pos_operators` (binary
    sub-adjacency, target-link removal, CCN selection), and the bits those
    of the same kernel on :func:`global_kernel_inputs`' gathered arrays.
    Returns (xs [B, K+1, R, F+1] f32, row_mask [B, R]).
    """
    with span("pos.inputs"):
        sel_idx, row_ids, links, row_mask = by_id_kernel_inputs(
            dg, links, nodes, node_mask, max_ccn=max_ccn, strategy=strategy
        )
        _count_inputs(True, sel_idx, row_ids, links)
    with span("pos.kernel"):
        xs = pos_power_rows(sel_idx, dg.nbr, dg.degrees(), dg.x_with_indicator(),
                            sign_k=sign_k, row_ids=row_ids, links=links)
    return xs * row_mask[:, None, :, None], row_mask


def _target_rows_select(dg, links, nodes, node_mask, max_ccn, strategy):
    """(sel_idx [B, R] i32, row_mask [B, R] bool) of the global route, from
    the targets' link-removed rows [B, D] (utils.py:78-80) where CCN rows
    are asked for (span ``pos.ccn``)."""
    if max_ccn <= 0:
        return _ccn_select(None, None, node_mask, strategy, max_ccn, 2 + max_ccn)
    with span("pos.ccn"):
        nodes_l = nodes.long()
        gnbr0 = dg.nbr[nodes_l[:, 0]]  # [B, D] (slot 0 = src, slot 1 = dst)
        gnbr1 = dg.nbr[nodes_l[:, 1]]
        w0 = dg.nbr_mask[nodes_l[:, 0]] & (gnbr0 != links[:, 1:2])
        w1 = dg.nbr_mask[nodes_l[:, 1]] & (gnbr1 != links[:, 0:1])
        nbr0 = ((gnbr0[:, :, None] == nodes[:, None, :]) & w0[:, :, None]).any(1)
        nbr1 = ((gnbr1[:, :, None] == nodes[:, None, :]) & w1[:, :, None]).any(1)
        return _ccn_select(nbr0, nbr1, node_mask, strategy, max_ccn, 2 + max_ccn)


def by_id_kernel_inputs(
    dg: DeviceGraph,
    links: torch.Tensor,  # [B, 2]
    nodes: torch.Tensor,  # [B, S]
    node_mask: torch.Tensor,  # [B, S]
    *,
    max_ccn: int = 0,
    strategy: str = "",
):
    """The per-batch inputs of :func:`pos_operators_global`'s by-id call:
    (sel_idx [B, R] i32, row_ids [B, S] i32 (-1 on empty slots), links
    [B, 2] i32, row_mask [B, R] bool). The kernel takes the graph's arrays
    beside them."""
    sel_idx, row_mask = _target_rows_select(dg, links.long(), nodes, node_mask, max_ccn, strategy)
    row_ids = torch.where(node_mask, nodes, torch.full_like(nodes, -1))
    return (sel_idx, row_ids.to(torch.int32).contiguous(),
            links.to(torch.int32).contiguous(), row_mask)


def global_kernel_inputs(
    dg: DeviceGraph,
    links: torch.Tensor,  # [B, 2]
    nodes: torch.Tensor,  # [B, S]
    node_mask: torch.Tensor,  # [B, S]
    *,
    max_ccn: int = 0,
    strategy: str = "",
):
    """The global route's kernel inputs as gathered per-batch arrays:
    (sel_idx [B, R] i32, nbr [B, S, D] i32 global ids, w [B, S, D] f32,
    subg_x [B, S, F+1] f32, row_ids [B, S] i32, row_mask [B, R] bool). No
    route builds them: they are the plain version that the tests and
    ``chip_smoke.py`` hold :func:`pos_operators_global`'s by-id call
    against."""
    B, S = nodes.shape
    dev = nodes.device
    links = links.long()
    nodes_l = nodes.long()
    sel_idx, row_mask = _target_rows_select(dg, links, nodes, node_mask, max_ccn, strategy)

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


def ccn_counts(dg: DeviceGraph, links: np.ndarray, strategy: str) -> np.ndarray:
    """[L] each link's CCN count on the GLOBAL graph, the target link
    removed: |N(s) ∩ N(d)| (intersection) or |N(s) ∪ N(d)| without s and d
    (union). A subgraph's CCN set is a subset of the global one, and equal
    to it where the BFS keeps the targets' whole first hop."""
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
        return cn.astype(np.int64)
    # union: |N(s)| + |N(d)| - CN, minus the (removed) target edge
    deg = np.asarray(A.sum(axis=1)).ravel()
    has_edge = np.asarray(A[s, d]).ravel()
    return (deg[s] + deg[d] - cn - 2 * has_edge).astype(np.int64)


def measure_ccn_width(
    dg: DeviceGraph, links: np.ndarray, strategy: str, cap: int,
    counts: Optional[np.ndarray] = None,
) -> int:
    """Tight upper bound on CCN row count over ``links`` from the GLOBAL
    graph (:func:`ccn_counts`, or ``counts`` where the caller has them).

    The reference keeps exactly |CCN| rows per link (tuned_SIGN.py:238); the
    fixed-shape analog sizes R to the measured max, capped at ``cap``, or,
    with :data:`CCN_PAD_PCT` below 100, to that percentile of the counts
    (JAX pos.py:543-573). A width below the measured max warns "CCN width
    capped", in the JAX package's words.
    """
    if counts is None:
        counts = ccn_counts(dg, links, strategy)
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


def padded_ccn_width(dg: DeviceGraph, links: np.ndarray, strategy: str, max_ccn: int,
                     counts: Optional[np.ndarray] = None) -> int:
    """PoS+'s CCN row count for ``links``: the measured width (cap
    ``max_ccn``, 16 where it is not positive), rounded up to a power of two
    (capped) as the JAX package rounds it; the dataset's shape follows it.
    ``counts``: :func:`ccn_counts`' where the caller has them."""
    if max_ccn <= 0:
        max_ccn = 16
    eff_ccn = measure_ccn_width(dg, links, strategy, max_ccn, counts)
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
    walk_sums: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One link batch (JAX ``_extract_and_operate``): its node sets, by
    ScaLed's walks (``rw_m``/``rw_M``), the host BFS's table ``host_nodes``
    [B, S] (-1 on empty slots) or the device BFS, then their PoS(+)
    operators through ``pos_power_rows``, on the global table or, where
    :func:`local_table_route` takes it, on the local tables the card builds.
    A walk batch adds to ``walk_sums`` [3] int64 on the card, where given,
    its links' filled slots (min(members, S)), kept CCN rows and the members
    that the bucket leaves out of its slots.
    Returns (xs [B, K+1, R, F+1], row_mask [B, R])."""
    dev = links.device
    if rw_m and rw_M:
        with span("pos.walks"):
            sub = extract_rw_subgraphs(dg, links, link_seeds, rw_m=rw_m, rw_M=rw_M,
                                       max_nodes=max_nodes)
        xs, row_mask = pos_operators(sub, dg.x, sign_k=sign_k, max_ccn=max_ccn,
                                     strategy=strategy, use_kernel=True)
        if walk_sums is not None:
            # Summed on the card; precompute_pos reads them once a call. The
            # 2M walks visit at most 2 + 2·M·m nodes, so only a bucket below
            # that can leave members out.
            sums = [sub.node_mask.sum(), row_mask[:, 2:].sum()]
            if max_nodes < 2 + 2 * rw_M * rw_m:
                sums.append(sub.sub_size.sum() - sums[0])
            walk_sums[:len(sums)] += torch.stack(sums)
        return xs, row_mask
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
            _count_inputs(False, sel_idx, loc, subg_x)
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
    store_tier: str = "f32"  # the storage tier's name: f32, bf16 or host
    ccn_counts: Optional[np.ndarray] = None  # [L] ccn_counts' where CCN rows are kept

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

    def reads_table(self, bucket: int, idx: np.ndarray) -> bool:
        """Whether the links ``idx`` in ``bucket`` take their node sets from
        the plan's host table: the bucket is at most its width W, or each of
        their rows ended below W and so holds the whole subgraph."""
        if self.nodes_all is None:
            return False
        width = self.nodes_all.shape[1]
        return bucket <= width or bool((self.sizes[idx] < width).all())

    def operate(self, dg: DeviceGraph, links: np.ndarray, bucket: int, idx: np.ndarray,
                walk_sums: Optional[torch.Tensor] = None):
        """(xs, row_mask) of the links ``links[idx]`` in ``bucket``;
        ``walk_sums`` is :func:`_extract_and_operate`'s."""
        dev = dg.device
        host_nodes = None
        if self.host:
            if self.reads_table(bucket, idx):
                host_nodes = self.nodes_all[idx, :bucket]
                pad = bucket - host_nodes.shape[1]
                if pad > 0:
                    host_nodes = np.pad(host_nodes, ((0, 0), (0, pad)), constant_values=-1)
            else:
                with span("pos.host_bfs"):
                    host_nodes, _ = native.khop_nodes(*dg.host_csr(), links[idx],
                                                      self.extract_kw["num_hops"], int(bucket))
        return _extract_and_operate(
            dg, torch.as_tensor(links[idx], device=dev),
            torch.as_tensor(self.link_seeds[idx], device=dev),
            max_nodes=int(bucket), host_nodes=host_nodes, walk_sums=walk_sums,
            **self.extract_kw,
        )


def _storage_tier(L: int, sign_k: int, F: int, eff_ccn: int, dev: torch.device):
    """(CCN width, dtype, device) of the dataset: :func:`_storage_plan`'s
    without the tier's name."""
    return _storage_plan(L, sign_k, F, eff_ccn, dev)[:3]


def _storage_plan(L: int, sign_k: int, F: int, eff_ccn: int, dev: torch.device):
    """(CCN width, dtype, device, tier) of the dataset (JAX pos.py:818-849):
    ``f32`` on the device, else ``bf16`` on the device (storage only;
    compute stays f32), with the CCN pad halved down the power-of-two ladder
    first if even bf16 does not fit; ``host``, f32 at the full width, if the
    halved bf16 tier exceeds 2x budget. The budget is
    ``S3GRL_TPU_DEVICE_DS_BYTES``, read at each call; unset,
    :data:`CARD_DS_SHARE` of the card's memory where ``dev`` is a CUDA card,
    else :data:`DEVICE_DS_BYTES`."""
    var = os.environ.get("S3GRL_TPU_DEVICE_DS_BYTES")
    if var is not None:
        budget = float(var)
    elif dev.type == "cuda":
        budget = CARD_DS_SHARE * torch.cuda.get_device_properties(dev).total_memory
    else:
        budget = DEVICE_DS_BYTES

    def _est(r_ccn: int, bytes_per: int) -> int:
        return L * (sign_k + 1) * (2 + r_ccn) * (F + 1) * bytes_per

    eff_dev = eff_ccn
    while eff_dev > 2 and _est(eff_dev, 2) > budget:
        eff_dev //= 2
    if _est(eff_dev, 2) > 2 * budget:
        return eff_ccn, torch.float32, torch.device("cpu"), "host"
    if eff_dev < eff_ccn:
        warnings.warn(
            f"PoS+ CCN pad halved {eff_ccn} -> {eff_dev} to fit the device "
            f"dataset budget ({_est(eff_ccn, 2) / 1e9:.1f} GB bf16 at "
            f"R={2 + eff_ccn} > {budget / 1e9:.1f} GB for L={L}, "
            f"F={F}); densest links lose their furthest CCN rows.",
            stacklevel=3,
        )
    if _est(eff_dev, 4) <= budget:
        return eff_dev, torch.float32, dev, "f32"
    return eff_dev, torch.bfloat16, dev, "bf16"


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
    width = min(max_subgraph_nodes, int(KHOP_TABLE_ENTRIES // max(L, 1)))
    if host and table and width >= buckets[0]:
        # One host BFS pass over the whole split at the widest table the
        # entry budget allows: its node prefix does not depend on the cap,
        # so slicing a row to a bucket's width equals a call at that width.
        # Its sizes are exact below the width and at least the width where
        # the BFS stopped early; below the cap those links alone are sized
        # by a full pass. Clamped, they are the bucketing oracle.
        with span("pos.host_bfs"):
            nodes_all, sizes = native.khop_nodes(*dg.host_csr(), links, num_hops, width)
            cut = np.flatnonzero(sizes >= width) if width < max_subgraph_nodes else []
            if len(cut):
                sizes[cut] = native.bfs_sizes(*dg.host_csr(), links[cut], num_hops)
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
    eff_ccn, counts = 0, None
    if k_heuristic > 0:
        with span("pos.ccn_width"):
            counts = ccn_counts(dg, links, k_node_set_strategy)
            eff_ccn = padded_ccn_width(dg, links, k_node_set_strategy, max_ccn, counts)
    D_tab = int(dg.nbr.shape[1])
    F = int(dg.x.shape[1])
    eff_ccn, store_dtype, store_dev, tier = _storage_plan(L, sign_k, F, eff_ccn, dg.device)

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
        sizes=None if scaled else sizes, store_tier=tier, ccn_counts=counts,
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
    ``pos.plan`` around the plan, ``pos.ccn_width`` in it around PoS+'s
    CCN counts and width (:func:`ccn_counts`, :func:`padded_ccn_width`),
    ``pos.batch/<nodes>/<table>/<S>`` around each batch with its store
    (``PosPlan.route`` names the route), in it ``pos.walks`` around a walk
    batch's extraction (``extract_rw_subgraphs``: uniforms, steps, the
    [B, N] membership mask, node-set selection and the gathered local
    structure), ``pos.inputs`` around the kernel inputs' build and
    ``pos.kernel`` around ``pos_power_rows`` on every route, and ``pos.ccn``
    around a batch's CCN selection (in ``pos.inputs``). Counters
    (``profiling.count``), each call: the storage tier, ``pos.store.f32``,
    ``pos.store.bf16`` or ``pos.store.host`` (:func:`_storage_plan`). Each
    batch: ``pos.batches``,
    ``pos.links``, the links by node sets (``pos.links.host_bfs``,
    ``pos.links.device_bfs``, ``pos.links.walks``), the host batches' links
    sliced from the plan's host table (``pos.links.host_table``; 0 for a
    host batch that ran its own pass) and by table
    (``pos.links.global_table``, ``pos.links.local_table``), the batches
    whose kernel read the graph by id (``pos.inputs.by_id``: the global
    table's) and the bytes of the kernel inputs built for them on the card
    (``pos.inputs.bytes``; :func:`_count_inputs`), and the
    kernel's subgraph slots, ``pos.slots_used`` (min(size, bucket) summed
    over the batch's links, from the plan's host-side sizes) against
    ``pos.slots`` (the bucket a link), and where CCN rows are kept
    ``pos.ccn.rows`` (min(count, CCN width) summed over the batch's links,
    from the plan's :func:`ccn_counts`: exact where the BFS keeps the
    targets' whole first hop) against ``pos.ccn.slots`` (the CCN width a
    link). ScaLed's walk batches keep their sizes on the card: their
    ``pos.slots_used`` (min(members, bucket)), ``pos.ccn.rows`` (the CCN rows
    kept) and ``pos.walks.members`` (the walks' distinct nodes: the filled
    slots, plus what a bucket below 2 + 2·M·m leaves out) are summed there
    across the call and read once at its end
    (:func:`read_walk_sums`), never a batch; ``pos.walks.mask_entries``
    counts each batch's membership mask, B·N, from shapes on the host.
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
        count(f"pos.store.{plan.store_tier}")
        F = int(dg.x.shape[1])
        xs_all = torch.zeros((L, sign_k + 1, 2 + plan.eff_ccn, F + 1), dtype=plan.store_dtype,
                             device=plan.store_dev)
        mask_all = torch.zeros((L, 2 + plan.eff_ccn), dtype=torch.bool, device=plan.store_dev)
        walks = bool(plan.extract_kw["rw_m"] and plan.extract_kw["rw_M"])
        walk_sums = torch.zeros(3, dtype=torch.int64, device=dev) if walks else None
        for bucket, idx in plan.batches:
            nodes, table = plan.route(dg, bucket)
            with span(f"pos.batch/{nodes}/{table}/{bucket}"):
                xs, row_mask = plan.operate(dg, links, bucket, idx, walk_sums)
                with span("pos.store"):
                    idx_t = torch.as_tensor(idx, device=plan.store_dev)
                    xs_all[idx_t] = xs.to(device=plan.store_dev, dtype=plan.store_dtype)
                    mask_all[idx_t] = row_mask.to(plan.store_dev)
            _count_batch(plan, nodes, table, bucket, idx, dg.num_nodes)
        if walks and plan.batches:
            _count_walk_sums(plan, read_walk_sums(walk_sums))

    return OperatorDataset(
        xs=xs_all, row_mask=mask_all, y=np.asarray(y, dtype=np.float32)
    )


_NODE_COUNTERS = {"host": "pos.links.host_bfs", "device": "pos.links.device_bfs",
                  "walks": "pos.links.walks"}


def _count_batch(plan: PosPlan, nodes: str, table: str, bucket: int, idx: np.ndarray,
                 num_nodes: int) -> None:
    """:func:`precompute_pos`' counters of one batch, from host numbers only.
    A walk batch's filled slots and CCN rows lie on the card: the call adds
    them once at its end (:func:`_count_walk_sums`)."""
    n = len(idx)
    count("pos.batches")
    count("pos.links", n)
    count(_NODE_COUNTERS[nodes], n)
    if nodes == "host":
        count("pos.links.host_table", n if plan.reads_table(bucket, idx) else 0)
    count(f"pos.links.{table}_table", n)
    count("pos.slots", int(bucket) * n)
    if plan.ccn_counts is not None:
        count("pos.ccn.slots", plan.eff_ccn * n)
    if nodes == "walks":
        count("pos.walks.mask_entries", n * num_nodes)  # the batch's [B, N] membership mask
        return
    count("pos.slots_used", int(np.minimum(plan.sizes[idx], bucket).sum()))
    if plan.ccn_counts is not None:
        count("pos.ccn.rows", int(np.minimum(plan.ccn_counts[idx], plan.eff_ccn).sum()))


def read_walk_sums(walk_sums: torch.Tensor) -> list:
    """The card's walk sums on the host: a call's one read of them."""
    return walk_sums.tolist()


def _count_walk_sums(plan: PosPlan, sums: list) -> None:
    """The walk batches' card-side counters of one call (:func:`read_walk_sums`)."""
    slots_used, ccn_rows, left_out = sums
    count("pos.slots_used", slots_used)
    count("pos.walks.members", slots_used + left_out)
    if plan.ccn_counts is not None:
        count("pos.ccn.rows", ccn_rows)
