"""Multi-device precompute: link-sharded PoS and SoP, and the
row-partitioned SoP power chain, over ``torch.distributed``.

Port of ``s3grl_tpu/parallel/dist.py``. Each rank is a process holding the
whole graph; the ``data`` dim of the mesh (``parallel/mesh.py``) splits
the work.

- **Row-partitioned chain** (:func:`dist_power_chain`): ``Y_k = Â Y_{k-1}``
  with node rows partitioned over ``data``. Each rank owns ``rows =
  ⌈N/n⌉`` rows and their incoming edges (:func:`partition_edges_by_owner`),
  as a ``[rows, N_pad]`` CSR built once on the host (``csr_matrix``, the
  form one process's chain reads too).
  Each power all-gathers the previous power's shards into ``[N_pad, F]``
  (the boundary exchange) and multiplies by ``bsr_spmm`` on the shard. X
  is on every rank, so the first power needs no gather.
- **Link-sharded PoS** (:func:`precompute_pos_sharded`): every rank makes
  the plan ``precompute_pos`` makes (rank 0 sizes the split and
  broadcasts the sizes), runs its contiguous share of every batch into
  the plan's storage tier, and the finished rows move to their owners
  once, at the end, by ``all_to_all`` (:func:`_to_owners`): rank r holds
  links ``[r·⌈L/n⌉, (r+1)·⌈L/n⌉)`` (JAX's ``P('data')`` layout).
- **SoP** (:func:`precompute_sop_sharded`): the distributed chain, gathered
  once; then each rank runs ``_sop_batch`` over its share of every batch,
  in the same layout.

A link's rows do not depend on the batch it ran in (the subgraph kernel
works per subgraph, the propagation per column, and the chain's CSR walk
adds a row's nonzeros in one order), so on the card these equal the
single-process datasets and chain bit for bit.

A rank holds its own rows and the rows it ran, about 2·L/n links, never
the whole dataset: the exchange sends each row only to its owner, in
rounds of at most ``EXCHANGE_BYTES`` through the mesh's device (a host-tier
dataset stays on the host between rounds). The JAX package's
``x_override`` has no caller and is left out, as in ``operators/sop.py``.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch
import torch.distributed as dist

from s3grl_tpu_torch.operators.common import OperatorDataset
from s3grl_tpu_torch.operators.pos import pos_plan, subgraph_sizes
from s3grl_tpu_torch.operators.sop import (
    _sop_batch,
    host_normalized_edges,
    sop_batch_size,
    sop_route,
)
from s3grl_tpu_torch.ops.spmm_kernel import CsrMatrix, bsr_spmm, csr_matrix
from s3grl_tpu_torch.parallel.mesh import data_group, mesh_device, share
from s3grl_tpu_torch.sampling.extraction import DeviceGraph

# torch 2.13 renames all_gather_into_tensor; both take (out, in, group).
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

# The most one round of the owners' exchange sends from a rank.
EXCHANGE_BYTES = 1 << 28


def _data_coords(mesh) -> tuple[int, int]:
    """(n, r): the size of ``data`` and this rank's place on it."""
    return mesh.size(0), mesh.get_local_rank("data")


# --------------------------------------------------------------------------
# Row-partitioned SoP power chain
# --------------------------------------------------------------------------


def partition_edges_by_owner(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_weight: np.ndarray,
    num_nodes: int,
    n_shards: int,
):
    """Group edges by the shard that owns their destination row.

    Returns (src [n, Emax] global ids, dst_local [n, Emax] owner-local rows,
    w [n, Emax] zero-padded, rows_per_shard). Padding edges carry w=0 so the
    scatter-add is a no-op for them. (A copy of the JAX package's numpy
    function; a test pins it to the original.)
    """
    rows = -(-num_nodes // n_shards)  # rows per shard (last shard padded)
    owner = np.asarray(edge_dst) // rows
    order = np.argsort(owner, kind="stable")
    src_s = np.asarray(edge_src)[order]
    dst_s = np.asarray(edge_dst)[order]
    w_s = np.asarray(edge_weight)[order]
    own_s = owner[order]
    counts = np.bincount(own_s, minlength=n_shards)
    e_max = max(int(counts.max()), 1)

    src_p = np.zeros((n_shards, e_max), np.int32)
    dstl_p = np.zeros((n_shards, e_max), np.int32)
    w_p = np.zeros((n_shards, e_max), np.float32)
    start = 0
    for s in range(n_shards):
        c = counts[s]
        src_p[s, :c] = src_s[start : start + c]
        dstl_p[s, :c] = dst_s[start : start + c] - s * rows
        w_p[s, :c] = w_s[start : start + c]
        start += c
    return src_p, dstl_p, w_p, rows


def shard_adjacency(mesh, edge_src, edge_dst, edge_weight, num_nodes: int) -> CsrMatrix:
    """This rank's rows of M (``M[dst, src] = w``) as a ``[rows, n·rows]``
    :class:`CsrMatrix` on the mesh's device: its incoming edges by
    :func:`partition_edges_by_owner`, the padding edges dropped."""
    n, r = _data_coords(mesh)
    src_p, dstl_p, w_p, rows = partition_edges_by_owner(
        edge_src, edge_dst, edge_weight, num_nodes, n)
    keep = w_p[r] != 0
    return csr_matrix(src_p[r][keep], dstl_p[r][keep], w_p[r][keep], rows, rows * n,
                      device=mesh_device(mesh))


def dist_power_chain(
    mesh,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_weight: np.ndarray,
    x: torch.Tensor,  # [N, F] on every rank
    sign_k: int,
) -> torch.Tensor:
    """This rank's rows of [Â X, ..., Â^K X]: [K, rows, F], rows ``[r·rows,
    (r+1)·rows)`` of the node range padded to ``n·rows`` (zero rows past N).
    :func:`gather_rows` assembles [K, N, F]."""
    n, r = _data_coords(mesh)
    N, F = int(x.shape[0]), int(x.shape[1])
    adj = shard_adjacency(mesh, edge_src, edge_dst, edge_weight, N)
    rows = adj.num_nodes
    y_full = torch.zeros((rows * n, F), dtype=torch.float32, device=x.device)
    y_full[:N] = x
    group = data_group(mesh)
    ys = []
    for k in range(sign_k):
        if k:
            y_full = torch.empty((rows * n, F), dtype=torch.float32, device=x.device)
            _all_gather_flat(y_full, ys[-1], group=group)
        ys.append(bsr_spmm(adj, y_full))
    return torch.stack(ys, dim=0)


def gather_rows(mesh, ys_shard: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """[K, N, F] on every rank from each rank's [K, rows, F] shard."""
    n, _ = _data_coords(mesh)
    K, rows, F = ys_shard.shape
    out = torch.empty((n * K, rows, F), dtype=ys_shard.dtype, device=ys_shard.device)
    _all_gather_flat(out, ys_shard.contiguous(), group=data_group(mesh))
    return out.view(n, K, rows, F).permute(1, 0, 2, 3).reshape(K, n * rows, F)[:, :num_nodes]


# --------------------------------------------------------------------------
# Link-sharded datasets
# --------------------------------------------------------------------------


def _gather_padded(mesh, a: torch.Tensor, rows: int) -> torch.Tensor:
    """[n·rows, ...]: every rank's ``a`` (at most ``rows`` rows) padded to
    ``rows`` with zeros, all-gathered over ``data`` on the mesh's device."""
    n, _ = _data_coords(mesh)
    dtype = a.dtype
    a = a.to(mesh_device(mesh))
    if dtype == torch.bool:  # collectives take bytes, not bools
        a = a.to(torch.uint8)
    padded = torch.zeros((rows, *a.shape[1:]), dtype=a.dtype, device=a.device)
    padded[: len(a)] = a
    out = torch.empty((n * rows, *a.shape[1:]), dtype=a.dtype, device=a.device)
    _all_gather_flat(out, padded, group=data_group(mesh))
    return out.to(dtype)


def _as_rows_of_bytes(a: torch.Tensor) -> torch.Tensor:
    """[m, bytes of a row] uint8 view of ``a`` (collectives take bytes, of
    any dtype)."""
    return a.contiguous().view(len(a), int(np.prod(a.shape[1:]))).view(torch.uint8)


def _to_owners(mesh, runs: list, local: torch.Tensor, num_links: int) -> torch.Tensor:
    """Move finished rows to the ranks that own them: ``runs[s]`` are the
    link ids rank s ran, in order (every rank knows every run, since the
    plan is shared), ``local`` this rank's rows of them. Returns this
    rank's rows of links ``share(num_links)``, in link order, on
    ``local``'s device.

    Each row goes only to its owner, by ``all_to_all_single`` on the mesh's
    device; every rank derives every send and receive count from ``runs``,
    so no count is exchanged. A round sends at most ``EXCHANGE_BYTES`` from
    a rank (rows per peer capped alike), so the device holds one round."""
    n, r = _data_coords(mesh)
    c = -(-num_links // n)
    lo, hi = share(num_links, n, r)
    store, comm = local.device, mesh_device(mesh)
    row_shape, dtype = local.shape[1:], local.dtype
    src_bytes = _as_rows_of_bytes(local)
    row_bytes = int(src_bytes.shape[1])
    out = torch.empty((hi - lo, row_bytes), dtype=torch.uint8, device=store)
    owner = [np.asarray(run, dtype=np.int64) // c for run in runs]
    counts = np.array([np.bincount(o, minlength=n) for o in owner])  # [from, to]
    send = [np.flatnonzero(owner[r] == d) for d in range(n)]  # my rows, by owner
    recv = [np.asarray(runs[s], dtype=np.int64)[owner[s] == r] - lo for s in range(n)]
    per_peer = max(1, EXCHANGE_BYTES // max(1, n * row_bytes))
    group = data_group(mesh)
    for t in range(-(-int(counts.max(initial=0)) // per_peer)):
        take = [rows[t * per_peer : (t + 1) * per_peer] for rows in send]
        into = [pos[t * per_peer : (t + 1) * per_peer] for pos in recv]
        pick = torch.as_tensor(np.concatenate(take), device=store)
        inp = src_bytes[pick].to(comm)
        got = torch.empty((sum(map(len, into)), row_bytes), dtype=torch.uint8, device=comm)
        dist.all_to_all_single(got, inp, [len(p) for p in into], [len(p) for p in take],
                               group=group)
        out[torch.as_tensor(np.concatenate(into), device=store)] = got.to(store)
    return out.view(dtype).view(hi - lo, *row_shape)


def gather_dataset(mesh, ds: OperatorDataset, num_links: int) -> OperatorDataset:
    """The whole dataset on every rank, from each rank's link shard in the
    ``share`` layout (for tests and evaluation)."""
    n, _ = _data_coords(mesh)
    c = -(-num_links // n)
    xs, mask, y = (_gather_padded(mesh, torch.as_tensor(a), c)[:num_links] for a in (
        ds.xs, ds.row_mask, np.asarray(ds.y, dtype=np.float32)))
    return OperatorDataset(xs=xs, row_mask=mask, y=y.cpu().numpy())


_SIZE_KEYS = set(inspect.signature(subgraph_sizes).parameters) - {"dg", "links"}


def shared_sizes(mesh, dg: DeviceGraph, links: np.ndarray, **pos_kwargs) -> np.ndarray:
    """``precompute_pos``'s subgraph sizes of ``links``, computed on rank 0
    (:func:`~s3grl_tpu_torch.operators.pos.subgraph_sizes`) and broadcast
    to every rank, the ``size_oracle`` of the shared plan."""
    dev = mesh_device(mesh)
    sizes = torch.empty(len(links), dtype=torch.int64, device=dev)
    if dist.get_rank() == 0:
        kw = {k: v for k, v in pos_kwargs.items() if k in _SIZE_KEYS}
        sizes.copy_(torch.as_tensor(subgraph_sizes(dg, links, **kw)))
    dist.broadcast(sizes, src=0)
    return sizes.cpu().numpy()


def precompute_pos_sharded(
    mesh,
    dg: DeviceGraph,
    links: np.ndarray,
    y: np.ndarray,
    *,
    size_oracle: np.ndarray | None = None,
    **pos_kwargs,
) -> OperatorDataset:
    """Link-sharded PoS precompute over ``data``: ``precompute_pos``'s
    plan (batch size at least 8 per rank and every full batch a multiple of
    the ranks, as in the JAX package), each rank its contiguous share of
    every batch (``share``; a remainder batch's shares are uneven) into the
    plan's storage tier, the rows moved to their owners once at the end
    (:func:`_to_owners`). Returns this rank's links ``share(L)``
    (``parallel/mesh.share``), their rows and labels, in that tier; ``dg``
    lies on the mesh's device on every rank. ``pos_kwargs`` are
    ``precompute_pos``'s (not ``device``)."""
    n, r = _data_coords(mesh)
    L = links.shape[0]
    links = np.asarray(links, dtype=np.int32)
    kw = dict(pos_kwargs)
    kw["batch_size"] = max(int(kw.get("batch_size", 256)), 8 * n)
    if size_oracle is None:
        size_oracle = shared_sizes(mesh, dg, links, **kw)
    plan = pos_plan(dg, links, size_oracle=size_oracle, batch_multiple=n, **kw)
    runs = [[idx[slice(*share(len(idx), n, s))] for _, idx in plan.batches] for s in range(n)]
    runs = [np.concatenate(run) if run else np.zeros(0, np.int64) for run in runs]
    R, F = 2 + plan.eff_ccn, int(dg.x.shape[1])
    xs_loc = torch.zeros((len(runs[r]), int(kw["sign_k"]) + 1, R, F + 1),
                         dtype=plan.store_dtype, device=plan.store_dev)
    mask_loc = torch.zeros((len(runs[r]), R), dtype=torch.bool, device=plan.store_dev)
    at = 0
    for bucket, idx in plan.batches:
        mine = idx[slice(*share(len(idx), n, r))]
        if len(mine):
            xs, row_mask = plan.operate(dg, links, bucket, mine)
            xs_loc[at : at + len(mine)] = xs.to(device=plan.store_dev, dtype=plan.store_dtype)
            mask_loc[at : at + len(mine)] = row_mask.to(plan.store_dev)
            at += len(mine)
    xs_own = _to_owners(mesh, runs, xs_loc, L)
    del xs_loc
    lo, hi = share(L, n, r)
    return OperatorDataset(xs=xs_own, row_mask=_to_owners(mesh, runs, mask_loc, L),
                           y=np.asarray(y, dtype=np.float32)[lo:hi])


def precompute_sop_sharded(
    mesh,
    dg: DeviceGraph,
    links: np.ndarray,
    y: np.ndarray,
    *,
    sign_k: int,
) -> OperatorDataset:
    """SoP precompute with the global chain row-partitioned over ``data``
    (:func:`dist_power_chain`, gathered once) and the per-link assembly
    (``operators/sop._sop_batch``) link-sharded: each rank runs its share
    of every batch (the batch ``sop_batch_size`` rounded down to a multiple
    of the ranks, at least 8 each), propagating over the replicated square
    Â by ``precompute_sop``'s route. Returns this rank's links
    ``share(L)``, as :func:`precompute_pos_sharded` does."""
    if dg.x is None:
        raise ValueError("SoP requires node features")
    n, r = _data_coords(mesh)
    N = dg.num_nodes
    F = int(dg.x.shape[1])
    L = links.shape[0]
    links = np.asarray(links, dtype=np.int64)
    src_h, dst_h, norm_w_h = host_normalized_edges(dg)
    ys = gather_rows(mesh, dist_power_chain(mesh, src_h, dst_h, norm_w_h, dg.x, sign_k), N)
    propagate, _ = sop_route(dg, norm_w_h)

    batch = max(sop_batch_size(N, int(dg.edge_src.shape[0])) // n, 8) * n
    runs = [[] for _ in range(n)]
    parts = []
    for start in range(0, L, batch):
        b = min(batch, L - start)
        for s in range(n):
            lo, hi = share(b, n, s)
            runs[s].append(np.arange(start + lo, start + hi))
        mine = runs[r][-1]
        if len(mine):
            lb = torch.as_tensor(links[mine], device=dg.device)
            parts.append(_sop_batch(propagate, dg.x, ys, lb, sign_k=sign_k, num_nodes=N))
    runs = [np.concatenate(run) for run in runs]
    xs_loc = (torch.cat(parts) if parts else
              torch.zeros((0, sign_k + 1, 2, F + 1), dtype=torch.float32, device=dg.device))
    xs_own = _to_owners(mesh, runs, xs_loc, L)
    lo, hi = share(L, n, r)
    return OperatorDataset(
        xs=xs_own, row_mask=torch.ones((hi - lo, 2), dtype=torch.bool, device=xs_own.device),
        y=np.asarray(y, dtype=np.float32)[lo:hi],
    )
