"""Sparse SpMM for the SoP chain: the CUDA kernel's wrapper and its plain
torch versions.

``bsr_spmm`` replaces ``s3grl_tpu/ops/spmm_pallas.py::_bsr_spmm_padded``
(through its wrappers ``bsr_spmm`` and ``power_chain``): ``Y = M @ X`` for
M built once per graph on the host by :func:`blockify`, ``M[dst, src] = w``.
``blockify`` keeps the JAX package's 128×128 block-sparse (BSR) layout and
also reads the CSR form of the same M out of those blocks; the kernel walks
the CSR nonzeros. The route selector :func:`should_use_bsr` picks between
this and the edge-list route (``ops/spmm.spmm``) from the graph's shape.

On CPU tensors the wrapper runs ``bsr_spmm_reference`` (the dense blocks);
on CUDA tensors it launches the kernel (``csrc/bsr_spmm.cu``) or raises.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from s3grl_tpu_torch.ops import _build

BLOCK_SIZE = 128
BUDGET_BYTES = 1 << 30  # the most the dense blocks may take
# The BSR route is taken when its modelled bytes are under this share of
# the edge-list route's. 1.0 is the plain traffic model, not yet fitted to
# the card's times.
BSR_BYTES_FACTOR = 1.0


@dataclass(frozen=True)
class BlockedAdjacency:
    """A sparse matrix M in BSR form (dense nonzero blocks + block coords)
    and in CSR form, both on one device.

    Blocks are sorted by (row_block, col_block); every row block appears at
    least once (empty row blocks carry an explicit zero block), as in the
    JAX package. ``row_ptr[r] .. row_ptr[r + 1]`` are row block r's blocks.
    The CSR fields hold the nonzero entries of those blocks in rows and
    columns below ``num_nodes``, sorted by (row, column): row i's are
    ``csr_row_ptr[i] .. csr_row_ptr[i + 1]``.
    """

    blocks: torch.Tensor  # [NB, BS, BS] float32
    block_rows: torch.Tensor  # [NB] int32, non-decreasing
    block_cols: torch.Tensor  # [NB] int32
    row_ptr: torch.Tensor  # [n_rb + 1] int32
    num_nodes: int
    num_row_blocks: int
    csr_row_ptr: torch.Tensor  # [N + 1] int32
    csr_cols: torch.Tensor  # [nnz] int32
    csr_vals: torch.Tensor  # [nnz] float32
    csr_max_row: int  # the most nonzeros in one row

    @property
    def num_blocks(self) -> int:
        return int(self.blocks.shape[0])


def _block_keys(edge_src, edge_dst, n_rb: int, bs: int) -> np.ndarray:
    """Each edge's block key ``row_block * 4 n_rb + col_block`` (int64).
    Sorted, the keys order the blocks by (row block, column block); the
    factor 4 leaves room for column blocks past the last row block, as the
    JAX package's layout does."""
    edge_src = np.asarray(edge_src, dtype=np.int64)
    edge_dst = np.asarray(edge_dst, dtype=np.int64)
    return (edge_dst // bs) * (n_rb * 4) + edge_src // bs


def num_blocks(edge_src, edge_dst, num_nodes: int, block_size: int = BLOCK_SIZE) -> int:
    """NB of :func:`blockify`'s layout, counted exactly: the distinct blocks
    the edges hit, plus one zero block per row block they miss."""
    n_rb = max(1, -(-num_nodes // block_size))
    uniq = np.unique(_block_keys(edge_src, edge_dst, n_rb, block_size))
    return len(uniq) + n_rb - len(np.unique(uniq // (n_rb * 4)))


def blockify(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_weight: np.ndarray,
    num_nodes: int,
    block_size: int = BLOCK_SIZE,
    *,
    budget_bytes: int = BUDGET_BYTES,
    device="cuda",
) -> BlockedAdjacency:
    """Build the BSR layout and its CSR form on the host (one-off per graph)
    and move them to ``device``. Raises ValueError when the dense blocks
    would exceed ``budget_bytes``.

    The CSR form takes its values from the finished blocks, so both forms
    hold the same values: duplicate edges are summed, entries that sum to
    zero and the explicit zero blocks drop out, and so do entries in rows
    or columns >= ``num_nodes`` (they meet no row of X or Y).

    Row convention matches ops/spmm.py::spmm: the produced matrix M satisfies
    M[dst, src] = w(src->dst), i.e. Y = M @ X aggregates incoming messages —
    identical to A X for the symmetric normalized adjacencies used everywhere.
    """
    from s3grl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    edge_src = np.asarray(edge_src, dtype=np.int64)
    edge_dst = np.asarray(edge_dst, dtype=np.int64)
    edge_weight = np.asarray(edge_weight, dtype=np.float32)
    bs = block_size
    n_rb = max(1, -(-num_nodes // bs))

    key = _block_keys(edge_src, edge_dst, n_rb, bs)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_key, block_of_edge = np.unique(key_s, return_inverse=True)
    u_rows = (uniq_key // (n_rb * 4)).astype(np.int32)
    u_cols = (uniq_key % (n_rb * 4)).astype(np.int32)

    # Explicit zero blocks for empty row blocks, as the JAX package keeps.
    missing = np.setdiff1d(np.arange(n_rb, dtype=np.int32), u_rows)
    nb = len(uniq_key) + len(missing)
    if nb * bs * bs * 4 > budget_bytes:
        raise ValueError(
            f"the block-sparse layout needs {nb} blocks of {bs}x{bs}, over the "
            f"{budget_bytes} byte budget"
        )
    all_rows = np.concatenate([u_rows, missing])
    all_cols = np.concatenate([u_cols, np.zeros(len(missing), np.int32)])
    reorder = np.argsort(all_rows * (n_rb * 4) + all_cols, kind="stable")
    all_rows = all_rows[reorder]
    all_cols = all_cols[reorder]
    # Map original unique-block positions to their post-sort slots.
    slot_of_uniq = np.empty(nb, dtype=np.int64)
    slot_of_uniq[reorder] = np.arange(nb)
    edge_slot = slot_of_uniq[block_of_edge]

    blocks = np.zeros((nb, bs, bs), dtype=np.float32)
    r_loc = (edge_dst[order] % bs).astype(np.int64)
    c_loc = (edge_src[order] % bs).astype(np.int64)
    np.add.at(blocks, (edge_slot, r_loc, c_loc), edge_weight[order])

    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(all_rows, minlength=n_rb))]
    ).astype(np.int32)

    # The CSR form: each distinct (dst, src) pair once, sorted, its value
    # read back from the block entry the pair's edges were summed into.
    width = int(edge_src.max()) + 1 if len(edge_src) else 1
    pair, first = np.unique(edge_dst[order] * width + edge_src[order], return_index=True)
    rows, cols = pair // width, pair % width
    vals = blocks[edge_slot[first], r_loc[first], c_loc[first]]
    keep = (vals != 0) & (rows < num_nodes) & (cols < num_nodes)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    row_nnz = np.bincount(rows, minlength=num_nodes)
    csr_row_ptr = np.concatenate([[0], np.cumsum(row_nnz)]).astype(np.int32)
    return BlockedAdjacency(
        blocks=torch.as_tensor(blocks, device=dev),
        block_rows=torch.as_tensor(all_rows, device=dev),
        block_cols=torch.as_tensor(all_cols, device=dev),
        row_ptr=torch.as_tensor(row_ptr, device=dev),
        num_nodes=num_nodes,
        num_row_blocks=n_rb,
        csr_row_ptr=torch.as_tensor(csr_row_ptr, device=dev),
        csr_cols=torch.as_tensor(cols.astype(np.int32), device=dev),
        csr_vals=torch.as_tensor(vals, device=dev),
        csr_max_row=int(row_nnz.max(initial=0)),
    )


def should_use_bsr(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    num_nodes: int,
    num_features: int,
    block_size: int = BLOCK_SIZE,
    budget_bytes: int = BUDGET_BYTES,
) -> bool:
    """Traffic-model selector: BSR only wins when edges cluster into blocks.

    The edge-list route streams about E*C*4*3 bytes (gather, product,
    scatter-add); the BSR route about NB*(BS^2 + 2*BS*C)*4 (each block,
    and an X tile in and an output tile out per block). With scattered
    edges NB approaches E and BSR loses; with clustered edges NB ≪ E and
    BSR wins. BSR is also refused when its blocks exceed ``budget_bytes``.
    NB is counted exactly, by :func:`num_blocks`. The byte model is the
    dense-block layout's (the JAX kernel's), not that of the CUDA kernel,
    which walks the CSR nonzeros.
    """
    e = len(edge_src)
    if e == 0:
        return False
    bs = block_size
    nb = num_blocks(edge_src, edge_dst, num_nodes, bs)
    if nb * bs * bs * 4 > budget_bytes:
        return False
    c = max(num_features, 1)
    bsr_bytes = nb * (bs * bs + 2 * bs * c) * 4
    edge_bytes = e * c * 4 * 3
    return bsr_bytes < BSR_BYTES_FACTOR * edge_bytes


def bsr_spmm_reference(adj: BlockedAdjacency, x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel: one batched dense block × X-block
    product, then the blocks of each row added with ``index_add_``.
    Returns [N, C] float32."""
    n, c = x.shape
    bs = adj.blocks.shape[1]
    n_cb = max(adj.num_row_blocks, int(adj.block_cols.max()) + 1)
    x_pad = torch.zeros((n_cb * bs, c), dtype=torch.float32, device=x.device)
    x_pad[:n] = x
    prod = torch.bmm(adj.blocks, x_pad.view(n_cb, bs, c)[adj.block_cols.long()])
    out = torch.zeros(
        (adj.num_row_blocks, bs, c), dtype=torch.float32, device=x.device
    )
    out.index_add_(0, adj.block_rows.long(), prod)
    return out.view(-1, c)[:n]


def csr_spmm_reference(adj: BlockedAdjacency, x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel's own walk: each CSR nonzero times
    its row of X, added into its output row with ``index_add_``.
    Returns [N, C] float32."""
    n, c = x.shape
    counts = adj.csr_row_ptr[1:] - adj.csr_row_ptr[:-1]
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), counts.long())
    prod = adj.csr_vals[:, None] * x[adj.csr_cols.long()]
    out = torch.zeros((n, c), dtype=torch.float32, device=x.device)
    return out.index_add_(0, rows, prod)


def _lib() -> ctypes.CDLL:
    lib = _build.load("bsr_spmm")
    if not getattr(lib, "_s3grl_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.s3grl_csr_spmm.argtypes = [p, p, p, p, p, i32, i32, i32, p]
        lib.s3grl_csr_spmm.restype = i32
        lib.s3grl_csr_spmm_error_string.argtypes = [i32]
        lib.s3grl_csr_spmm_error_string.restype = ctypes.c_char_p
        lib._s3grl_typed = True
    return lib


def bsr_spmm(adj: BlockedAdjacency, x: torch.Tensor) -> torch.Tensor:
    """Y = M @ X for ``x`` [N, C] float32. Returns [N, C] float32.

    CPU tensors go to ``bsr_spmm_reference``. CUDA tensors launch the
    kernel on the current stream, which reads the CSR fields of ``adj``;
    anything it does not take raises.
    ``bsr_spmm.launches`` counts the launches.
    """
    dev = x.device
    if dev.type == "cpu":
        return bsr_spmm_reference(adj, x)
    if dev.type != "cuda":
        raise ValueError(f"bsr_spmm runs on cpu or cuda, got {dev}")
    n, c = x.shape
    nnz = int(adj.csr_cols.shape[0])
    if n != adj.num_nodes:
        raise ValueError(f"x has {n} rows, the adjacency {adj.num_nodes} nodes")
    _build.check_arg(x, "x", torch.float32, (n, c), dev)
    _build.check_arg(adj.csr_row_ptr, "csr_row_ptr", torch.int32, (n + 1,), dev)
    _build.check_arg(adj.csr_cols, "csr_cols", torch.int32, (nnz,), dev)
    _build.check_arg(adj.csr_vals, "csr_vals", torch.float32, (nnz,), dev)
    if max(n * c, nnz) >= 2**31:
        raise ValueError("shape too large for the kernel's int32 indexing")
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    if n == 0 or c == 0:
        return out
    lib = _lib()
    err = lib.s3grl_csr_spmm(
        adj.csr_row_ptr.data_ptr(), adj.csr_cols.data_ptr(), adj.csr_vals.data_ptr(),
        x.data_ptr(), out.data_ptr(), n, c, adj.csr_max_row,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.s3grl_csr_spmm_error_string(err).decode()
        raise RuntimeError(f"bsr_spmm launch failed: {msg} ({err})")
    bsr_spmm.launches += 1
    return out


bsr_spmm.launches = 0


def power_chain(adj: BlockedAdjacency, x: torch.Tensor, sign_k: int) -> torch.Tensor:
    """[M X, M² X, ..., M^K X] stacked [K, N, C] — the SoP global chain."""
    ys = []
    y = x
    for _ in range(sign_k):
        y = bsr_spmm(adj, y)
        ys.append(y)
    return torch.stack(ys, dim=0)
