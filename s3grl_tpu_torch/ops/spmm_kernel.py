"""Sparse SpMM for the SoP chain: the CUDA kernel's wrapper and its plain
torch versions.

``bsr_spmm`` replaces ``s3grl_tpu/ops/spmm_pallas.py::_bsr_spmm_padded``
(through its wrappers ``bsr_spmm`` and ``power_chain``): ``Y = M @ X`` for
M built once per graph on the host by :func:`csr_matrix`,
``M[dst, src] = w``, in CSR form, the one form every path of the port
builds and the kernel walks. The route selector :func:`should_use_bsr`
picks between this and the edge-list route (``ops/spmm.spmm``) from the
graph's shape. M may be a rectangle: a row shard of the row-partitioned
chain (``parallel/dist.py``) is ``[rows, N_pad]``, multiplied by the
gathered ``[N_pad, C]`` power.

On CPU tensors the wrapper runs ``csr_spmm_reference``, the kernel's own
walk; on CUDA tensors it launches the kernel (``csrc/bsr_spmm.cu``) or
raises. :func:`blockify` keeps the JAX package's 128×128 block-sparse (BSR)
layout bit for bit, and ``bsr_spmm_reference`` multiplies by its dense
blocks: the plain dense-block version that tests hold the kernel and the
CSR form against. No path of the port builds it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from s3grl_tpu_torch.ops import _build
from s3grl_tpu_torch.utils.device import Work

BLOCK_SIZE = 128
BUDGET_BYTES = 1 << 30  # the most the dense blocks may take
# The BSR route is taken when its modelled bytes are under this share of
# the edge-list route's. 1.0 is the plain traffic model, not yet fitted to
# the card's times.
BSR_BYTES_FACTOR = 1.0


@dataclass(frozen=True)
class BlockedAdjacency:
    """A square sparse matrix M in the JAX package's BSR form (dense nonzero
    blocks + block coords), on one device: :func:`bsr_spmm_reference`'s
    input, not the kernel's.

    Blocks are sorted by (row_block, col_block); every row block appears at
    least once (empty row blocks carry an explicit zero block), as in the
    JAX package. ``row_ptr[r] .. row_ptr[r + 1]`` are row block r's blocks.
    """

    blocks: torch.Tensor  # [NB, BS, BS] float32
    block_rows: torch.Tensor  # [NB] int32, non-decreasing
    block_cols: torch.Tensor  # [NB] int32
    row_ptr: torch.Tensor  # [n_rb + 1] int32
    num_nodes: int
    num_row_blocks: int

    @property
    def num_blocks(self) -> int:
        return int(self.blocks.shape[0])


@dataclass(frozen=True)
class CsrMatrix:
    """A sparse matrix M in CSR form, on one device: the nonzero entries
    sorted by (row, column), row i's at ``csr_row_ptr[i] ..
    csr_row_ptr[i + 1]``. ``num_nodes`` rows and ``num_cols`` columns: a
    row shard of the row-partitioned chain has fewer rows than columns."""

    csr_row_ptr: torch.Tensor  # [num_nodes + 1] int32
    csr_cols: torch.Tensor  # [nnz] int32
    csr_vals: torch.Tensor  # [nnz] float32
    csr_max_row: int  # the most nonzeros in one row
    num_nodes: int
    num_cols: int


def _csr_arrays(edge_src, edge_dst, edge_weight, num_rows: int, num_cols: int):
    """(row_ptr, cols, vals, max_row) of M, ``M[dst, src] = w``: each
    distinct (dst, src) pair once, sorted, its edges' weights added in
    their given order (as ``np.add.at`` adds them into a dense block);
    entries that sum to zero and those outside ``[num_rows, num_cols)``
    drop out."""
    edge_src = np.asarray(edge_src, dtype=np.int64)
    edge_dst = np.asarray(edge_dst, dtype=np.int64)
    width = int(edge_src.max()) + 1 if len(edge_src) else 1
    pair, slot = np.unique(edge_dst * width + edge_src, return_inverse=True)
    vals = np.zeros(len(pair), dtype=np.float32)
    np.add.at(vals, slot.reshape(-1), np.asarray(edge_weight, dtype=np.float32))
    rows, cols = pair // width, pair % width
    keep = (vals != 0) & (rows < num_rows) & (cols < num_cols)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    row_nnz = np.bincount(rows, minlength=num_rows)
    row_ptr = np.concatenate([[0], np.cumsum(row_nnz)]).astype(np.int32)
    return row_ptr, cols.astype(np.int32), vals, int(row_nnz.max(initial=0))


def csr_matrix(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_weight: np.ndarray,
    num_rows: int,
    num_cols: int,
    *,
    device="cuda",
) -> CsrMatrix:
    """M, ``M[dst, src] = w``, ``[num_rows, num_cols]``, as a
    :class:`CsrMatrix` on ``device``, built on the host (at any size the
    host holds). Duplicate edges are summed in their given order (as
    ``np.add.at`` sums them into :func:`blockify`'s blocks, so both forms
    hold the same values); entries that sum to zero, and those in rows or
    columns past M's, drop out."""
    from s3grl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    row_ptr, cols, vals, max_row = _csr_arrays(edge_src, edge_dst, edge_weight, num_rows,
                                               num_cols)
    return CsrMatrix(
        csr_row_ptr=torch.as_tensor(row_ptr, device=dev),
        csr_cols=torch.as_tensor(cols, device=dev),
        csr_vals=torch.as_tensor(vals, device=dev),
        csr_max_row=max_row, num_nodes=num_rows, num_cols=num_cols,
    )


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
    """Build the BSR layout on the host and move it to ``device``. Raises
    ValueError when the dense blocks would exceed ``budget_bytes``.
    Duplicate edges are summed into their block entry.

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
    return BlockedAdjacency(
        blocks=torch.as_tensor(blocks, device=dev),
        block_rows=torch.as_tensor(all_rows, device=dev),
        block_cols=torch.as_tensor(all_cols, device=dev),
        row_ptr=torch.as_tensor(row_ptr, device=dev),
        num_nodes=num_nodes,
        num_row_blocks=n_rb,
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
    """Plain dense-block version of the kernel's product, as the JAX
    package's layout computes it: one batched dense block × X-block
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


def csr_spmm_reference(adj: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel's own walk: each CSR nonzero times
    its row of X, added into its output row with ``index_add_``.
    Returns [rows of M, C] float32."""
    n, c = adj.num_nodes, x.shape[1]
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


def bsr_spmm(adj: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Y = M @ X for ``x`` [num_cols, C] float32. Returns [num_nodes, C]
    float32 (one row per row of M; [N, C] for a graph's adjacency).

    On every device it refuses anything but a :class:`CsrMatrix`, an ``x``
    whose rows are not M's columns and an ``x`` that is not float32. CPU
    tensors then go to ``csr_spmm_reference``; CUDA tensors launch the
    kernel on the current stream, and what else it does not take raises.
    ``bsr_spmm.launches`` counts the launches.
    """
    if not isinstance(adj, CsrMatrix):
        raise TypeError(f"bsr_spmm takes a CsrMatrix, got {type(adj).__name__}")
    n_x, c = x.shape
    if n_x != adj.num_cols:
        raise ValueError(f"x has {n_x} rows, the adjacency {adj.num_cols} columns")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    dev = x.device
    if dev.type == "cpu":
        return csr_spmm_reference(adj, x)
    if dev.type != "cuda":
        raise ValueError(f"bsr_spmm runs on cpu or cuda, got {dev}")
    n = adj.num_nodes
    nnz = int(adj.csr_cols.shape[0])
    _build.check_arg(x, "x", torch.float32, (n_x, c), dev)
    _build.check_arg(adj.csr_row_ptr, "csr_row_ptr", torch.int32, (n + 1,), dev)
    _build.check_arg(adj.csr_cols, "csr_cols", torch.int32, (nnz,), dev)
    _build.check_arg(adj.csr_vals, "csr_vals", torch.float32, (nnz,), dev)
    if max(n * c, n_x * c, nnz) >= 2**31:
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


def work(adj: CsrMatrix, x: torch.Tensor) -> Work:
    """The bytes and FLOP one :func:`bsr_spmm` call must do for this data,
    whatever implements it: M's nonzeros (value and column id) and its CSR
    row pointers, X read once and Y written once; one multiply-add per
    nonzero and column of X.

    This is not bench.py's TPU count, which streams every 128×128 block
    whole (2·NB·128²·C FLOP; bench.py:293-298), nor the Pallas kernel's
    ``pl.CostEstimate`` (s3grl_tpu/ops/spmm_pallas.py:245): both count the
    dense-block layout's work, not what the data needs.
    """
    nnz, rows, n, c = int(adj.csr_vals.numel()), adj.num_nodes, adj.num_cols, int(x.shape[1])
    return Work(n_bytes=float(8 * nnz + 4 * (rows + 1) + 4 * (n + rows) * c),
                flops=2.0 * nnz * c)


def power_chain_of(product, x: torch.Tensor, sign_k: int) -> torch.Tensor:
    """[M X, M² X, ..., M^K X] stacked [K, N, C] for ``product(Y)`` = M Y
    — the SoP global chain on any route."""
    ys = []
    y = x
    for _ in range(sign_k):
        y = product(y)
        ys.append(y)
    return torch.stack(ys, dim=0)

