"""Subgraph-local neighbor tables: the CUDA kernel's wrapper and its plain
torch version.

:func:`local_table` builds, for a batch of node sets, the table that
``pos_power_rows`` takes in its local-slot mode. It has no TPU counterpart:
the JAX package builds the same table on the host
(``s3grl_tpu/native/graphcore.cpp`` ``gc_khop_local_tab``) from the node
sets of its host BFS, and copies it to the chip each batch. Here it is
built on the card from the node sets and the global neighbor table
(``DeviceGraph.nbr``, whose live entries are a prefix of each row).

Row s of subgraph b holds, in the order of ``nbr[g, :deg[g]]`` (g =
``nodes[b, s]``), the local slot of every neighbor that is a member of the
same subgraph, -1 after; the target link leaves rows 0 and 1 (reference
``utils.py:78-80``); rows of empty slots are all -1. The caller gives the
width, one that no row's local degree passes (``operators/pos.
local_table_width``: ``min(S, D_tab)`` rounded up to 32 on a table that
repeats no neighbor). The table carries no weight array: an entry weighs 1
where its slot is >= 0 and 0 elsewhere, which ``pos_power_rows`` takes as
``w=None``, as the JAX package derives ``w = loc >= 0`` on the chip
(``s3grl_tpu/operators/pos.py:465``); padding columns change no output.

On the card one call is one launch of ``csrc/local_table.cu`` on the
current stream, with no read back to the host. On CPU tensors the wrapper
runs the plain version; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from s3grl_tpu_torch.ops import _build
from s3grl_tpu_torch.utils.device import Work

# Columns a table's width is rounded up to, as DeviceGraph.from_graph rounds
# the global table's.
WIDTH_MULTIPLE = 32


def rows_per_block(S: int, width: int) -> int:
    """Rows of one subgraph that one block of the kernel builds (its grid is
    (S / rows_per_block, B)). Each block hashes all S members once, and a
    row's stream of entries is at most ``width`` long, so a block takes the
    least power of two of rows, 16 to 256, whose longest streams add up to
    16 S: at the hub batch (S = width = 1,024, rows of hundreds of entries)
    16 rows a block ran fastest, at the main path's S = 256 (width 96, rows
    of about a dozen) 64 (``chip_smoke.py``'s sweep, PERF.md)."""
    want = -(-16 * S // max(1, width))
    return min(256, max(16, 1 << (want - 1).bit_length()))


def table_width(entries: int) -> int:
    """A table width that holds ``entries`` entries a row: rounded up to
    :data:`WIDTH_MULTIPLE`, at least one multiple."""
    return WIDTH_MULTIPLE * max(1, -(-int(entries) // WIDTH_MULTIPLE))


def local_table_reference(
    nbr: torch.Tensor,  # [N, D_tab] int32 global neighbor ids
    deg: torch.Tensor,  # [N] int32 live prefix of each row
    nodes: torch.Tensor,  # [B, S] integer global ids (slot 0 = src, 1 = dst)
    node_mask: torch.Tensor,  # [B, S] bool member slots
    links: torch.Tensor,  # [B, 2] integer
    width: int,
):
    """Plain torch version of :func:`local_table`, on a slot map (the idea
    of ``sampling/extraction.assemble_local_structure``) and a stable
    compaction: loc [B, S, width] int32."""
    B, S = nodes.shape
    N, D = nbr.shape
    dev = nbr.device
    nodes_l = nodes.long()
    # pos_map[b, id] = slot + 1, 0 = not a member; empty slots park on the
    # sentinel column N, which no table entry names. A repeated id keeps its
    # last slot, as the kernel and the host table build do.
    pos_map = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    safe = torch.where(node_mask, nodes_l, torch.full_like(nodes_l, N))
    slots = torch.arange(1, S + 1, device=dev).expand(B, S)
    pos_map.scatter_reduce_(1, safe, slots, reduce="amax")
    pos_map[:, N] = 0

    gnbr = nbr[nodes_l].long()  # [B, S, D]
    live = torch.arange(D, device=dev) < deg[nodes_l].long()[:, :, None]
    lj1 = torch.gather(pos_map, 1, gnbr.reshape(B, S * D)).reshape(B, S, D)
    hit = live & (lj1 > 0) & node_mask[:, :, None]
    links = links.long()
    hit[:, 0] &= gnbr[:, 0] != links[:, 1:2]
    hit[:, 1] &= gnbr[:, 1] != links[:, 0:1]

    rank = torch.cumsum(hit, dim=2)
    W = width
    # Each hit goes to its rank's column, the rest (and any past the width)
    # to a column dropped after.
    col = torch.where(hit & (rank <= W), rank - 1, torch.full_like(rank, W))
    loc = torch.full((B, S, W + 1), -1, dtype=torch.int64, device=dev)
    loc.scatter_(2, col, torch.where(hit, lj1 - 1, torch.full_like(lj1, -1)))
    return loc[:, :, :W].to(torch.int32).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("local_table")
    if not getattr(lib, "_s3grl_typed", False):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.s3grl_local_table.argtypes = [p, p, i64, p, p, p, i32, i32, i32, i32, p, p]
        lib.s3grl_local_table.restype = i32
        lib.s3grl_local_table_error_string.argtypes = [i32]
        lib.s3grl_local_table_error_string.restype = ctypes.c_char_p
        lib._s3grl_typed = True
    return lib


def local_table(
    nbr: torch.Tensor,  # [N, D_tab] int32
    deg: torch.Tensor,  # [N] int32
    nodes: torch.Tensor,  # [B, S] int32
    node_mask: torch.Tensor,  # [B, S] bool
    links: torch.Tensor,  # [B, 2] integer
    width: int,
):
    """loc [B, S, width] int32: local slots, -1 on padding (weight 1 where
    loc >= 0, 0 elsewhere). ``width`` must be at least the largest local
    degree: entries past it are not written.

    CPU tensors go to :func:`local_table_reference`. CUDA tensors launch
    the kernel once on the current stream (``width`` a multiple of 4, for
    its 16-byte stores); anything it does not take raises.
    ``local_table.launches`` counts the calls that launch.
    """
    dev = nodes.device
    if dev.type == "cpu":
        return local_table_reference(nbr, deg, nodes, node_mask, links, width)
    if dev.type != "cuda":
        raise ValueError(f"local_table runs on cpu or cuda, got {dev}")
    B, S = nodes.shape
    N, D = nbr.shape
    _build.check_arg(nbr, "nbr", torch.int32, (N, D), dev)
    _build.check_arg(deg, "deg", torch.int32, (N,), dev)
    _build.check_arg(nodes, "nodes", torch.int32, (B, S), dev)
    _build.check_arg(node_mask, "node_mask", torch.bool, (B, S), dev)
    links = links.to(torch.int32).contiguous()
    _build.check_arg(links, "links", torch.int32, (B, 2), dev)
    if min(S, D, width) < 1:
        raise ValueError(f"empty shape: S={S}, D={D}, width={width}")
    if width % 4:
        raise ValueError(f"the kernel writes 16-byte stores: width {width} is not a "
                         f"multiple of 4")
    loc = torch.empty((B, S, width), dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.s3grl_local_table(
        nbr.data_ptr(), deg.data_ptr(), D, nodes.data_ptr(), node_mask.data_ptr(),
        links.data_ptr(), B, S, width, rows_per_block(S, width), loc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.s3grl_local_table_error_string(err).decode()
        raise RuntimeError(f"local_table launch failed: {msg} ({err})")
    local_table.launches += 1
    return loc


local_table.launches = 0


def work(
    nbr: torch.Tensor,
    deg: torch.Tensor,
    nodes: torch.Tensor,
    node_mask: torch.Tensor,
    width: int,
    *,
    count: str = "live",
) -> Work:
    """The bytes one :func:`local_table` call must move for this data,
    whatever implements it (no floating-point work: bound by bytes).

    Reads: the node sets (ids and mask) and the links; each member row's
    degree and its live table entries (``count`` "live"), or its whole
    ``D_tab``-wide row ("padded"). Writes: the table at ``width``, once
    (no weight array).
    """
    B, S = nodes.shape
    members = node_mask.reshape(-1)
    rows = int(members.sum())
    if count == "live":
        entries = int(deg[nodes.reshape(-1).long()[members]].long().sum())
    elif count == "padded":
        entries = rows * int(nbr.shape[1])
    else:
        raise ValueError(f"count must be live or padded, got {count!r}")
    n_bytes = 5 * B * S + 8 * B + 4 * rows + 4 * entries + 4 * B * S * width
    return Work(n_bytes=float(n_bytes), flops=0.0)
