"""PoS operator rows: the CUDA kernels' wrappers and their plain torch versions.

``pos_power_rows`` replaces ``s3grl_tpu/ops/pos_pallas.py::pos_power_rows``
and keeps its signature and layouts. Per subgraph b it densifies
``A[j, s] += w[s, d]`` wherever ``nbr[s, d] == row_ids[j]``, normalizes
``Â = diag(rowdeg)^-1/2 A diag(coldeg)^-1/2`` (a zero degree gives 0) and
returns the R selected rows of ``Â^k subg_x`` for k = 0..K as
``[B, K+1, R, F]`` float32.

``row_ids`` holds the id by which neighbor entries name each slot: global
node ids with -1 on empty slots, or ``None`` for the slot iota (a table of
local slots). Non-negative row ids must be unique within a subgraph, and a
negative neighbor id names no slot. In local-slot mode ``w`` may be
``None``: weight 1 wherever the slot is >= 0, 0 elsewhere (the table of
``ops/local_table``, which carries no weight array); a ``None`` weight with
a [B, S, D] table and ``row_ids`` raises. A selected row outside [0, S)
gives a zero row.

By id (a 2-D ``nbr``; the global route): ``nbr`` is the graph's own table
[N, D], ``w`` the live prefix of each of its rows [N] int32 (the degrees:
weight 1 on those entries, 0 past them), ``subg_x`` the graph's features
[N, F] with column 0 set aside, and ``row_ids`` [B, S] and ``links`` [B, 2]
the batch's. The call stands for the one on
:func:`gather_by_id`'s arrays and gives its bits: slot s reads row
``row_ids[s]`` up to its degree with weight 1, rows 0 and 1 drop the
target link, and X's row s is that node's with the indicator (1 on slots
0 and 1) in column 0. No input is copied per batch; the selector's own
scratch (its list of resolved entries) is still sized by the table's padded
width D, not by the live degrees.

The TPU kernel's three modes (full chain, selected-row chain and staircase
densify) compute the same function; here one kernel serves all shapes, and
``chunk_tiles`` (the staircase's tile counts) is accepted and ignored.

On the card one call makes two launches on the current stream
(``csrc/pos_power_rows.cu``): the selector rows ``H [B, K·R, S]`` from one
pass over the table (:func:`pos_selector_rows`), then one pass over X that
forms every output row. Where a batch has too few subgraphs to fill the
card, the selector phase is split over (row block, subgraph) instead
(:func:`selector_row_blocks`): a table pass, the degrees and one launch a
step, with the same result. ``pos_power_rows_reference`` is the same split
in plain torch: :func:`pos_selector_rows_reference`, then the product.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from s3grl_tpu_torch import profiling
from s3grl_tpu_torch.ops import _build
from s3grl_tpu_torch.utils.device import Work

# The most dynamic shared memory one block may use on sm_90 (227 KB).
_MAX_SMEM = 232448
# The selector kernel keeps H_{k-1} in shared memory while its block stays
# within this, so that two blocks fit on an SM.
_H_SMEM_BUDGET = 110 * 1024


def _no_weights_check(w: Optional[torch.Tensor], row_ids: Optional[torch.Tensor]) -> None:
    if w is None and row_ids is not None:
        raise ValueError("w=None (weight 1 where the slot is >= 0) is for local slots only; "
                         "a call with row_ids passes its weights")


def _kept(nbr, w, row_ids, S):
    """(loc [B, S*D] int64, keep [B, S*D] bool): each entry's slot, and
    whether it names one with a nonzero weight (``w`` None: weight 1 where
    the slot is >= 0)."""
    _no_weights_check(w, row_ids)
    loc, found = _resolve_slots(nbr, row_ids, S)
    if w is None:
        return loc, found
    return loc, found & (w.reshape(found.shape) != 0)


def _resolve_slots(nbr: torch.Tensor, row_ids: Optional[torch.Tensor], S: int):
    """loc [B, S*D] (int64, the slot each neighbor entry names) and found
    [B, S*D] (bool), by binary search over the sorted row ids."""
    B = nbr.shape[0]
    flat = nbr.reshape(B, -1).long()
    if row_ids is None:
        found = (flat >= 0) & (flat < S)
        return torch.where(found, flat, torch.zeros_like(flat)), found
    keys, order = torch.sort(row_ids.long(), dim=1, stable=True)
    pos = torch.searchsorted(keys, flat).clamp(max=S - 1)
    found = (torch.gather(keys, 1, pos) == flat) & (flat >= 0)
    loc = torch.where(found, torch.gather(order, 1, pos), torch.zeros_like(pos))
    return loc, found


def gather_by_id(
    nbr: torch.Tensor,  # [N, D] integer, the graph's table
    deg: torch.Tensor,  # [N] integer, each row's live prefix
    x: Optional[torch.Tensor],  # [N, F] float32, column 0 set aside for the indicator
    row_ids: torch.Tensor,  # [B, S] integer global ids, -1 on empty slots
    links: torch.Tensor,  # [B, 2] integer (src, dst): slot 0's and slot 1's nodes
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The per-batch arrays that a by-id call stands for: (nbr [B, S, D]
    int32, w [B, S, D] float32, subg_x [B, S, F] float32, None where ``x``
    is). A slot's row is its node's row of the table, weight 1 on the first
    ``deg`` entries and 0 past them and on an empty slot, with the link's
    dst dropped from row 0 and its src from row 1; its X row is its node's,
    zero on an empty slot, column 0 the indicator (1 on slots 0 and 1)."""
    ids = row_ids.long()
    member = ids >= 0
    safe = torch.where(member, ids, torch.zeros_like(ids))
    gnbr = nbr[safe]
    D = nbr.shape[1]
    w = (torch.arange(D, device=nbr.device) < deg[safe].long()[..., None]) & member[..., None]
    w[:, 0] &= gnbr[:, 0] != links[:, 1:2].to(gnbr.dtype)
    w[:, 1] &= gnbr[:, 1] != links[:, 0:1].to(gnbr.dtype)
    if x is None:
        return gnbr.to(torch.int32), w.float(), None
    subg_x = torch.where(member[..., None], x[safe].float(), 0.0)
    subg_x[:, :, 0] = 0.0
    subg_x[:, :2, 0] = member[:, :2].float()
    return gnbr.to(torch.int32), w.float(), subg_x


def _by_id(nbr: torch.Tensor, w, row_ids, links) -> bool:
    """Whether a call reads the graph by id (a 2-D table); such a call must
    give the degrees as ``w``, ``row_ids`` and ``links``."""
    if nbr.dim() != 2:
        return False
    if w is None or row_ids is None or links is None:
        raise ValueError("a by-id call (an [N, D] table) takes the degrees as w, row_ids "
                         "and links")
    return True


def pos_selector_rows_reference(
    sel_idx: torch.Tensor,  # [B, R] integer selected local rows
    nbr: torch.Tensor,  # [B, S, D] integer (local slots OR global ids)
    w: Optional[torch.Tensor],  # [B, S, D] float32 (0 on padding; link removed), or None
    *,
    sign_k: int,
    row_ids: Optional[torch.Tensor] = None,  # [B, S] id of each row; iota if None
    links: Optional[torch.Tensor] = None,  # [B, 2], by id
) -> torch.Tensor:
    """Plain torch version of the selector phase: ``H [B, K·R, S]`` float32,
    row ``(k-1)·R + r`` holding row ``sel[r]`` of ``Â^k`` for k = 1..K
    (gather/scatter form). A by-id call (``nbr`` [N, D], ``w`` the degrees
    [N]) gathers its table first (:func:`gather_by_id`).

    Like the kernel, it first packs each row's resolved nonzero-weight
    entries to the front, in order, at the batch's largest count rounded up
    to a multiple of 32: two tables that list the same entries in the same
    order (global ids, or the local slots of the same subgraphs) then give
    the same bits, however wide each table is, and so do a batch and a
    share of it (torch's sum over a row of such a width does not depend on
    the zeros after its entries)."""
    if _by_id(nbr, w, row_ids, links):
        nbr, w, _ = gather_by_id(nbr, w, None, row_ids, links)
    B, S, _ = nbr.shape
    R = sel_idx.shape[1]
    dev = nbr.device
    loc, keep = _kept(nbr, w, row_ids, S)
    keep = keep.reshape(B, S, -1)
    rank = torch.cumsum(keep, dim=2)
    D = 32 * max(1, -(-(int(rank[:, :, -1].max()) if rank.numel() else 0) // 32))
    col = torch.where(keep, rank - 1, torch.full_like(rank, D))
    packed_loc = torch.zeros((B, S, D + 1), dtype=torch.int64, device=dev)
    packed_loc.scatter_(2, col, torch.where(keep.reshape(B, -1), loc, 0).reshape(B, S, -1))
    packed_w = torch.zeros((B, S, D + 1), dtype=torch.float32, device=dev)
    packed_w.scatter_(2, col, keep.float() if w is None else torch.where(keep, w.float(), 0.0))
    loc = packed_loc[:, :, :D].reshape(B, S * D)
    wv = packed_w[:, :, :D].reshape(B, S * D)
    coldeg = wv.reshape(B, S, D).sum(dim=-1)
    rowdeg = torch.zeros((B, S), dtype=torch.float32, device=dev)
    rowdeg.scatter_add_(1, loc, wv)

    def inv_sqrt(deg):
        return torch.where(
            deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)), torch.zeros_like(deg)
        )

    cd, rd = inv_sqrt(coldeg), inv_sqrt(rowdeg)
    # wn[b, s, d] = coldeg[s]^-1/2 w[s, d] rowdeg[loc]^-1/2
    wn = (wv * torch.gather(rd, 1, loc)).reshape(B, S, D) * cd[:, :, None]

    h = _one_hot(sel_idx, S)  # [B, R, S]
    hs = []
    loc_r = loc[:, None, :].expand(B, R, S * D)
    for _ in range(sign_k):
        g = torch.gather(h, 2, loc_r).reshape(B, R, S, D)
        h = (g * wn[:, None]).sum(dim=-1)
        hs.append(h)
    if not hs:
        return torch.zeros((B, 0, S), dtype=torch.float32, device=dev)
    return torch.cat(hs, dim=1)


def _one_hot(sel_idx: torch.Tensor, S: int) -> torch.Tensor:
    """[B, R, S] float32: 1 at (r, sel[r]); a row out of [0, S) is 0."""
    slot = torch.arange(S, device=sel_idx.device)
    return (slot[None, None, :] == sel_idx.long()[:, :, None]).float()


def pos_power_rows_reference(
    sel_idx: torch.Tensor,  # [B, R] integer selected local rows
    nbr: torch.Tensor,  # [B, S, D] integer (local slots OR global ids)
    w: Optional[torch.Tensor],  # [B, S, D] float32 (0 on padding; link removed), or None
    subg_x: torch.Tensor,  # [B, S, F] float32 (zeroed on padded nodes)
    *,
    sign_k: int,
    row_ids: Optional[torch.Tensor] = None,  # [B, S] id of each row; iota if None
    chunk_tiles: Optional[torch.Tensor] = None,  # accepted and ignored
    links: Optional[torch.Tensor] = None,  # [B, 2], by id
) -> torch.Tensor:
    """Plain torch version of the kernels: the selector rows, then one
    product with X, float32 throughout. Returns [B, K+1, R, F]. A by-id call
    (``nbr`` [N, D], ``w`` the degrees [N], ``subg_x`` [N, F]) gathers its
    arrays first (:func:`gather_by_id`)."""
    if _by_id(nbr, w, row_ids, links):
        nbr, w, subg_x = gather_by_id(nbr, w, subg_x, row_ids, links)
    B, S, _ = nbr.shape
    R, F = sel_idx.shape[1], subg_x.shape[2]
    x = subg_x.float()
    h = torch.cat([
        _one_hot(sel_idx, S),
        pos_selector_rows_reference(sel_idx, nbr, w, sign_k=sign_k, row_ids=row_ids),
    ], dim=1)
    return torch.bmm(h, x).reshape(B, sign_k + 1, R, F)


def _lib() -> ctypes.CDLL:
    lib = _build.load("pos_power_rows")
    if not getattr(lib, "_s3grl_typed", False):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.s3grl_pos_h_width.argtypes = [i32, i32]
        lib.s3grl_pos_h_width.restype = i32
        lib.s3grl_pos_list_cap.argtypes = [i32, i32]
        lib.s3grl_pos_list_cap.restype = i32
        lib.s3grl_pos_selector_smem.argtypes = [i32, i32, i32, i32, i32, i32]
        lib.s3grl_pos_selector_smem.restype = i64
        lib.s3grl_pos_stage_width.argtypes = [i32, i32, i32, i32, i32, i32, i32, i64]
        lib.s3grl_pos_stage_width.restype = i32
        lib.s3grl_pos_selector_rows.argtypes = [
            p, p, p, p, p, p, p, p, i32, i32, i32, i32, i32, i32, i32, i32, i64, p,
        ]
        lib.s3grl_pos_selector_rows.restype = i32
        lib.s3grl_pos_selector_split_smem.argtypes = [i32, i32, i32]
        lib.s3grl_pos_selector_split_smem.restype = i64
        lib.s3grl_pos_selector_split.argtypes = [
            p, p, p, p, p, p, p, p, p, p, p, i32, i32, i32, i32, i32, i32, i64, p,
        ]
        lib.s3grl_pos_selector_split.restype = i32
        lib.s3grl_pos_xpass.argtypes = [p, p, p, p, p, i32, i32, i32, i32, i32, p]
        lib.s3grl_pos_xpass.restype = i32
        lib.s3grl_cuda_error_string.argtypes = [i32]
        lib.s3grl_cuda_error_string.restype = ctypes.c_char_p
        lib._s3grl_typed = True
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.s3grl_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _check_table(sel_idx, nbr, w, row_ids, sign_k, dev, links=None):
    """Check what the selector kernel takes; return (B, S, D, R)."""
    if sign_k < 0:
        raise ValueError(f"sign_k must be >= 0, got {sign_k}")
    R = sel_idx.shape[1]
    if _by_id(nbr, w, row_ids, links):
        (B, S), (N, D) = row_ids.shape, nbr.shape
        _build.check_arg(nbr, "nbr", torch.int32, (N, D), dev)
        _build.check_arg(w, "w (the degrees)", torch.int32, (N,), dev)
        _build.check_arg(links, "links", torch.int32, (B, 2), dev)
    else:
        _no_weights_check(w, row_ids)
        B, S, D = nbr.shape
        _build.check_arg(nbr, "nbr", torch.int32, (B, S, D), dev)
        if w is not None:
            _build.check_arg(w, "w", torch.float32, (B, S, D), dev)
    _build.check_arg(sel_idx, "sel_idx", torch.int32, (B, R), dev)
    if row_ids is not None:
        _build.check_arg(row_ids, "row_ids", torch.int32, (B, S), dev)
    if min(S, R) < 1 or D < 1:
        raise ValueError(f"empty shape: S={S}, D={D}, R={R}")
    return B, S, D, R


# The least S at which the selector is split over row blocks. At S <= 512
# one block a subgraph beats the split's five launches on narrow tables
# (USAir's), and only hub-width tables reach 2-hop sets of 1,024 nodes,
# where the split wins at every B (the sweep in PERF.md §6).
SPLIT_MIN_S = 1024
# The fewest rows a row block of the split selector keeps.
SPLIT_MIN_ROWS = 32


def selector_row_blocks(B: int, S: int, sms: int) -> int:
    """P, the row blocks that share each subgraph's table in the selector
    phase, for a batch of B subgraphs of S slots on a card of ``sms`` SMs.

    1 (one block a subgraph, ``pos_selector_rows_kernel``) where the batch
    fills the card by itself (B >= sms) or S < :data:`SPLIT_MIN_S`. Else
    the least power of two with B·P >= 2·sms, halved while a block would
    keep fewer than :data:`SPLIT_MIN_ROWS` rows."""
    if B >= sms or S < SPLIT_MIN_S:
        return 1
    P = 1
    while B * P < 2 * sms:
        P *= 2
    while P > 1 and S // P < SPLIT_MIN_ROWS:
        P //= 2
    return P


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _count_selector_call(B: int, P: int, sms: int) -> None:
    """The selector's counters, host integers only: calls, split calls, the
    blocks that run at once (at most one an SM) and the card's SMs."""
    profiling.count("pos.selector.calls")
    profiling.count("pos.selector.split_calls", P > 1)
    profiling.count("pos.selector.blocks", min(B * P, sms))
    profiling.count("pos.selector.sm_slots", sms)
    if P > 1:
        pos_selector_rows.split_launches += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _selector_split_cuda(lib, sel_idx, nbr, w, row_ids, sign_k, B, S, D, R, P, h, deg, links):
    """Launch the selector split over P row blocks a subgraph into h (by id
    where ``deg`` is given, ``w`` then None). Its list of resolved entries
    is [B, S, D]: sized by the table's padded width, not by the rows' live
    degrees."""
    dev = nbr.device
    has_ids = row_ids is not None
    smem = lib.s3grl_pos_selector_split_smem(S, int(has_ids), P)
    if smem > _MAX_SMEM:
        raise ValueError(f"S={S} needs {smem} bytes of shared memory")
    entries = torch.empty((B, S, D, 2), dtype=torch.int32, device=dev)
    rcnt = torch.empty((B, S), dtype=torch.int32, device=dev)
    degs = torch.empty((2, B, S), dtype=torch.float32, device=dev)
    rpart = torch.empty((B, P, S), dtype=torch.float32, device=dev)
    err = lib.s3grl_pos_selector_split(
        sel_idx.data_ptr(), nbr.data_ptr(), _ptr(w), _ptr(row_ids), _ptr(deg), _ptr(links),
        h.data_ptr(), entries.data_ptr(), rcnt.data_ptr(), degs.data_ptr(), rpart.data_ptr(),
        B, S, D, R, sign_k, P, smem, _stream(dev),
    )
    _raise_on(lib, err, "pos_selector_rows (split)")


def _selector_rows_cuda(lib, sel_idx, nbr, w, row_ids, sign_k, B, S, D, R, row_blocks=None,
                        links=None):
    """Launch the selector phase; return its scratch h [B, S, KRP].
    ``row_blocks`` forces P (tests); None takes :func:`selector_row_blocks`.
    A 2-D ``nbr`` reads the graph by id (``w`` its degrees, with ``links``)."""
    dev = nbr.device
    deg = None
    if nbr.dim() == 2:
        deg, w = w, None
    krp = lib.s3grl_pos_h_width(R, sign_k)
    if max(B, S * D, S * krp, nbr.shape[0]) >= 2**31:
        raise ValueError("shape too large for the kernel's int32 indexing")
    h = torch.empty((B, S, krp), dtype=torch.float32, device=dev)
    sms = _sm_count(dev)
    P = selector_row_blocks(B, S, sms) if row_blocks is None else row_blocks
    if not 1 <= P <= S:
        raise ValueError(f"row blocks must lie in [1, S={S}], got {P}")
    if P > 1:
        _selector_split_cuda(lib, sel_idx, nbr, w, row_ids, sign_k, B, S, D, R, P, h, deg, links)
        _count_selector_call(B, P, sms)
        return h
    has_ids, by_id = int(row_ids is not None), int(deg is not None)
    cap = lib.s3grl_pos_list_cap(S, D)
    spill = None
    if S * D > cap:
        spill = torch.empty((B, S * D - cap, 2), dtype=torch.int32, device=dev)
    for h_in_smem in (1, 0):  # H_{k-1} on chip where the block stays within the budget
        sw = lib.s3grl_pos_stage_width(S, D, R, has_ids, by_id, cap, h_in_smem, _H_SMEM_BUDGET)
        smem = lib.s3grl_pos_selector_smem(S, sw, R, has_ids, cap, h_in_smem)
        if smem <= _H_SMEM_BUDGET:
            break
    if smem > _MAX_SMEM:
        raise ValueError(f"S={S}, D={D}, R={R} need {smem} bytes of shared memory")
    err = lib.s3grl_pos_selector_rows(
        sel_idx.data_ptr(), nbr.data_ptr(), _ptr(w), _ptr(row_ids), _ptr(deg), _ptr(links),
        h.data_ptr(), _ptr(spill), B, S, D, R, sign_k, cap, sw, h_in_smem, smem, _stream(dev),
    )
    _raise_on(lib, err, "pos_selector_rows")
    _count_selector_call(B, P, sms)
    return h


def pos_selector_rows(
    sel_idx: torch.Tensor,  # [B, R] int32
    nbr: torch.Tensor,  # [B, S, D] int32
    w: Optional[torch.Tensor],  # [B, S, D] float32, or None (local slots only)
    *,
    sign_k: int,
    row_ids: Optional[torch.Tensor] = None,  # [B, S] int32
    links: Optional[torch.Tensor] = None,  # [B, 2] int32, by id
) -> torch.Tensor:
    """``H [B, K·R, S]``: the first phase of :func:`pos_power_rows` alone.

    CPU tensors go to ``pos_selector_rows_reference``. CUDA tensors launch
    the selector kernel on the current stream; anything it does not take
    raises. ``pos_selector_rows.launches`` counts these calls (not the
    launches that ``pos_power_rows`` makes); ``pos_selector_rows.split_launches``
    counts the selector phases of both that were split over row blocks.
    """
    dev = nbr.device
    if dev.type == "cpu":
        return pos_selector_rows_reference(sel_idx, nbr, w, sign_k=sign_k, row_ids=row_ids,
                                           links=links)
    if dev.type != "cuda":
        raise ValueError(f"pos_selector_rows runs on cpu or cuda, got {dev}")
    B, S, D, R = _check_table(sel_idx, nbr, w, row_ids, sign_k, dev, links)
    kr = sign_k * R
    if B == 0 or kr == 0:
        return torch.zeros((B, kr, S), dtype=torch.float32, device=dev)
    h = _selector_rows_cuda(_lib(), sel_idx, nbr, w, row_ids, sign_k, B, S, D, R, links=links)
    pos_selector_rows.launches += 1
    return h[:, :, :kr].transpose(1, 2).contiguous()


pos_selector_rows.launches = 0
pos_selector_rows.split_launches = 0  # selector phases split over row blocks (P > 1)


def pos_power_rows(
    sel_idx: torch.Tensor,  # [B, R] int32
    nbr: torch.Tensor,  # [B, S, D] int32, or the graph's [N, D] by id
    w: Optional[torch.Tensor],  # [B, S, D] float32, None (local slots), or [N] int32 by id
    subg_x: torch.Tensor,  # [B, S, F] float32, or [N, F] by id
    *,
    sign_k: int,
    row_ids: Optional[torch.Tensor] = None,  # [B, S] int32
    chunk_tiles: Optional[torch.Tensor] = None,  # accepted and ignored
    links: Optional[torch.Tensor] = None,  # [B, 2] int32, by id
) -> torch.Tensor:
    """[B, K+1, R, F]: op 0 = subg_x rows, op k = (Â_sub^k subg_x) rows.

    CPU tensors go to ``pos_power_rows_reference``. CUDA tensors launch the
    two kernels on the current stream (the selector kernel only when
    ``sign_k`` > 0); anything they do not take raises. With a 2-D ``nbr``
    the call reads the graph's arrays by id (the module docstring): ``nbr``
    [N, D], ``w`` the degrees [N] int32, ``subg_x`` [N, F], ``links``.
    ``pos_power_rows.launches`` counts the calls that launch, and
    ``pos_power_rows.local_launches`` those of them in local-slot mode.
    """
    dev = subg_x.device
    if dev.type == "cpu":
        return pos_power_rows_reference(
            sel_idx, nbr, w, subg_x, sign_k=sign_k, row_ids=row_ids, links=links
        )
    if dev.type != "cuda":
        raise ValueError(f"pos_power_rows runs on cpu or cuda, got {dev}")
    B, S, D, R = _check_table(sel_idx, nbr, w, row_ids, sign_k, dev, links)
    by_id = nbr.dim() == 2
    F = subg_x.shape[-1]
    x_rows = (nbr.shape[0],) if by_id else (B, S)
    _build.check_arg(subg_x, "subg_x", torch.float32, (*x_rows, F), dev)
    if F < 1:
        raise ValueError(f"empty shape: F={F}")
    if max(x_rows[-1] * F, (sign_k + 1) * R * F) >= 2**31:
        raise ValueError("shape too large for the kernel's int32 indexing")
    out = torch.empty((B, sign_k + 1, R, F), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = _lib()
    h = None
    if sign_k > 0:
        h = _selector_rows_cuda(lib, sel_idx, nbr, w, row_ids, sign_k, B, S, D, R, links=links)
    err = lib.s3grl_pos_xpass(
        sel_idx.data_ptr(), subg_x.data_ptr(), _ptr(row_ids) if by_id else None,
        _ptr(h), out.data_ptr(), B, S, F, R, sign_k, _stream(dev),
    )
    _raise_on(lib, err, "pos_power_rows X pass")
    pos_power_rows.launches += 1
    if row_ids is None:
        pos_power_rows.local_launches += 1
    return out


pos_power_rows.launches = 0
pos_power_rows.local_launches = 0  # the launches in local-slot mode (row_ids None)


def resolved_entries(nbr: torch.Tensor, w: Optional[torch.Tensor],
                     row_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B] int64: each subgraph's neighbor entries that name one of its slots
    and carry a nonzero weight (the entries the K steps walk)."""
    return _kept(nbr, w, row_ids, nbr.shape[1])[1].sum(dim=1)


def work(
    sel_idx: torch.Tensor,
    nbr: torch.Tensor,
    w: Optional[torch.Tensor],
    subg_x: torch.Tensor,
    *,
    sign_k: int,
    row_ids: Optional[torch.Tensor] = None,
    node_mask: Optional[torch.Tensor] = None,  # [B, S] bool, the member slots
    count: str = "members",
    links: Optional[torch.Tensor] = None,  # [B, 2], by id
) -> Work:
    """The bytes and FLOP one :func:`pos_power_rows` call must do for this
    data, whatever implements it.

    By id (a 2-D ``nbr``, ``w`` its degrees) the call reads what it needs
    and no copy: each member slot's degree, live entries (its node's degree
    of them; ids only, no weights) and row of X, every slot's row id, the
    links and the selected row ids, each once, and writes the output;
    ``node_mask`` None takes the slots with a row id >= 0, and ``count`` is
    "members" or "live" (the same: no padding is read).

    Bytes: the member slots' rows of the table and its weights (none where
    ``w`` is None), their rows of X and their row ids (global mode), the
    selected row ids, each read once, and the output written once. FLOP: one multiply-add per resolved
    entry (:func:`resolved_entries`) and selected row per step, and one per
    (k >= 1, selected row, member slot, feature) for the output; a padded
    slot adds nothing to the output. ``node_mask`` None takes every slot as
    a member. ``count`` "padded" reads every slot's row of the table and of
    X; "live" reads of each member row only its nonzero-weight entries
    (slots >= 0 where ``w`` is None), not the table's padded width.

    This is not bench.py's TPU count, which pads F to 128 lanes and counts
    a dense [S, S] densify and power chain (bench.py:217-229), nor the
    Pallas kernel's ``pl.CostEstimate`` (s3grl_tpu/ops/pos_pallas.py:296):
    both count what the TPU kernel does, not what the data needs.
    """
    if _by_id(nbr, w, row_ids, links):
        return _work_by_id(sel_idx, nbr, w, subg_x, row_ids, links, node_mask, count, sign_k)
    B, S, D = nbr.shape
    F, R, K = subg_x.shape[2], sel_idx.shape[1], sign_k
    entries = int(resolved_entries(nbr, w, row_ids).sum())
    if node_mask is None:
        node_mask = torch.ones((B, S), dtype=torch.bool, device=nbr.device)
    rows = int(node_mask.sum())
    if count == "members":
        table = rows * D
    elif count == "padded":
        rows, table = B * S, B * S * D
    elif count == "live":
        weighted = (nbr >= 0) if w is None else (w != 0)
        table = int((weighted & node_mask[:, :, None]).sum())
    else:
        raise ValueError(f"count must be members, padded or live, got {count!r}")
    ids = rows if row_ids is not None else 0
    arrays = 1 if w is None else 2  # the table's ids, and its weights
    n_bytes = 4 * (arrays * table + rows * F + B * (K + 1) * R * F + B * R + ids)
    return Work(n_bytes=float(n_bytes), flops=2.0 * (K * R * entries + K * R * rows * F))


def _work_by_id(sel_idx, nbr, deg, x, row_ids, links, node_mask, count, K) -> Work:
    """:func:`work` of a by-id call."""
    if count not in ("members", "live"):
        raise ValueError(f"a by-id call reads no padding: count must be members or live, "
                         f"got {count!r}")
    B, S = row_ids.shape
    F, R = x.shape[1], sel_idx.shape[1]
    gnbr, w, _ = gather_by_id(nbr, deg, None, row_ids, links)
    entries = int(resolved_entries(gnbr, w, row_ids).sum())
    if node_mask is None:
        node_mask = row_ids >= 0
    ids = row_ids.long()
    member = node_mask & (ids >= 0)
    rows = int(member.sum())
    live = int(deg[ids[member]].long().sum())
    n_bytes = 4 * (live + rows * F + rows + B * S + 2 * B + B * (K + 1) * R * F + B * R)
    return Work(n_bytes=float(n_bytes), flops=2.0 * (K * R * entries + K * R * rows * F))
