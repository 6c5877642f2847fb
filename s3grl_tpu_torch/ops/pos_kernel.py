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
negative neighbor id names no slot. A selected row outside [0, S) gives a
zero row. The TPU kernel's three modes (full chain, selected-row chain and
staircase densify) compute the same function; here one kernel serves all
shapes, and ``chunk_tiles`` (the staircase's tile counts) is accepted and
ignored.

On the card one call makes two launches on the current stream
(``csrc/pos_power_rows.cu``): the selector rows ``H [B, K·R, S]`` from one
pass over the table (:func:`pos_selector_rows`), then one pass over X that
forms every output row. ``pos_power_rows_reference`` is the same split in
plain torch: :func:`pos_selector_rows_reference`, then the product.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from s3grl_tpu_torch.ops import _build

# The most dynamic shared memory one block may use on sm_90 (227 KB).
_MAX_SMEM = 232448
# The selector kernel keeps H_{k-1} in shared memory while its block stays
# within this, so that two blocks fit on an SM.
_H_SMEM_BUDGET = 110 * 1024


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


def pos_selector_rows_reference(
    sel_idx: torch.Tensor,  # [B, R] integer selected local rows
    nbr: torch.Tensor,  # [B, S, D] integer (local slots OR global ids)
    w: torch.Tensor,  # [B, S, D] float32 (0 on padding; link removed)
    *,
    sign_k: int,
    row_ids: Optional[torch.Tensor] = None,  # [B, S] id of each row; iota if None
) -> torch.Tensor:
    """Plain torch version of the selector phase: ``H [B, K·R, S]`` float32,
    row ``(k-1)·R + r`` holding row ``sel[r]`` of ``Â^k`` for k = 1..K
    (gather/scatter form)."""
    B, S, D = nbr.shape
    R = sel_idx.shape[1]
    loc, found = _resolve_slots(nbr, row_ids, S)
    wv = torch.where(found, w.reshape(B, S * D).float(), torch.zeros((), device=w.device))
    coldeg = wv.reshape(B, S, D).sum(dim=-1)
    rowdeg = torch.zeros((B, S), dtype=torch.float32, device=w.device)
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
        return torch.zeros((B, 0, S), dtype=torch.float32, device=w.device)
    return torch.cat(hs, dim=1)


def _one_hot(sel_idx: torch.Tensor, S: int) -> torch.Tensor:
    """[B, R, S] float32: 1 at (r, sel[r]); a row out of [0, S) is 0."""
    slot = torch.arange(S, device=sel_idx.device)
    return (slot[None, None, :] == sel_idx.long()[:, :, None]).float()


def pos_power_rows_reference(
    sel_idx: torch.Tensor,  # [B, R] integer selected local rows
    nbr: torch.Tensor,  # [B, S, D] integer (local slots OR global ids)
    w: torch.Tensor,  # [B, S, D] float32 (0 on padding; link removed)
    subg_x: torch.Tensor,  # [B, S, F] float32 (zeroed on padded nodes)
    *,
    sign_k: int,
    row_ids: Optional[torch.Tensor] = None,  # [B, S] id of each row; iota if None
    chunk_tiles: Optional[torch.Tensor] = None,  # accepted and ignored
) -> torch.Tensor:
    """Plain torch version of the kernels: the selector rows, then one
    product with X, float32 throughout. Returns [B, K+1, R, F]."""
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
        lib.s3grl_pos_selector_rows.argtypes = [
            p, p, p, p, p, p, i32, i32, i32, i32, i32, i32, i32, i64, p,
        ]
        lib.s3grl_pos_selector_rows.restype = i32
        lib.s3grl_pos_xpass.argtypes = [p, p, p, p, i32, i32, i32, i32, i32, p]
        lib.s3grl_pos_xpass.restype = i32
        lib.s3grl_cuda_error_string.argtypes = [i32]
        lib.s3grl_cuda_error_string.restype = ctypes.c_char_p
        lib._s3grl_typed = True
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.s3grl_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _check_table(sel_idx, nbr, w, row_ids, sign_k, dev):
    """Check what the selector kernel takes; return (B, S, D, R)."""
    if sign_k < 0:
        raise ValueError(f"sign_k must be >= 0, got {sign_k}")
    B, S, D = nbr.shape
    R = sel_idx.shape[1]
    _build.check_arg(sel_idx, "sel_idx", torch.int32, (B, R), dev)
    _build.check_arg(nbr, "nbr", torch.int32, (B, S, D), dev)
    _build.check_arg(w, "w", torch.float32, (B, S, D), dev)
    if row_ids is not None:
        _build.check_arg(row_ids, "row_ids", torch.int32, (B, S), dev)
    if min(S, R) < 1 or D < 1:
        raise ValueError(f"empty shape: S={S}, D={D}, R={R}")
    return B, S, D, R


def _selector_rows_cuda(lib, sel_idx, nbr, w, row_ids, sign_k, B, S, D, R):
    """Launch the selector kernel; return its scratch h [B, S, KRP]."""
    dev = nbr.device
    krp = lib.s3grl_pos_h_width(R, sign_k)
    if max(B, S * D, S * krp) >= 2**31:
        raise ValueError("shape too large for the kernel's int32 indexing")
    h = torch.empty((B, S, krp), dtype=torch.float32, device=dev)
    has_ids = row_ids is not None
    cap = lib.s3grl_pos_list_cap(S, D)
    spill = None
    if S * D > cap:
        spill = torch.empty((B, S * D - cap, 2), dtype=torch.int32, device=dev)
    h_in_smem = 1
    smem = lib.s3grl_pos_selector_smem(S, D, R, int(has_ids), cap, h_in_smem)
    if smem > _H_SMEM_BUDGET:
        h_in_smem = 0
        smem = lib.s3grl_pos_selector_smem(S, D, R, int(has_ids), cap, h_in_smem)
    if smem > _MAX_SMEM:
        raise ValueError(f"S={S}, D={D}, R={R} need {smem} bytes of shared memory")
    err = lib.s3grl_pos_selector_rows(
        sel_idx.data_ptr(), nbr.data_ptr(), w.data_ptr(),
        row_ids.data_ptr() if has_ids else None,
        h.data_ptr(), spill.data_ptr() if spill is not None else None,
        B, S, D, R, sign_k, cap, h_in_smem, smem,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, "pos_selector_rows")
    return h


def pos_selector_rows(
    sel_idx: torch.Tensor,  # [B, R] int32
    nbr: torch.Tensor,  # [B, S, D] int32
    w: torch.Tensor,  # [B, S, D] float32
    *,
    sign_k: int,
    row_ids: Optional[torch.Tensor] = None,  # [B, S] int32
) -> torch.Tensor:
    """``H [B, K·R, S]``: the first phase of :func:`pos_power_rows` alone.

    CPU tensors go to ``pos_selector_rows_reference``. CUDA tensors launch
    the selector kernel on the current stream; anything it does not take
    raises. ``pos_selector_rows.launches`` counts these calls (not the
    launches that ``pos_power_rows`` makes).
    """
    dev = nbr.device
    if dev.type == "cpu":
        return pos_selector_rows_reference(sel_idx, nbr, w, sign_k=sign_k, row_ids=row_ids)
    if dev.type != "cuda":
        raise ValueError(f"pos_selector_rows runs on cpu or cuda, got {dev}")
    B, S, D, R = _check_table(sel_idx, nbr, w, row_ids, sign_k, dev)
    kr = sign_k * R
    if B == 0 or kr == 0:
        return torch.zeros((B, kr, S), dtype=torch.float32, device=dev)
    h = _selector_rows_cuda(_lib(), sel_idx, nbr, w, row_ids, sign_k, B, S, D, R)
    pos_selector_rows.launches += 1
    return h[:, :, :kr].transpose(1, 2).contiguous()


pos_selector_rows.launches = 0


def pos_power_rows(
    sel_idx: torch.Tensor,  # [B, R] int32
    nbr: torch.Tensor,  # [B, S, D] int32
    w: torch.Tensor,  # [B, S, D] float32
    subg_x: torch.Tensor,  # [B, S, F] float32
    *,
    sign_k: int,
    row_ids: Optional[torch.Tensor] = None,  # [B, S] int32
    chunk_tiles: Optional[torch.Tensor] = None,  # accepted and ignored
) -> torch.Tensor:
    """[B, K+1, R, F]: op 0 = subg_x rows, op k = (Â_sub^k subg_x) rows.

    CPU tensors go to ``pos_power_rows_reference``. CUDA tensors launch the
    two kernels on the current stream (the selector kernel only when
    ``sign_k`` > 0); anything they do not take raises.
    ``pos_power_rows.launches`` counts the calls that launch.
    """
    dev = subg_x.device
    if dev.type == "cpu":
        return pos_power_rows_reference(
            sel_idx, nbr, w, subg_x, sign_k=sign_k, row_ids=row_ids
        )
    if dev.type != "cuda":
        raise ValueError(f"pos_power_rows runs on cpu or cuda, got {dev}")
    B, S, D, R = _check_table(sel_idx, nbr, w, row_ids, sign_k, dev)
    F = subg_x.shape[2]
    _build.check_arg(subg_x, "subg_x", torch.float32, (B, S, F), dev)
    if F < 1:
        raise ValueError(f"empty shape: F={F}")
    if max(S * F, (sign_k + 1) * R * F) >= 2**31:
        raise ValueError("shape too large for the kernel's int32 indexing")
    out = torch.empty((B, sign_k + 1, R, F), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = _lib()
    h = None
    if sign_k > 0:
        h = _selector_rows_cuda(lib, sel_idx, nbr, w, row_ids, sign_k, B, S, D, R)
    err = lib.s3grl_pos_xpass(
        sel_idx.data_ptr(), subg_x.data_ptr(), h.data_ptr() if h is not None else None,
        out.data_ptr(), B, S, F, R, sign_k,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, "pos_power_rows X pass")
    pos_power_rows.launches += 1
    return out


pos_power_rows.launches = 0
