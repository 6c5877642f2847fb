"""PoS operator rows: the CUDA kernel's wrapper and its plain torch version.

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

On CPU tensors the wrapper runs ``pos_power_rows_reference``; on CUDA
tensors it launches the kernel (``csrc/pos_power_rows.cu``) or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from s3grl_tpu_torch.ops import _build

# The most dynamic shared memory one block may use on sm_90 (227 KB).
_MAX_SMEM = 232448


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
    """Plain torch version of the kernel: same function, gather/scatter
    form, float32 throughout. Returns [B, K+1, R, F]."""
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

    slot = torch.arange(S, device=nbr.device)
    h = (slot[None, None, :] == sel_idx.long()[:, :, None]).float()  # [B, R, S]
    x = subg_x.float()
    outs = [torch.bmm(h, x)]
    loc_r = loc[:, None, :].expand(B, R, S * D)
    for _ in range(sign_k):
        g = torch.gather(h, 2, loc_r).reshape(B, R, S, D)
        h = (g * wn[:, None]).sum(dim=-1)
        outs.append(torch.bmm(h, x))
    return torch.stack(outs, dim=1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("pos_power_rows")
    if not getattr(lib, "_s3grl_typed", False):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.s3grl_pos_power_rows.argtypes = [
            p, p, p, p, p, p, p, p, i32, i32, i32, i32, i32, i32, i64, p,
        ]
        lib.s3grl_pos_power_rows.restype = i32
        lib.s3grl_pos_power_rows_smem.argtypes = [i32, i32, i32, i32, i32]
        lib.s3grl_pos_power_rows_smem.restype = i64
        lib.s3grl_cuda_error_string.argtypes = [i32]
        lib.s3grl_cuda_error_string.restype = ctypes.c_char_p
        lib._s3grl_typed = True
    return lib


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
    kernel on the current stream; anything it does not take raises.
    ``pos_power_rows.launches`` counts the launches.
    """
    dev = subg_x.device
    if dev.type == "cpu":
        return pos_power_rows_reference(
            sel_idx, nbr, w, subg_x, sign_k=sign_k, row_ids=row_ids
        )
    if dev.type != "cuda":
        raise ValueError(f"pos_power_rows runs on cpu or cuda, got {dev}")
    if sign_k < 0:
        raise ValueError(f"sign_k must be >= 0, got {sign_k}")
    B, S, D = nbr.shape
    F = subg_x.shape[2]
    R = sel_idx.shape[1]
    _build.check_arg(sel_idx, "sel_idx", torch.int32, (B, R), dev)
    _build.check_arg(nbr, "nbr", torch.int32, (B, S, D), dev)
    _build.check_arg(w, "w", torch.float32, (B, S, D), dev)
    _build.check_arg(subg_x, "subg_x", torch.float32, (B, S, F), dev)
    if row_ids is not None:
        _build.check_arg(row_ids, "row_ids", torch.int32, (B, S), dev)
    if min(S, R, F) < 1 or D < 1:
        raise ValueError(f"empty shape: S={S}, D={D}, F={F}, R={R}")
    per_block = (S * D, S * F, (sign_k + 1) * R * F, sign_k * R * S)
    if max(B, *per_block) >= 2**31:
        raise ValueError("shape too large for the kernel's int32 indexing")
    out = torch.empty((B, sign_k + 1, R, F), dtype=torch.float32, device=dev)
    if B == 0:
        return out

    lib = _lib()
    has_ids = row_ids is not None
    if has_ids:
        keys, order = torch.sort(row_ids, dim=1, stable=True)
        keys, order = keys.contiguous(), order.to(torch.int32).contiguous()
    smem = lib.s3grl_pos_power_rows_smem(S, R, sign_k, int(has_ids), 1)
    h_scratch = None
    if smem > _MAX_SMEM:
        smem = lib.s3grl_pos_power_rows_smem(S, R, sign_k, int(has_ids), 0)
        if smem > _MAX_SMEM:
            raise ValueError(f"S={S} needs {smem} bytes of shared memory")
        h_scratch = torch.empty(
            (B, sign_k * R * S), dtype=torch.float32, device=dev
        )
    err = lib.s3grl_pos_power_rows(
        sel_idx.data_ptr(), nbr.data_ptr(), w.data_ptr(), subg_x.data_ptr(),
        keys.data_ptr() if has_ids else None,
        order.data_ptr() if has_ids else None,
        out.data_ptr(),
        h_scratch.data_ptr() if h_scratch is not None else None,
        B, S, D, F, R, sign_k, smem,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.s3grl_cuda_error_string(err).decode()
        raise RuntimeError(f"pos_power_rows launch failed: {msg} ({err})")
    pos_power_rows.launches += 1
    return out


pos_power_rows.launches = 0
