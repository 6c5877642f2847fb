"""ctypes bindings for the native host graph core (``graphcore.cpp``).

``graphcore.cpp`` is a byte-identical copy of the JAX package's
``s3grl_tpu/native/graphcore.cpp`` (a test pins it). The port binds what
its large-graph PoS route runs: the CSR build, per-link k-hop sizes and
node sets, each threaded over all of the host's cores; and the host
table build of subgraph-local tables, :func:`khop_local_tab`, which no route
runs (the card builds those tables, ``ops/local_table.py``) and the tests
hold the card's tables against. ``g++`` builds it at
first use into ``build/native/`` at the repository root, under a name that
carries a hash of the source, the flags and the host CPU's feature flags
(``-march=native``). Processes that build at once (test workers, say)
each compile to a name of their own and ``os.replace`` it into place, so
every one of them loads a whole library. A build that fails raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "graphcore.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "native",
)
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-march=native")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _cpu_flags() -> bytes:
    """The host CPU's feature flags, which ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def _target() -> str:
    with open(_SRC, "rb") as f:
        blob = f.read() + repr(GXX_FLAGS).encode() + _cpu_flags()
    tag = hashlib.sha256(blob).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"graphcore_{tag}.so")


def _build() -> str:
    """Build the library unless it is built; return its path. Raises
    RuntimeError with g++'s output if the build fails."""
    so = _target()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", *GXX_FLAGS, _SRC, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native graph core build failed: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(
            f"native graph core build failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}"
        )
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(_build())
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        lib.gc_build_csr.restype = i64
        lib.gc_build_csr.argtypes = [i64, i64, i32p, i32p, f32p, i32, i32p, i32p, f32p]
        lib.gc_bfs_sizes.restype = None
        lib.gc_bfs_sizes.argtypes = [i64, i32p, i32p, i64, i32p, i32, i32, i32p]
        lib.gc_khop_nodes.restype = None
        lib.gc_khop_nodes.argtypes = [i64, i32p, i32p, i64, i32p, i32, i32, i32, i32p, i32p]
        lib.gc_khop_local_tab.restype = None
        lib.gc_khop_local_tab.argtypes = [
            i64, i32p, i32p, i64, i32p, i32, i32, i32, i32,
            i32p, i32p, ctypes.POINTER(ctypes.c_int16), i32p,
        ]
        _LIB = lib
        return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _weights(w, n: int) -> np.ndarray:
    return np.ascontiguousarray(w, dtype=np.float32) if w is not None else np.ones(n, np.float32)


def build_csr(src: np.ndarray, dst: np.ndarray, w: Optional[np.ndarray],
              num_nodes: int, coalesce: bool = False):
    """(row_ptr [N+1], col_idx, weights) sorted by (row, col); with
    ``coalesce`` duplicate pairs are summed."""
    lib = _load()
    src, dst = _i32(src), _i32(dst)
    e = len(src)
    wc = _weights(w, e)
    row_ptr = np.empty(num_nodes + 1, dtype=np.int32)
    col = np.empty(e, dtype=np.int32)
    wout = np.empty(e, dtype=np.float32)
    n_out = lib.gc_build_csr(
        num_nodes, e, _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
        _ptr(wc, ctypes.c_float), int(coalesce), _ptr(row_ptr, ctypes.c_int32),
        _ptr(col, ctypes.c_int32), _ptr(wout, ctypes.c_float),
    )
    return row_ptr, col[:n_out].copy(), wout[:n_out].copy()


def bfs_sizes(row_ptr: np.ndarray, col_idx: np.ndarray, links: np.ndarray,
              hops: int) -> np.ndarray:
    """Per-link full-BFS k-hop subgraph sizes [L] (no sampling)."""
    lib = _load()
    n = len(row_ptr) - 1
    row_ptr, col_idx, links = _i32(row_ptr), _i32(col_idx), _i32(links)
    out = np.empty(len(links), dtype=np.int32)
    lib.gc_bfs_sizes(
        n, _ptr(row_ptr, ctypes.c_int32), _ptr(col_idx, ctypes.c_int32), len(links),
        _ptr(links, ctypes.c_int32), hops, 0, _ptr(out, ctypes.c_int32),
    )
    return out


def khop_nodes(row_ptr: np.ndarray, col_idx: np.ndarray, links: np.ndarray,
               hops: int, max_nodes: int):
    """(nodes [L, max_nodes] in (hop, node id) order, src and dst first,
    padded with -1; sizes [L], exact below ``max_nodes`` and at least
    ``max_nodes`` where the traversal stopped early)."""
    lib = _load()
    n = len(row_ptr) - 1
    row_ptr, col_idx, links = _i32(row_ptr), _i32(col_idx), _i32(links)
    L = len(links)
    nodes = np.empty((L, max_nodes), dtype=np.int32)
    sizes = np.empty(L, dtype=np.int32)
    lib.gc_khop_nodes(
        n, _ptr(row_ptr, ctypes.c_int32), _ptr(col_idx, ctypes.c_int32), L,
        _ptr(links, ctypes.c_int32), hops, max_nodes, 0,
        _ptr(nodes, ctypes.c_int32), _ptr(sizes, ctypes.c_int32),
    )
    return nodes, sizes


def khop_local_tab(row_ptr: np.ndarray, col_idx: np.ndarray, links: np.ndarray,
                   hops: int, max_nodes: int, d_cap: int):
    """(nodes [L, max_nodes] as :func:`khop_nodes` gives them; sizes [L];
    loc [L, max_nodes, d_cap] int16: each member row's neighbors that are
    members, as local slots in CSR order, the target link removed from
    rows 0 and 1, -1 after; maxdeg [L] the largest local degree, counted
    past ``d_cap``). The JAX package's host table build
    (``s3grl_tpu/native/__init__.py`` ``khop_local_tab``)."""
    lib = _load()
    n = len(row_ptr) - 1
    row_ptr, col_idx, links = _i32(row_ptr), _i32(col_idx), _i32(links)
    L = len(links)
    nodes = np.empty((L, max_nodes), dtype=np.int32)
    sizes = np.empty(L, dtype=np.int32)
    loc = np.empty((L, max_nodes, d_cap), dtype=np.int16)
    maxdeg = np.empty(L, dtype=np.int32)
    lib.gc_khop_local_tab(
        n, _ptr(row_ptr, ctypes.c_int32), _ptr(col_idx, ctypes.c_int32), L,
        _ptr(links, ctypes.c_int32), hops, max_nodes, d_cap, 0,
        _ptr(nodes, ctypes.c_int32), _ptr(sizes, ctypes.c_int32),
        _ptr(loc, ctypes.c_int16), _ptr(maxdeg, ctypes.c_int32),
    )
    return nodes, sizes, loc, maxdeg
