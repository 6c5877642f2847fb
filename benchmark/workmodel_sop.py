"""What SoP's products need: bytes and floating-point operations of the
SpMM formulation, counted from the graph and the number of links.

Frozen here so that the yardstick does not move with the program: it counts
the least work of the formulation, whatever batches, layout or route the
program takes. For one ``precompute_sop`` call over L links with K powers:
K products of Â with C = F columns (the global chain Â^k X) and K with C =
2L (the links' one-hot endpoint columns, however they are batched). A
product of Â (nnz nonzeros, N rows) with C columns reads each nonzero's
value and column id (8 bytes), the N + 1 row pointers (4 each) and X
(N·C·4), writes Y (N·C·4), and does 2 FLOP per nonzero and column.
"""
from __future__ import annotations

import numpy as np


def nonzeros(n: int, edge_index: np.ndarray) -> int:
    """The nonzeros of Â: the distinct directed pairs of the edge index."""
    e = np.asarray(edge_index, dtype=np.int64)
    return int(len(np.unique(e[0] * n + e[1])))


def spmm_work(nnz: int, n: int, cols: int) -> tuple[float, float]:
    """(bytes, FLOP) of one product of Â with ``cols`` columns."""
    return 8.0 * nnz + 4.0 * (n + 1) + 2.0 * 4.0 * n * cols, 2.0 * nnz * cols


def sop_work(nnz: int, n: int, *, features: int, sign_k: int,
             call_links: list) -> tuple[float, float]:
    """(bytes, FLOP) of ``precompute_sop`` calls over ``call_links`` links
    each: per call, K products over C = F and K over C = 2L."""
    n_bytes = flops = 0.0
    for links in call_links:
        for cols in (features, 2 * int(links)):
            if cols == 0:
                continue
            b, f = spmm_work(nnz, n, cols)
            n_bytes += sign_k * b
            flops += sign_k * f
    return n_bytes, flops
