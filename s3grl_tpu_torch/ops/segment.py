"""Sums whose order is fixed, on every device.

On the card, ``index_add_`` adds with atomics and the backward of
``F.embedding`` in an order that varies from run to run, so a seeded run
does not repeat bit for bit (``scripts/repeat_probe.py`` shows both). Here
the terms are sorted by destination with a stable sort and each
destination's terms are added in that order by ``torch.segment_reduce``,
so the same inputs give the same bits on every run. Nothing here reads a
value back to the host.
"""
from __future__ import annotations

import torch


def segment_lengths(sorted_index: torch.Tensor, num_segments: int) -> torch.Tensor:
    """How many times each of 0 .. num_segments - 1 occurs in the ascending
    ``sorted_index``, by binary search on the device (``torch.bincount``
    reads the index's extremes back to the host)."""
    bounds = torch.searchsorted(
        sorted_index, torch.arange(num_segments + 1, device=sorted_index.device,
                                   dtype=sorted_index.dtype))
    return bounds[1:] - bounds[:-1]


def sum_sorted(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sums of consecutive runs of ``values`` [E, ...], run i ``lengths[i]``
    long, each added in order: [len(lengths), ...]."""
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=0, unsafe=True)


def segment_sum(values: torch.Tensor, index: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[i] = sum of values[e] over e with index[e] == i``, the terms
    of each i added in the order of e. ``values`` [E, ...] -> [num_segments, ...]."""
    sorted_index, order = torch.sort(index, stable=True)
    return sum_sorted(values[order], segment_lengths(sorted_index, num_segments))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = weight.shape[0]
        return weight[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat = grad.reshape(-1, *grad.shape[idx.dim():])
        return segment_sum(flat, idx.reshape(-1), ctx.num_rows), None


def gather_rows(weight: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``weight[idx]`` (rows of ``weight`` [N, ...] at integer ``idx`` of
    any shape), whose backward adds each row's gradient terms in a fixed
    order (:func:`segment_sum`)."""
    return _GatherRows.apply(weight, idx.long())
