"""Faults planted under PoS Plus's timed path, for the tests that see
``correct`` come out false and for reading a fault's numbers on the card.
Each takes an object whose ``setattr`` plants it (pytest's
``monkeypatch``, or one that keeps it), and wraps a function of
``s3grl_tpu_torch/operators/pos.py`` that ``precompute_pos`` looks up at
each call. ``benchmark/faults.py``'s ``PREP`` faults apply too."""
from __future__ import annotations

import torch


def _wrap_storage(mp, fault) -> None:
    import s3grl_tpu_torch.operators.pos as pos

    real = pos._storage_plan

    def planted(*args, **kwargs):
        return fault(*real(*args, **kwargs))
    mp.setattr(pos, "_storage_plan", planted)


def ccn_rows_dropped(mp) -> None:
    """The CCN width halved, as the storage tier sized for a TPU's memory
    halved it for Cora's train split: the links with more common neighbours
    than the halved width lose their furthest CCN rows."""
    _wrap_storage(mp, lambda eff, dtype, dev, tier: (eff // 2, dtype, dev, tier))


def bf16_storage(mp) -> None:
    """The dataset stored in bfloat16, as that storage tier stored it."""
    _wrap_storage(mp, lambda eff, dtype, dev, tier: (eff, torch.bfloat16, dev, "bf16"))


def union_for_intersection(mp) -> None:
    """The CCN set taken as the union of the targets' neighbour sets where
    the configuration asks for their intersection."""
    import s3grl_tpu_torch.operators.pos as pos

    real = pos._ccn_select

    def planted(nbr0, nbr1, node_mask, strategy, max_ccn, R):
        return real(nbr0, nbr1, node_mask, "union" if strategy == "intersection" else strategy,
                    max_ccn, R)
    mp.setattr(pos, "_ccn_select", planted)


POS_PLUS = ("ccn_rows_dropped", "bf16_storage", "union_for_intersection")
