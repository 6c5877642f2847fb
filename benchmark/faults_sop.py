"""Faults planted under SoP's timed path, for the tests that see
``correct`` come out false and for reading a fault's numbers on the card.
Each takes an object whose ``setattr`` plants it (pytest's
``monkeypatch``, or one that keeps it), and wraps
``operators/sop._sop_batch``, which ``precompute_sop`` looks up at each
batch: [B, K+1, 2, F+1] from (propagate, x, ys [K, N, F], links [B, 2])."""
from __future__ import annotations


def _wrap(mp, fault) -> None:
    import s3grl_tpu_torch.operators.sop as sop

    real = sop._sop_batch

    def planted(propagate, x_global, ys, links, **kwargs):
        return fault(real(propagate, x_global, ys, links, **kwargs), ys, links)
    mp.setattr(sop, "_sop_batch", planted)


def zeroing_left_out(mp) -> None:
    """Each power's feature part is the whole row Â^k[u,:] · X = Y_k[u]:
    the entry [u,v] is not zeroed."""
    def fault(out, ys, links):
        out = out.clone()
        ends = links.reshape(-1)  # u, v of each link in turn
        B, K = links.shape[0], ys.shape[0]
        out[:, 1:, :, 1:] = ys[:, ends].reshape(K, B, 2, -1).transpose(0, 1)
        return out
    _wrap(mp, fault)


def diagonal_one_power_behind(mp) -> None:
    """Each power's prepended diagonal is Â^(k-1)[u,u], one power behind
    (1 for k = 1, the op-0 column)."""
    def fault(out, ys, links):
        out = out.clone()
        out[:, 1:, :, 0] = out[:, :-1, :, 0].clone()
        return out
    _wrap(mp, fault)


SOP = ("zeroing_left_out", "diagonal_one_power_behind")
