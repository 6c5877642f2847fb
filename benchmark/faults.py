"""Faults planted under the timed path, for the tests that see ``correct``
come out false and for reading a fault's numbers on the card
(``benchmark/control.py --fault``). Each takes an object whose
``setattr`` plants it: pytest's ``monkeypatch``, or one that keeps it."""
from __future__ import annotations

import torch


def answer_altered(mp) -> None:
    """Every link's propagated PoS rows off by 1 %, where they are made."""
    import s3grl_tpu_torch.operators.pos as pos

    real = pos.pos_power_rows

    def altered(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[:, 1:] *= 1.01
        return out
    mp.setattr(pos, "pos_power_rows", altered)


def half_the_batch_left_out(mp) -> None:
    """The second half of each kernel batch's operators left out (zero)."""
    import s3grl_tpu_torch.operators.pos as pos

    real = pos.pos_power_rows

    def halved(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[out.shape[0] // 2:] = 0.0
        return out
    mp.setattr(pos, "pos_power_rows", halved)


def loss_over_half_the_batch(mp) -> None:
    """Training's loss: half of each batch left out, the mean taken over the rest."""
    import s3grl_tpu_torch.train.loop as loop

    real = loop.bce_with_logits

    def half(logits, labels):
        losses = real(logits, labels)
        h = losses.shape[0] // 2
        return torch.cat([losses[:h], losses[:h].mean().expand(losses.shape[0] - h)])
    mp.setattr(loop, "bce_with_logits", half)


def state_unchanged(mp) -> None:
    """Training's step returns the parameters unchanged."""
    import s3grl_tpu_torch.train.loop as loop

    class Frozen(torch.optim.Adam):
        def step(self, closure=None):
            return None
    mp.setattr(loop, "make_optimizer",
               lambda params, lr, weight_decay=1e-4: Frozen(params, lr=lr))


PREP = ("answer_altered", "half_the_batch_left_out")
FIT = ("state_unchanged", "loss_over_half_the_batch")

