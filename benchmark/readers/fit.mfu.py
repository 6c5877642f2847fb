"""fit.mfu: SIGNNet's matrix-product FLOP of one unprofiled training run
(forward and backward of every step, the evaluation forwards), counted from
the shapes by the harness, over that run's host seconds and the card's
float32 peak, in percent."""


def read(ctx):
    work = ctx.work.get("signnet")
    if work is None or ctx.peaks is None or not ctx.unprofiled_s:
        return None
    return 100.0 * work[1] / ctx.unprofiled_s / ctx.peaks["fp32_flop_per_s"]
