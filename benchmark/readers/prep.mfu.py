"""prep.mfu: the whole precompute's share of the card's peak: the least
time the card could take for what the links' PoS operators need
(``benchmark/workmodel.py``) over the host seconds the program took for the
same links, unprofiled, in percent."""

from benchmark.workmodel import bound_s


def read(ctx):
    work = ctx.work.get("pos")
    if work is None or ctx.peaks is None or not ctx.unprofiled_s:
        return None
    return 100.0 * bound_s(*work, ctx.peaks) / ctx.unprofiled_s
