"""pos_power_rows_roofline: the least time the card could take for what
the profiled links' PoS operators need (``benchmark/workmodel.pos_work``)
over the summed device time of the kernel's launches (its selector and its
pass over X), in percent; the run fails on a share above 105."""

from benchmark.trace import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "pos", "pos_")
