"""local_table_roofline: the least time the card could take to build the
subgraph-local adjacency of the links whose tables the profiled slice built
(``benchmark/workmodel.local_table_work``) over the summed device time of
the ``local_table`` kernel, in percent; the run fails on a share above 105.
No cell of ``BENCHMARK.json`` builds a table yet: a cell that does adds
this metric's entry."""

from benchmark.trace import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "local_table", "local_table")
