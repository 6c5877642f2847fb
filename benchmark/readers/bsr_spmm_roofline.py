"""bsr_spmm_roofline: the least time the card could take for the SpMM work
of the profiled SoP links (``benchmark/workmodel_sop.sop_work``: the global
chain and the endpoint columns, however batched) over the summed device
time of the kernels named ``csr_spmm*`` (``csrc/bsr_spmm.cu``), in
percent; the run fails on a share above 105. None where no such kernel ran
(the edge-list route)."""

from benchmark.trace import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "bsr_spmm", "csr_spmm")
