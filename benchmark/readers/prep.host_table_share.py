"""prep.host_table_share: the share of the links whose node sets came from
the host BFS that the plan's whole-split host table served, in percent: the
program's counter ``pos.links.host_table`` (the links of host batches whose
node sets were sliced from the table) over ``pos.links.host_bfs`` (the links
of every host batch), as ``s3grl_tpu_torch.profiling.counters`` gives them
at the end of the traced run: over every ``precompute_pos`` call of the run
(set-up's warm unit and both traced slices, all of one traffic). The rest
took a host BFS pass of their own, batch by batch. None where no link took
the host route, or where the program keeps no ``pos.links.host_table``."""


def read(ctx):
    try:
        from s3grl_tpu_torch.profiling import counters
    except ImportError:
        return None
    c = counters()
    if "pos.links.host_table" not in c or not c.get("pos.links.host_bfs"):
        return None
    return 100.0 * c["pos.links.host_table"] / c["pos.links.host_bfs"]
