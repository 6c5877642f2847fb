"""prep.input_bytes_per_link: the bytes of per-batch kernel inputs that the
PoS routes built on the card, a link: the program's counter
``pos.inputs.bytes`` (from the batches' shapes: on the global route, read
by node id, the row ids, selected rows and links; on a local route, its
tables and features too) over ``pos.links``, as
``s3grl_tpu_torch.profiling.counters`` gives them at the end of the traced
run: over every ``precompute_pos`` call of the run (set-up's warm unit and
both traced slices, all of one traffic). Inputs only: the kernel's own
scratch (its selector's list of resolved entries) is not counted. None
where the program keeps no such counter."""


def read(ctx):
    try:
        from s3grl_tpu_torch.profiling import counters
    except ImportError:
        return None
    c = counters()
    if "pos.inputs.bytes" not in c or not c.get("pos.links"):
        return None
    return c["pos.inputs.bytes"] / c["pos.links"]
