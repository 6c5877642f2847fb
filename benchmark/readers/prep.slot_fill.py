"""prep.slot_fill: the share of the kernel's subgraph slots that hold a
node, in percent: the program's counter ``pos.slots_used`` (min(size,
bucket) summed over the batched links, from the plan's host-side sizes)
over ``pos.slots`` (the buckets summed), as
``s3grl_tpu_torch.profiling.counters`` gives them at the end of the traced
run: over every ``precompute_pos`` call of the run (set-up's warm unit and
both traced slices, all of one traffic). None where the program keeps no
such counters."""


def read(ctx):
    try:
        from s3grl_tpu_torch.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("pos.slots"):
        return None
    return 100.0 * c.get("pos.slots_used", 0) / c["pos.slots"]
