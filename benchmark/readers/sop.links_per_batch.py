"""sop.links_per_batch: links a batch of ``precompute_sop``, the program's
counter ``sop.links`` over ``sop.batches``, both taken as differences over
the traced run's profiled units alone (the kind puts them in
``ctx.counts``). None where the program keeps no such counters."""


def read(ctx):
    batches = ctx.counts.get("sop.batches")
    if not batches:
        return None
    return ctx.counts.get("sop.links", 0) / batches
