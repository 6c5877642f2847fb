"""prep.ccn_row_fill: the share of PoS Plus's CCN row slots that hold a
common neighbour's row, in percent: the program's counter ``pos.ccn.rows``
(min(|CCN|, CCN width) summed over the batched links, from the plan's
host-side counts) over ``pos.ccn.slots`` (the CCN width a link, summed), as
``s3grl_tpu_torch.profiling.counters`` gives them at the end of the traced
run: over every ``precompute_pos`` call of the run (set-up's warm pass and
both traced slices, all of one traffic). None where the program keeps no
such counters."""


def read(ctx):
    try:
        from s3grl_tpu_torch.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("pos.ccn.slots"):
        return None
    return 100.0 * c.get("pos.ccn.rows", 0) / c["pos.ccn.slots"]
