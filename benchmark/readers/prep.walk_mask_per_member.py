"""prep.walk_mask_per_member: the entries of the walk route's [B, N]
membership masks a walk member, in entries/member: the program's counter
``pos.walks.mask_entries`` (B·N a walk batch, from its shape) over
``pos.walks.members`` (the distinct nodes each link's walks visit, summed
on the card and read once a call), as ``s3grl_tpu_torch.profiling.counters``
gives them at the end of the traced run: over every ``precompute_pos`` call
of the run (set-up's warm pass and both traced slices, all of one traffic).
N / (mean members): it falls to about 2·M·(m+1) / (mean members) where the
node sets come from each link's visits alone, so it says whether the walk
route's work grows with the graph or with the walks. None where the
program keeps no such counters."""


def read(ctx):
    try:
        from s3grl_tpu_torch.profiling import counters
    except ImportError:
        return None
    c = counters()
    if "pos.walks.mask_entries" not in c or not c.get("pos.walks.members"):
        return None
    return c["pos.walks.mask_entries"] / c["pos.walks.members"]
