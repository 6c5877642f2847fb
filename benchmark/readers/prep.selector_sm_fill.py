"""prep.selector_sm_fill: the share of the card's SMs that the PoS selector
phase's blocks occupy, in percent: the program's counter
``pos.selector.blocks`` (min(blocks launched, SMs) summed over selector
calls, from the batch's shape on the host) over ``pos.selector.sm_slots``
(the card's SMs, summed over the same calls), as
``s3grl_tpu_torch.profiling.counters`` gives them at the end of the traced
run: over every selector call of the run. None where the program keeps no
such counters."""


def read(ctx):
    try:
        from s3grl_tpu_torch.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("pos.selector.sm_slots"):
        return None
    return 100.0 * c.get("pos.selector.blocks", 0) / c["pos.selector.sm_slots"]
